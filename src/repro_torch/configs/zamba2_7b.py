"""Zamba2-7B hybrid [arXiv:2411.15242; unverified].

Mamba2 backbone with a SHARED attention+FFN block applied periodically
(weights reused at each application point). For the long_500k cell the
shared attention uses a 4096-token sliding window (sub-quadratic).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4),
    hybrid_attn_period=6,      # shared attn block every 6 mamba layers
    source="arXiv:2411.15242; unverified",
))
