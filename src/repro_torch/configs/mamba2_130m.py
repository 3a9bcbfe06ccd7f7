"""Mamba2-130M [arXiv:2405.21060; unverified]. Pure SSD (state-space duality).

Attention-free: sequence mixing is the SSD chunked scan; decode carries a
recurrent state instead of a KV cache. Sub-quadratic => runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4),
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
))
