"""StarCoder2-15B [arXiv:2402.19173; hf]. Dense GQA + RoPE."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    mlp_type="gelu",           # StarCoder2 uses a standard (non-gated) MLP
    source="arXiv:2402.19173; hf",
))
