"""Yi-9B [arXiv:2403.04652; hf]. Llama-architecture dense GQA."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    source="arXiv:2403.04652; hf",
))
