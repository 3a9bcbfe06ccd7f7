"""DeepSeekMoE 16B [arXiv:2401.06066; hf].

Fine-grained MoE: 2 shared (always-on) experts + 64 routed experts, top-6,
expert hidden size 1408.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        num_shared_experts=2,
        dense_residual=False,
        expert_d_ff=1408,
    ),
    source="arXiv:2401.06066; hf",
))
