"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base; hf].

Dense-MoE hybrid: every layer has a dense residual FFN *in parallel* with a
128-expert top-2 MoE FFN.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,                 # dense residual FFN width
    vocab_size=32000,
    moe=MoEConfig(
        num_experts=128,
        top_k=2,
        num_shared_experts=0,
        dense_residual=True,
        expert_d_ff=4864,
    ),
    source="hf:Snowflake/snowflake-arctic-base; hf",
))
