"""Qwen2-VL-7B [arXiv:2409.12191; hf].

VLM backbone: dense GQA decoder with M-RoPE (temporal/height/width rotary
sections). The vision frontend (dynamic-resolution ViT) is a STUB —
input_specs provide precomputed patch embeddings plus their (t,h,w) grid
positions for M-RoPE.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    mrope=True,
    frontend="vision_patches",
    source="arXiv:2409.12191; hf",
))
