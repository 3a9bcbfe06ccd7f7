"""SeamlessM4T-medium speech translation backbone [arXiv:2308.11596; hf].

Encoder-decoder transformer; the audio frontend (conformer speech encoder
front) is a STUB per the assignment — input_specs provide precomputed frame
embeddings of shape (B, T_frames, d_model).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,             # decoder layers
    num_encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    mlp_type="gelu",           # vanilla transformer FFN (non-gated)
    frontend="audio_frames",
    source="arXiv:2308.11596; hf",
))
