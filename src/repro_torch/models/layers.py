"""Shared building blocks (port of ``repro.models.layers``).

Conventions, as in the reference:
  * params are nested dicts of tensors, stored in ``param_dtype``;
  * forward code casts each weight to the compute dtype at its point of use
    (norm statistics and RoPE stay f32);
  * weight matrices are stored FOLDED, (d_in, d_out): attention projections
    are (d_model, n_heads*head_dim), so ``x @ w`` needs no transpose.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim//2,)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate split halves. x: (B, S, H, D); positions: (B, S) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # (D/2,)
    ang = positions[..., None].float() * freqs                   # (B, S, D/2)
    cos, sin = ang.cos()[:, :, None, :], ang.sin()[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, mlp_type: str,
             dtype: torch.dtype) -> dict:
    if mlp_type == "swiglu":
        return {
            "w_gate": dense_init(gen, d_model, d_ff, dtype),
            "w_up": dense_init(gen, d_model, d_ff, dtype),
            "w_down": dense_init(gen, d_ff, d_model, dtype),
        }
    return {
        "w_up": dense_init(gen, d_model, d_ff, dtype),
        "w_down": dense_init(gen, d_ff, d_model, dtype),
    }


def mlp(params: dict, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    cdt = x.dtype
    if mlp_type == "swiglu":
        g = x @ params["w_gate"].to(cdt)
        u = x @ params["w_up"].to(cdt)
        h = F.silu(g) * u
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ params["w_up"].to(cdt), approximate="tanh")
    return h @ params["w_down"].to(cdt)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_id: int = -1) -> torch.Tensor:
    """Mean token NLL in f32; labels == ignore_id are masked.

    The reference takes the gold logit with a one-hot reduction, which
    keeps a tensor-parallel vocab dim sharded under GSPMD. The port gathers
    it (``torch.take_along_dim``): the same value exactly, without a
    (B, S, V) f32 one-hot as large as the logits themselves."""
    logits = logits.float()
    mask = (labels != ignore_id).float()
    safe = labels.clamp_min(0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, safe[..., None], dim=-1)[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / mask.sum().clamp_min(1.0)
