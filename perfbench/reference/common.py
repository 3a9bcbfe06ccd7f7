"""Building blocks of the plain references: products in the reference's
precision or the control's, RMSNorm, rotary embedding, causal attention,
SwiGLU and the cross-entropy."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with a per-tensor scale (its largest
    magnitude maps to e4m3's largest), returned in f32."""
    t = t.float()
    amax = t.detach().abs().amax()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    """a @ b with both operands rounded to fp8, and the two products of
    the backward with theirs rounded too."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return fp8(a) @ fp8(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g8 = fp8(g)
        ga = g8 @ fp8(b).transpose(-1, -2)
        gb = fp8(a).transpose(-1, -2) @ g8
        # operands broadcast over leading axes: sum the gradient back
        while gb.dim() > b.dim():
            gb = gb.sum(0)
        return ga, gb


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f32":
        return a.float() @ b.float()
    if precision == "fp8":
        return _Fp8Matmul.apply(a.float(), b.float())
    raise ValueError(precision)


def rms_norm(x, w, eps: float = 1e-5):
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def rope(x, positions, theta: float):
    """Rotate the two halves of each head. x (B, S, H, D), positions (S,)."""
    D = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, device=x.device,
                                       dtype=torch.float32) / D)
    ang = positions.float()[:, None] * inv                     # (S, D/2)
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q, k, v, precision: str):
    """softmax(q kᵀ / sqrt(D)) v over keys at or before each query.
    q, k, v (B, S, H, D) -> (B, S, H, D)."""
    D = q.shape[-1]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))       # (B, H, S, D)
    s = matmul(qh, kh.transpose(-1, -2), precision) / math.sqrt(D)
    S = q.shape[1]
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return matmul(p, vh, precision).transpose(1, 2)


def attention(p, x, positions, heads: int, head_dim: int, theta: float,
              precision: str):
    """Multi-head self-attention with rotary positions; ``p`` holds w_q,
    w_k, w_v (d, H·D) and w_o (H·D, d)."""
    B, S, _ = x.shape
    q, k, v = (matmul(x, p[n], precision).reshape(B, S, heads, head_dim)
               for n in ("w_q", "w_k", "w_v"))
    q, k = rope(q, positions, theta), rope(k, positions, theta)
    o = causal_attention(q, k, v, precision).reshape(B, S, heads * head_dim)
    return matmul(o, p["w_o"], precision)


def swiglu(p, x, precision: str):
    g = matmul(x, p["w_gate"], precision)
    u = matmul(x, p["w_up"], precision)
    return matmul(F.silu(g) * u, p["w_down"], precision)


def cross_entropy(logits, labels):
    """Mean token negative log-likelihood, f32."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                           labels.reshape(-1).long())


def index(tree, i: int):
    """Layer ``i`` of a tree stacked on a leading axis."""
    if isinstance(tree, dict):
        return {k: index(v, i) for k, v in tree.items()}
    return tree[i]
