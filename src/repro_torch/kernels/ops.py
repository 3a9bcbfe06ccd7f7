"""Dispatch entry points in front of the kernels (port of ``repro.kernels.ops``).

The device of the tensors picks the path: a CPU tensor takes the kernel's
plain PyTorch version, a CUDA tensor launches the hand-written kernel or
raises. ``flash_attention`` is a ``torch.autograd.Function`` whose backward
recomputes through ``models.attention.sdpa_chunked``, as the reference's
custom_vjp does (there is no backward kernel in either package).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, active, causal, window):
        ctx.save_for_backward(q, k, v, active)
        ctx.causal, ctx.window = causal, window
        return fa.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                      active=active)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.models.attention import sdpa_chunked
        q, k, v, active = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = sdpa_chunked(*qkv, causal=ctx.causal, window=ctx.window)
            if active is not None:
                out = fa.mask_lanes(active, out)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, window: int = 0, *,
                    active=None):
    """Flash attention with the lane-mask contract: ``active`` (bool/int
    (B,), optional) treats the batch dim as the lane axis; inactive lanes'
    outputs are exact zeros and active lanes are bit-identical to the
    unmasked call. With ``active=None`` no predicate reaches the kernel."""
    if active is not None:
        active = torch.as_tensor(active, device=q.device).to(torch.int32)
    return _FlashAttention.apply(q, k, v, active, causal, window)
