"""Dispatch entry points in front of the kernels (port of ``repro.kernels.ops``).

The device of the tensors picks the path: a CPU tensor takes the kernel's
plain PyTorch version, a CUDA tensor launches the hand-written kernel or
raises. ``flash_attention`` is a ``torch.autograd.Function`` whose backward
recomputes through ``models.attention.sdpa_chunked``, as the reference's
custom_vjp does (there is no backward kernel in either package; the port's
has a first derivative only), one slice of query rows at a time, so that
its peak holds one slice's scores and not the layer's; it runs
under ``torch.func.grad`` and ``torch.func.vmap``, and a vmapped call makes
one kernel launch with the vmapped axis folded into the batch axis. ``ssd``
has no backward in either package.

Lane masking: every packed entry point here accepts a per-lane ``active``
predicate, with ``active=None`` as the fast path that hands no predicate to
the kernel. On a CUDA tensor the predicate goes into the kernel (inactive
lanes skip their work and write zeros); on a CPU tensor the plain version
runs and ``ref.mask_lanes`` where-zeroes inactive lanes afterwards, as the
reference's XLA path does. ``packed_matmul`` and ``packed_norm`` are the
building blocks of the pool's "kernel" execution mode
(``core.packing.masked_pool_step``).

Each entry point is a span ``op.<name>`` (``core.spans``) with its
arguments' shapes and dtype.
"""
from __future__ import annotations

import torch

from repro_torch.core import spans
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_rmsnorm as rn
from repro_torch.kernels import packed_gemm as pg
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as sd


def _lane_predicate(active, like):
    """``active`` as an int32 (J,) tensor on ``like``'s device, or None."""
    if active is None:
        return None
    return torch.as_tensor(active, device=like.device).to(torch.int32)


class _FlashAttention(torch.autograd.Function):
    """The kernel forward with a recompute backward, in the form
    ``torch.func`` takes: ``forward`` without ``ctx``, ``setup_context``,
    and a ``vmap`` rule, so that a lane pool can step lanes under
    ``torch.func.vmap(torch.func.grad(...))`` as the reference's custom_vjp
    runs under ``jax.vmap(jax.grad(...))``."""

    @staticmethod
    def forward(q, k, v, active, causal, window):
        return fa.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                      active=active)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, active, causal, window = inputs
        ctx.save_for_backward(q, k, v, active)
        ctx.causal, ctx.window = causal, window

    @staticmethod
    def backward(ctx, g):
        from repro_torch.models.attention import sdpa_chunked
        # from detached inputs, as models.transformer._Recompute does: the
        # recompute is not recorded for a second derivative (which
        # torch.func.grad would keep alive to the end of the backward)
        q, k, v = (t.detach() for t in ctx.saved_tensors[:3])
        active = ctx.saved_tensors[3]
        g = g.detach()
        # k and v enter in f32 (``sdpa_chunked`` computes in f32 either
        # way), so their gradients are summed over the slices in f32
        kf, vf = k.float(), v.float()
        rows = backward_rows(q.shape[0], q.shape[1], q.shape[2],
                             min(k.shape[1], 1024))
        dq, dk, dv = [], 0, 0
        for lo in range(0, q.shape[1], rows):
            def attend(qs, kf, vf, lo=lo):
                out = sdpa_chunked(qs, kf, vf, causal=ctx.causal,
                                   window=ctx.window, q_offset=lo)
                return out if active is None else ref.mask_lanes(active, out)

            # torch.func.vjp composes with the transforms the forward ran
            # under
            _, vjp = torch.func.vjp(attend, q[:, lo:lo + rows], kf, vf)
            dqs, dks, dvs = vjp(g[:, lo:lo + rows])
            del vjp         # this slice's scores go before the next's come
            dq.append(dqs)
            dk, dv = dk + dks, dv + dvs
        dq = dq[0] if len(dq) == 1 else torch.cat(dq, dim=1)
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, active, causal, window):
        """Fold the vmapped axis into the batch axis B (the kernel takes
        (B, S, H, D)), launch once, unfold. An unbatched q, k, v or
        ``active`` is broadcast over the vmapped axis."""
        n = info.batch_size

        def fold(t, dim):
            t = (t.unsqueeze(0).expand(n, *t.shape) if dim is None
                 else t.movedim(dim, 0))
            return t.reshape(n * t.shape[1], *t.shape[2:])

        q_dim, k_dim, v_dim, a_dim = in_dims[:4]
        if active is not None:
            active = fold(active, a_dim)
        out = _FlashAttention.apply(fold(q, q_dim), fold(k, k_dim),
                                    fold(v, v_dim), active, causal, window)
        return out.reshape(n, -1, *out.shape[1:]), 0


# the f32 score block (B, Hq, rows, key chunk) one query slice of B3's
# backward holds at a time; about a dozen are alive at its peak
BACKWARD_BLOCK_BYTES = 1 << 30


def backward_rows(batch: int, seq: int, heads: int, chunk_k: int) -> int:
    """Query rows per slice of ``_FlashAttention.backward``: the largest
    power of two whose f32 score block (batch, heads, rows, chunk_k) fits
    in ``BACKWARD_BLOCK_BYTES`` (at least 1), or all ``seq`` rows when
    they fit. 512 rows at 16 sequences of 4096 with 28 heads (0.94 GB a
    block)."""
    per_row = batch * heads * chunk_k * 4
    rows = 1 << max(0, (BACKWARD_BLOCK_BYTES // max(per_row, 1)).bit_length()
                    - 1)
    return seq if rows >= seq else rows


def flash_attention(q, k, v, causal: bool = True, window: int = 0, *,
                    active=None):
    """Flash attention with the lane-mask contract: ``active`` (bool/int
    (B,), optional) treats the batch dim as the lane axis; inactive lanes'
    outputs are exact zeros and active lanes are bit-identical to the
    unmasked call. With ``active=None`` no predicate reaches the kernel."""
    with spans.span("op.flash_attention", q=q.shape, k=k.shape,
                    dtype=q.dtype):
        return _FlashAttention.apply(q, k, v, _lane_predicate(active, q),
                                     causal, window)


def ssd(x, dt, A, B, C, *, chunk: int = 128, active=None, init_state=None):
    """Mamba2 SSD chunked scan: (y (b,S,nh,hd), final state (b,nh,hd,N)
    f32), from ``init_state`` (b,nh,hd,N) or a zero state. ``active``
    (bool/int (b,), optional) treats the batch dim as the lane axis:
    inactive lanes' y AND final state are exact zeros, active lanes
    bit-identical to the call without it. With ``active=None`` no predicate
    reaches the kernel."""
    with spans.span("op.ssd", x=x.shape, B=B.shape, dtype=x.dtype):
        return sd.ssd_scan(x, dt, A, B, C, chunk=chunk,
                           active=_lane_predicate(active, x),
                           init_state=init_state)


def packed_matmul(x, w, *, active=None):
    """x (J,M,K) @ w (J,K,N) per job. ``active`` (bool/int (J,), optional)
    makes inactive lanes exact zeros: inside the kernel on CUDA, by
    where-zero after the plain version on the CPU."""
    with spans.span("op.packed_matmul", x=x.shape, w=w.shape,
                    dtype=x.dtype):
        return pg.packed_gemm(x, w, active=_lane_predicate(active, x))


def packed_norm(x, w, *, active=None, eps: float = 1e-5):
    """Lane-batched RMSNorm: x (J,rows,d), per-lane weights w (J,d). Same
    ``active`` contract as packed_matmul (inactive lanes -> zeros)."""
    with spans.span("op.packed_norm", x=x.shape, dtype=x.dtype):
        return rn.packed_rmsnorm(x, w, active=_lane_predicate(active, x),
                                 eps=eps)
