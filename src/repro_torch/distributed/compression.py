"""Gradient compression for data-parallel reduction (port of
``repro.distributed.compression``).

Two schemes, both with error feedback (EF: the residual is carried to the
next step, so compression error does not bias convergence [1-bit Adam
lineage]):

  * bf16 all-reduce: half the collective bytes of fp32; the production
    default when gradients are kept as an fp32 master.
  * int8 all-reduce: global-scale symmetric quantization. A MAX all-reduce
    of |g| fixes one scale across ranks, then the ranks SUM int32 counts
    (4x fewer bytes than fp32 when the transport packs int8; the roofline
    models the bytes with ``bytes_for_scheme``, since the sum travels as
    int32, as the reference's psum does).

``compressed_psum`` runs on ``torch.distributed`` process groups, step for
step as the reference's runs inside ``shard_map``. GSPMD's automatic
all-reduce path (DTensor's, in the port) stays fp32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist


def quantize_int8(g: torch.Tensor, scale: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    if scale is None:
        scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _leaves(tree: Any) -> list:
    """Leaves of dicts, lists and tuples in jax pytree order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _unflatten(like: Any, it) -> Any:
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], it) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, it) for v in like)
    return next(it)


@dataclasses.dataclass
class ErrorFeedback:
    """e_{t+1} = g_t + e_t - D(C(g_t + e_t)); call inside the train step.
    Trees are dicts, lists and tuples of tensors."""

    @staticmethod
    def init(grads: Any) -> Any:
        return _unflatten(grads, iter(
            [torch.zeros(g.shape, dtype=torch.float32, device=g.device)
             for g in _leaves(grads)]))

    @staticmethod
    def apply(grads: Any, residual: Any, compress_fn: Callable
              ) -> Tuple[Any, Any]:
        """Returns (compressed-then-decompressed grads, new residual)."""
        outs = []
        for g, e in zip(_leaves(grads), _leaves(residual)):
            corrected = g.float() + e
            out = compress_fn(corrected)
            outs.append((out, corrected - out))
        return (_unflatten(grads, iter([o[0] for o in outs])),
                _unflatten(grads, iter([o[1] for o in outs])))


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    dist.all_reduce(t, op=op, group=group)
    return t


def compressed_psum(g: torch.Tensor, group=None, scheme: str = "bf16"
                    ) -> torch.Tensor:
    """All-reduce (sum) of ``g`` over ``group`` with a reduced-precision
    payload; returns f32. ``g`` is not modified."""
    if scheme == "fp32":
        return _all_reduce(g.float().clone(), dist.ReduceOp.SUM, group)
    if scheme == "bf16":
        return _all_reduce(g.to(torch.bfloat16).clone(), dist.ReduceOp.SUM,
                           group).float()
    if scheme == "int8":
        gmax = _all_reduce(g.abs().max().clone(), dist.ReduceOp.MAX, group)
        scale = gmax / 127.0 + 1e-12
        q, _ = quantize_int8(g, scale)
        total = _all_reduce(q.to(torch.int32), dist.ReduceOp.SUM, group)
        return total.float() * scale
    raise ValueError(scheme)


def bytes_for_scheme(n_elements: int, scheme: str) -> int:
    """Collective payload bytes per rank (roofline accounting)."""
    width = {"fp32": 4, "bf16": 2, "int8": 1}[scheme]
    return n_elements * width
