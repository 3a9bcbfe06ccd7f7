"""Manual compute/communication overlap: the ring-pipelined collective
matmul (the classic "all-gather matmul" overlap pattern), port of
``repro.distributed.collectives``.

FSDP's per-layer weight all-gather is a bulk collective that may or may not
overlap with compute. ``allgather_matmul`` overlaps by construction: the
weight's sharded dim rotates around the ring by point-to-point sends while
each shard's partial product runs, so the transfer of shard i+1 hides
behind the product of shard i.

    y = x @ W  with W sharded on its FIRST dim over ``group``:
    each step computes x_chunk_i @ W_shard_i and rotates W.

The products are plain ``torch.matmul``, as the reference's are plain XLA
dots outside any Pallas kernel.

``sum_over_group`` is the differentiable all-reduce that completes an
expert-parallel combine (``models.moe.moe_routed``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def allgather_matmul(x: torch.Tensor, w_shard: torch.Tensor, group=None
                     ) -> torch.Tensor:
    """x (T, K) replicated over ``group``; w_shard (K/n, N) = this rank's
    shard of W's rows. Returns x @ W (T, N)."""
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    k_shard = w_shard.shape[0]
    # rank j sends its shard to j - 1, so after i steps it holds j + i's
    glob = (lambda r: r) if group is None else (
        lambda r: dist.get_global_rank(group, r))
    to, frm = glob((idx - 1) % n), glob((idx + 1) % n)
    acc = torch.zeros((x.shape[0], w_shard.shape[1]), dtype=x.dtype,
                      device=x.device)
    w_cur = w_shard.contiguous()
    for i in range(n):
        reqs, w_nxt = [], None
        if i + 1 < n:          # rotate while this step's product runs
            w_nxt = torch.empty_like(w_cur)
            reqs = dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, w_cur, to, group),
                 dist.P2POp(dist.irecv, w_nxt, frm, group)])
        src = (idx + i) % n
        acc = acc + x[:, src * k_shard:(src + 1) * k_shard] @ w_cur
        for r in reqs:
            r.wait()
        w_cur = w_nxt
    return acc


def reducescatter_matmul(x: torch.Tensor, w_shard: torch.Tensor, group=None
                         ) -> torch.Tensor:
    """x (T, K) replicated; w_shard (K, N/n) = this rank's column shard.
    Returns this rank's (T, N/n): a TP matmul whose output stays sharded
    (no collective at all; kept for symmetry and benchmarks)."""
    return x @ w_shard


class _SumOverGroup(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward: the cotangent of a
    result replicated over the group is the same on every rank, and it is
    each rank's share's cotangent as it stands."""

    @staticmethod
    def forward(x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of ``group`` (each rank
    gets the total); its gradient is the result's, passed through. Runs
    under ``torch.func.grad``."""
    return _SumOverGroup.apply(x, group)
