"""Job packing: run K independent tasks as lanes of ONE program (port of
``repro.core.packing``).

A "lane" is one slot of a stacked axis: co-resident tasks (or requests, or
the layers of a stack) are index ``i`` of every leaf of a nested dict of
tensors. ``axis`` names that axis, one int for every leaf or a tree of ints
shaped as the tree; the reference always stacks on axis 0, and the serving
pool stacks lanes on the batch axis of the per-layer caches
(``Model.cache_lane_axes``). Reads return views; ``tree_set_lane`` writes
in place (the reference's ``.at[i].set`` returns a copy).

A per-task step runs over the lane axis through ``torch.func.vmap`` (its
gradient through ``torch.func.grad``/``grad_and_value`` on dict params), so
packed training of K lanes computes what K sequential trainings compute
(tested). Per-lane hyperparameters (a learning rate per lane, for parametric
sweeps) ride the lane axis as tensors.

Masked execution comes in three modes (``masked_pool_step``), with the
reference's contract: active lanes step exactly as an unmasked run would,
inactive lanes' state passes through bit for bit.

  * "where"   — step every lane, keep inactive lanes' old state with
    ``torch.where``. Dead lanes are not free: a pool at 50 % occupancy
    pays for 100 % of the work.
  * "compact" — gather the active lanes into a dense power-of-two-sized
    sub-batch, step only that, scatter back (``packed_compact_step``).
  * "kernel"  — the step itself is pool-level and mask-aware, and threads
    the per-lane predicate into the lane-masked kernels
    (``kernels.ops.packed_matmul``/``packed_norm`` with ``active=``), which
    skip inactive lanes inside the kernel.

The port runs eagerly: nothing is traced or compiled. Each masked-step
factory returns a callable whose ``n_builds`` counts the step programs it
built, at their first use: one for "where" and "kernel", one per occupancy
bucket for "compact". That is what the reference's jit-trace count counts.
No step mutates its inputs: a step returns new tensors and the caller
rebinds them (the old tensors are freed once nothing refers to them), so
the reference's ``donate`` flag has no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """Leaves in sorted-key order (the reference's pytree order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like: Any, leaves: Sequence[Any]) -> Any:
    """The inverse of ``tree_leaves``: ``leaves`` put back into the dict
    structure of ``like``. (No recursive closure: its reference cycle would
    keep the leaves alive until the garbage collector runs.)"""
    return _fill(like, iter(leaves))


def _fill(like: Any, it) -> Any:
    if isinstance(like, dict):
        out = {k: _fill(like[k], it) for k in sorted(like)}
        return {k: out[k] for k in like}
    return next(it)


def _axes(axis: Any, tree: Any) -> Any:
    """``axis`` as a tree of ints shaped as ``tree``."""
    return axis if isinstance(axis, dict) else tree_map(lambda _: axis, tree)


def stack_trees(trees: Sequence[Any], axis: Any = 0) -> Any:
    """Stack a list of identical-structure trees on a new axis."""
    return tree_map(lambda a, *xs: torch.stack(
        [torch.as_tensor(x) for x in xs], dim=a),
        _axes(axis, trees[0]), *trees)


def unstack_tree(tree: Any, n: int) -> list:
    return [lane_slice(tree, i) for i in range(n)]


def lane_slice(tree: Any, i: int, axis: Any = 0) -> Any:
    """Lane ``i`` of every leaf, as views."""
    return tree_map(lambda x, a: x.select(a, i), tree, _axes(axis, tree))


def tree_get_lane(tree: Any, i: int, axis: Any = 0) -> Any:
    """Read lane ``i`` of a stacked tree (views)."""
    return lane_slice(tree, i, axis)


def tree_set_lane(tree: Any, i: int, lane: Any, axis: Any = 0) -> Any:
    """Write ``lane`` into slot ``i`` of a stacked tree, in place (cast to
    the pool's dtype and device)."""
    tree_map(lambda pool, x, a: pool.select(a, i).copy_(torch.as_tensor(x)),
             tree, lane, _axes(axis, tree))
    return tree


def tree_copy(tree: Any) -> Any:
    """A copy that shares no storage with ``tree``."""
    return tree_map(lambda x: x.clone(), tree)


def pack_init(init_fn: Callable, generators: Sequence[torch.Generator]) -> Any:
    """One ``init_fn(generator)`` per lane, stacked (the reference vmaps
    init over per-lane PRNG keys)."""
    return stack_trees([init_fn(g) for g in generators])


def masked_step(step_fn: Callable) -> Callable:
    """Per-lane step gated by a scalar ``active`` flag.

    Returns ``fn(params, opt_state, batch, hparams, active) -> (params,
    opt_state, metrics)``. An inactive lane's state passes through
    bit-identically (``torch.where`` keeps the old values); an active
    lane's result is exactly ``step_fn``'s: lanes are independent under
    vmap, so values on other lanes (garbage, zeros, NaN) cannot leak in.
    """
    def step(params, opt_state, batch, hparams, active):
        new_p, new_o, metrics = step_fn(params, opt_state, batch, hparams)
        # the stepped trees as lists of leaves: _keep_active drops each
        # stepped leaf once its selected copy exists
        new_p, new_o = tree_leaves(new_p), tree_leaves(new_o)
        return (_keep_active(active, new_p, params),
                _keep_active(active, new_o, opt_state),
                metrics)
    return step


def _keep_active(active, new: list, old: Any) -> Any:
    """``torch.where(active, new, old)`` leaf by leaf, ``new`` the leaves
    of a tree shaped as ``old`` in ``tree_leaves`` order. Each entry of
    ``new`` is set to None once its selected copy exists, so the stepped
    leaf is freed then: a pool of a model's size would otherwise hold the
    old state, the stepped state and the selected state at once."""
    out = []
    for i, o in enumerate(tree_leaves(old)):
        out.append(torch.where(active, new[i], o))
        new[i] = None
    return tree_unflatten(old, out)


def _lane_mask(active, like: torch.Tensor) -> torch.Tensor:
    """The pool's mask (host or tensor) as a bool tensor on ``like``'s
    device."""
    if isinstance(active, torch.Tensor):
        return active.to(device=like.device, dtype=torch.bool)
    return torch.as_tensor(np.asarray(active, bool), device=like.device)


def _built_once(make: Callable[[], Callable]) -> Callable:
    """Call ``make()`` at the first call only; count it in ``n_builds``."""
    built = []

    def call(*args):
        if not built:
            built.append(make())
            call.n_builds += 1
        return built[0](*args)

    call.n_builds = 0
    return call


def packed_masked_step(step_fn: Callable) -> Callable:
    """vmap the masked step over the lane axis: the pool's "where" program.

        (params, opt_state, batch, hparams, active_mask) ->
            (params, opt_state, metrics)

    where every argument carries the leading lane axis and ``active_mask``
    is a bool vector (host or tensor) of pool capacity. Inactive lanes'
    metrics are garbage: callers filter by the mask."""
    def make():
        v = torch.func.vmap(masked_step(step_fn))

        def run(params, opt_state, batch, hparams, active):
            mask = _lane_mask(active, tree_leaves(params)[0])
            return v(params, opt_state, batch, hparams, mask)
        return run
    return _built_once(make)


def occupancy_bucket(n_active: int, capacity: int) -> int:
    """Smallest power of two >= n_active, capped at capacity: the dense
    sub-batch size the compacted step runs. Bucketing keeps the number of
    step programs at most log2(capacity)+1 while occupancy wanders."""
    if n_active < 1:
        raise ValueError("occupancy_bucket needs >= 1 active lane")
    b = 1
    while b < n_active:
        b *= 2
    return min(b, capacity)


def packed_compact_step(step_fn: Callable) -> Callable:
    """Lane-compaction masked step: gather active lanes, step a DENSE
    sub-batch, scatter back. Same signature as ``packed_masked_step``'s
    result, but dead lanes cost nothing.

    The gather indices come from the host mask, so the sub-batch size is
    known per call; it is rounded up to an occupancy bucket and padded by
    REPEATING active lanes. Only the first copy of each lane is scattered
    back, so the result does not depend on which duplicate is written.
    Inactive lanes are never gathered: their state passes through bit for
    bit and their metrics are zeros.

    A bucket of one lane runs as two copies of that lane when the pool has
    two or more: ``torch.func.vmap`` over a single lane takes other
    kernels for some ops (LeNet-4's gradient then differs in its last
    bits), which would break "where" == "compact" bit for bit.
    """
    v = torch.func.vmap(step_fn)
    built: set = set()

    def step(params, opt_state, batch, hparams, active):
        mask = np.asarray(active, bool)
        lanes = np.flatnonzero(mask)
        if lanes.size == 0:
            raise ValueError(
                "compacted masked step requires >= 1 active lane "
                "(an all-inactive pool step is a no-op; skip it)")
        cap = int(mask.shape[0])
        bucket = occupancy_bucket(int(lanes.size), cap)
        if bucket not in built:
            built.add(bucket)
            step.n_builds += 1
        width = max(bucket, min(2, cap))
        like = tree_leaves(params)[0]
        idx = torch.as_tensor(np.resize(lanes, width), device=like.device)
        first = idx[:lanes.size]
        gather = lambda t: tree_map(lambda a: a.index_select(0, idx), t)
        new_p, new_o, m = v(gather(params), gather(opt_state), gather(batch),
                            gather(hparams))
        scat = lambda full, sub: tree_map(
            lambda f, s: f.index_copy(0, first, s[:lanes.size]), full, sub)
        metrics = tree_map(
            lambda a: torch.zeros((cap,) + a.shape[1:], dtype=a.dtype,
                                  device=a.device).index_copy(
                                      0, first, a[:lanes.size]), m)
        return scat(params, new_p), scat(opt_state, new_o), metrics

    step.n_builds = 0
    return step


def packed_kernel_step(pool_step_fn: Callable) -> Callable:
    """Masked step for a POOL-LEVEL, mask-aware step function.

    ``pool_step_fn(params, opt_state, batch, hparams, active) -> (params,
    opt_state, metrics)`` works on the stacked lane axis directly (no vmap)
    and threads ``active`` (a bool tensor on the pool's device) into the
    lane-masked kernels (``kernels.ops.packed_matmul``/``packed_norm`` with
    ``active=``), which skip inactive lanes inside the kernel. This wrapper
    adds ``masked_step``'s guarantee: whatever the step computes for dead
    lanes (zeros, by the kernels' contract) is discarded and the old state
    kept. One step program, like "where".
    """
    def make():
        def run(params, opt_state, batch, hparams, active):
            act = _lane_mask(active, tree_leaves(params)[0])
            new_p, new_o, metrics = pool_step_fn(params, opt_state, batch,
                                                 hparams, act)

            def keep(new, old):
                return torch.where(act.reshape((-1,) + (1,) * (new.dim() - 1)),
                                   new, old)
            return (tree_map(keep, new_p, params),
                    tree_map(keep, new_o, opt_state),
                    metrics)
        return run
    return _built_once(make)


MASKED_MODES = ("where", "compact", "kernel")


def masked_pool_step(step_fn: Callable, *, mode: str = "where") -> Callable:
    """Build the pool's masked step in the requested execution mode.

    All modes share one signature, ``(params, opt_state, batch, hparams,
    active_mask) -> (params, opt_state, metrics)`` with a leading lane axis
    everywhere, and one contract: active lanes step exactly as an unmasked
    run would, inactive lane state is bit-identical passthrough.
    ``step_fn`` is per-lane for "where"/"compact"; for "kernel" it is the
    pool-level mask-aware step described in ``packed_kernel_step``.
    """
    if mode == "where":
        return packed_masked_step(step_fn)
    if mode == "compact":
        return packed_compact_step(step_fn)
    if mode == "kernel":
        return packed_kernel_step(step_fn)
    raise ValueError(f"unknown masked execution mode {mode!r}; "
                     f"expected one of {MASKED_MODES}")


def packed_step(step_fn: Callable) -> Callable:
    """vmap a per-task step over the leading lane axis of every argument.

    step_fn(params, opt_state, batch, hparams) -> (params, opt_state, metrics)
    (every argument carries the lane axis). This is the LOCKSTEP API:
    every lane steps every call. The lane pool's masked step generalizes
    it to lanes that attach and detach mid-flight."""
    return torch.func.vmap(step_fn)


@dataclasses.dataclass
class PackedJobs:
    """K co-resident tasks managed as one stacked program state."""
    n_lanes: int
    params: Any                 # stacked on axis 0
    opt_state: Any              # stacked on axis 0
    hparams: Any                # stacked scalars (e.g. lr per lane)
    step_fn: Callable           # per-lane step (unvmapped)
    step: int = 0
    _packed: Optional[Callable] = None

    @classmethod
    def create(cls, init_fn: Callable, opt_init_fn: Callable,
               step_fn: Callable, generator: torch.Generator, n_lanes: int,
               hparams: Any) -> "PackedJobs":
        """Lane i's params are the i-th draw of ``init_fn`` from
        ``generator`` (the reference splits one PRNG key per lane)."""
        params = pack_init(init_fn, [generator] * n_lanes)
        opt_state = stack_trees([opt_init_fn(lane_slice(params, i))
                                 for i in range(n_lanes)])
        return cls(n_lanes=n_lanes, params=params, opt_state=opt_state,
                   hparams=hparams, step_fn=step_fn)

    def run_step(self, batch: Any) -> Any:
        """batch: tree with a leading lane axis. Returns stacked metrics."""
        if self._packed is None:
            self._packed = packed_step(self.step_fn)
        self.params, self.opt_state, metrics = self._packed(
            self.params, self.opt_state, batch, self.hparams)
        self.step += 1
        return metrics

    def lane_state(self, i: int) -> tuple:
        return lane_slice(self.params, i), lane_slice(self.opt_state, i)

    def replace_lanes(self, params_list, opt_list, hparams) -> "PackedJobs":
        """Re-pack with a (possibly different-size) set of lane states, as
        OOM backoff and elastic re-planning do."""
        return dataclasses.replace(
            self, n_lanes=len(params_list), params=stack_trees(params_list),
            opt_state=stack_trees(opt_list), hparams=hparams, _packed=None)
