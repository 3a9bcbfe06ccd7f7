"""LLMapReduce [paper ref 15]: map a function over many inputs under a
triples placement, then reduce (port of ``repro.core.mapreduce``).

Two execution paths:
  * packed  — homogeneous map_fn written in PyTorch: items become lanes of
    a persistent lane pool (core/lanepool.py) sized to the concurrency the
    triples allow. The pool's step is built ONCE (``torch.func.vmap`` over
    the lanes) and refilled continuously, so a ragged last group never
    pads: lanes past the end of the item list are simply masked inactive
    instead of re-running a duplicated item.
  * slotted — arbitrary Python tasks through the TriplesScheduler (keeps
    the paper's semantics for heterogeneous work).

The packed pool lives on ``device``: by default the device of the first
item's tensors, ``cuda`` for items that hold none.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import triples as T
from repro_torch.core.packing import tree_leaves
from repro_torch.core.lanepool import (LanePool, LaneTask, RefillExecutor,
                                       RefillStats)
from repro_torch.core.scheduler import ClusterState, Task, TriplesScheduler


def _run_packed(map_fn: Callable, items: Sequence[Any], wave: int,
                device: torch.device) -> Tuple[List[Any], RefillStats]:
    """Map over ``items`` as single-step lane tasks of one masked pool.

    The pool state is a dummy scalar per lane (map_fn is stateless); each
    item occupies a lane for exactly one masked step and the lane refills
    with the next item. Capacity never exceeds the item count, and the
    final partial step masks the empty lanes — no padded duplicates, no
    wasted lane-steps (stats.lane_steps == len(items))."""
    zero = torch.zeros((), device=device)

    def step(params, opt_state, batch, hparams):
        return params, opt_state, {"out": map_fn(batch)}

    pool = LanePool(min(wave, len(items)), step,
                    template_params=zero, template_opt=zero,
                    template_hparams=zero)
    results: Dict[int, Any] = {}

    def on_metrics(t: LaneTask, step_idx: int, lane_metrics) -> bool:
        results[t.id] = lane_metrics["out"]
        return False

    tasks = [LaneTask(id=i, hparams=zero,
                      init_fn=lambda: (zero, zero),
                      batch_fn=lambda s, it=it: it, steps=1)
             for i, it in enumerate(items)]
    stats = RefillExecutor(pool, on_metrics=on_metrics).run(tasks)
    return [results[i] for i in range(len(items))], stats


def _items_device(items: Sequence[Any]):
    """The device of the first tensor in ``items[0]``, else None."""
    for leaf in tree_leaves(items[0]):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


def llmapreduce(map_fn: Callable, items: Sequence[Any], *,
                reduce_fn: Optional[Callable] = None,
                trip: Optional[T.Triples] = None,
                node_spec: Optional[T.NodeSpec] = None,
                mode: str = "packed",
                return_stats: bool = False,
                device=None) -> Any:
    """Apply map_fn to every item; optionally fold results with reduce_fn.

    packed mode: map_fn must run under ``torch.func.vmap`` over stacked
    item trees; items run as lanes of a continuously-refilled pool on
    ``device`` (by default the first item's, ``cuda`` for items that hold
    no tensor, which raises without a card) whose capacity is
    ``trip.total_slots`` (the concurrency the triples allow).

    Empty ``items``: returns ``[]`` when there is nothing to fold; with a
    ``reduce_fn`` there is no identity element to seed the fold, so a
    ValueError is raised.

    ``return_stats`` (packed mode only) additionally returns the pool's
    RefillStats — ``lane_steps`` equals ``len(items)`` exactly.
    """
    if len(items) == 0:
        if reduce_fn is not None:
            raise ValueError(
                "llmapreduce: cannot reduce empty items (no identity "
                "element); pass reduce_fn=None to get [] back")
        return ([], RefillStats()) if (return_stats and mode == "packed") \
            else []
    trip = trip or T.Triples(1, max(1, len(items)), 1)
    node_spec = node_spec or T.NodeSpec()

    stats: Optional[RefillStats] = None
    if mode == "packed":
        # at call time: the models import core.packing, so a module-level
        # import of models.model from here would be circular
        from repro_torch.models.model import resolve_device
        results, stats = _run_packed(
            map_fn, items, trip.total_slots,
            resolve_device(device or _items_device(items)))
    elif mode == "slotted":
        cluster = ClusterState(trip.nnode, node_spec)
        sched = TriplesScheduler(cluster)
        tasks = [Task(id=i, fn=(lambda ctx, it=it: map_fn(it)))
                 for i, it in enumerate(items)]
        job = sched.run_triples_job("llmapreduce", tasks, trip)
        if job.failed:
            raise RuntimeError(f"tasks failed: {job.failed}")
        results = [job.results[i] for i in range(len(items))]
    else:
        raise ValueError(mode)

    if reduce_fn is None:
        out = results
    else:
        out = results[0]
        for r in results[1:]:
            out = reduce_fn(out, r)
    if return_stats and mode == "packed":
        return out, stats
    return out
