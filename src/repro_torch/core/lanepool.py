"""Persistent lane-pool executor: build the step once, refill lanes forever
(port of ``repro.core.lanepool``).

  * ``LanePool`` — a fixed-capacity stacked-tensor pool with an active-lane
    mask. Tasks attach/detach mid-flight through per-lane index writes
    (``packing.tree_set_lane``/``tree_get_lane``), which never change
    shapes, so the pool's step program is built once ("where", "kernel")
    or once per occupancy bucket ("compact"); ``n_traces`` counts those
    builds so tests can assert the reference's compile-once guarantee.

  * ``RefillExecutor`` — continuous refill over a task queue: the moment a
    lane's task exhausts its step budget (or early-stops), the lane is
    detached and the next queued task attaches in the SAME pool, between
    two masked steps.

  * ``PoolSnapshot`` — preemption: the executor can DRAIN mid-run into a
    snapshot of per-lane states + task cursors, persistable through
    ``checkpoint.checkpointer``, and ``rehydrate`` resumes the same work on
    a pool of a DIFFERENT capacity.

  * speculative straggler re-execution: when the queue has drained and
    free lanes remain, a lane flagged by ``stragglers_fn`` is duplicated
    onto a free slot; the first copy to finish wins.

Semantics guarantee (tested): a task that detaches and re-attaches on
another lane produces bit-identical losses to an uninterrupted run, since
inactive lanes pass their state through untouched and lanes are
independent under vmap.

State handling: the pool's step returns new tensors and the pool rebinds
them (nothing the caller holds is mutated by a step); ``attach`` writes a
lane in place; ``detach`` returns a copy of the lane, so a later attach on
that lane cannot change what the caller got back.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import checkpointer as ck
from repro_torch.core import packing, spans
from repro_torch.core.repack import RepackController


class PoolStepError(RuntimeError):
    """The masked step failed — a POOL-WIDE event (a packed program's OOM
    kills all lanes at once). Raised chained to the original exception so
    callers can tell a pool failure (back off, rebuild smaller) from a bug
    in their own callbacks (which propagates raw)."""


@dataclasses.dataclass
class LaneTask:
    """One unit of work that occupies a lane for ``steps`` masked steps.

    ``init_fn`` builds the lane state at attach time (or restores it from a
    checkpoint); ``batch_fn(step_done)`` yields the task's next batch (a
    dict of numpy arrays or tensors).
    """
    id: int
    hparams: Any                        # per-lane scalars (e.g. lr)
    init_fn: Callable[[], Tuple[Any, Any]]       # () -> (params, opt_state)
    batch_fn: Callable[[int], Any]               # step_done -> batch tree
    steps: int                                    # per-task step budget
    step_done: int = 0
    stopped_early: bool = False


class LanePool:
    """Fixed-capacity stacked lane state with an active mask.

    The step program is a function of the pool CAPACITY only, not of which
    lanes are live, so a pool outlives every task that passes through it.

    ``exec_mode`` picks how inactive lanes are skipped (see
    ``packing.masked_pool_step``): "where" (default — step everything,
    discard), "compact" (gather/scatter a dense sub-batch), or "kernel"
    (``step_fn`` is pool-level and mask-aware, threading ``active`` into the
    lane-masked kernels). The pool lives on the device of its templates.
    """

    def __init__(self, capacity: int, step_fn: Callable, *,
                 template_params: Any, template_opt: Any,
                 template_hparams: Any, exec_mode: str = "where"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if exec_mode not in packing.MASKED_MODES:
            raise ValueError(f"unknown exec_mode {exec_mode!r}; "
                             f"expected one of {packing.MASKED_MODES}")
        self.capacity = capacity
        self._step_fn = step_fn         # kept for resized()
        self.exec_mode = exec_mode
        self.params = packing.stack_trees([template_params] * capacity)
        self.opt_state = packing.stack_trees([template_opt] * capacity)
        self.hparams = packing.stack_trees([template_hparams] * capacity)
        self.active = np.zeros((capacity,), bool)
        self.owner: List[Optional[int]] = [None] * capacity   # task id
        self._step = packing.masked_pool_step(step_fn, mode=exec_mode)

    # ------------------------------------------------------------- lifecycle
    @property
    def n_traces(self) -> int:
        """Step programs this pool built, each at its first use: one in
        "where" and "kernel" mode, one per occupancy bucket in "compact"
        mode (at most log2(capacity)+1). The port compiles nothing; this is
        the count the reference takes of its jit traces."""
        return self._step.n_builds

    @property
    def device(self) -> torch.device:
        return packing.tree_leaves(self.params)[0].device

    def resized(self, capacity: int) -> "LanePool":
        """A FRESH empty pool of ``capacity`` lanes running the same step
        function. Templates come from lane 0's current state; callers drain
        this pool first and re-attach through the executor's refill."""
        return LanePool(capacity, self._step_fn,
                        template_params=packing.tree_get_lane(self.params, 0),
                        template_opt=packing.tree_get_lane(self.opt_state, 0),
                        template_hparams=packing.tree_get_lane(
                            self.hparams, 0),
                        exec_mode=self.exec_mode)

    def free_lanes(self) -> List[int]:
        return [i for i in range(self.capacity) if not self.active[i]]

    def active_lanes(self) -> List[int]:
        return [i for i in range(self.capacity) if self.active[i]]

    def attach(self, lane: int, task_id: int, params: Any, opt_state: Any,
               hparams: Any):
        """Copy a task's state into a free lane (in-place index writes)."""
        if self.active[lane]:
            raise RuntimeError(
                f"lane {lane} already occupied by task {self.owner[lane]}")
        packing.tree_set_lane(self.params, lane, params)
        packing.tree_set_lane(self.opt_state, lane, opt_state)
        packing.tree_set_lane(self.hparams, lane, hparams)
        self.active[lane] = True
        self.owner[lane] = task_id

    def detach(self, lane: int) -> Tuple[Any, Any]:
        """Free a lane, returning a copy of its (params, opt_state)."""
        if not self.active[lane]:
            raise RuntimeError(f"lane {lane} is not occupied")
        state = (packing.tree_copy(packing.tree_get_lane(self.params, lane)),
                 packing.tree_copy(packing.tree_get_lane(self.opt_state,
                                                         lane)))
        self.active[lane] = False
        self.owner[lane] = None
        return state

    # ------------------------------------------------------------------ step
    def step(self, batch: Any) -> Any:
        """One masked step over the whole pool. ``batch`` carries the lane
        axis at capacity; inactive lanes' entries may be any benign values
        (their state passes through and their metrics are discarded).
        Raises PoolStepError (chaining the original) if the step itself
        fails, an event that concerns every lane at once.

        The mask is handed over as host numpy: "compact" needs it on the
        host to pick the occupancy bucket without a device sync."""
        mask = np.array(self.active)
        try:
            self.params, self.opt_state, metrics = self._step(
                self.params, self.opt_state, batch, self.hparams, mask)
        except Exception as e:
            raise PoolStepError(f"masked pool step failed: {e}") from e
        return metrics


@dataclasses.dataclass
class LaneRecord:
    """One in-flight lane at drain time: state + cursor."""
    task_id: int
    step_done: int
    params: Any
    opt_state: Any
    hparams: Any


@dataclasses.dataclass
class PoolSnapshot:
    """A drained pool: per-lane states + task cursors.

    ``capacity`` records where the pool was when it drained; ``rehydrate``
    may resume on any capacity, since lane state is per task, not per slot.
    ``queued`` keeps the ids of tasks that never attached.
    """
    capacity: int
    lanes: List[LaneRecord]
    queued: List[int]

    def save(self, directory: str, step: int = 0) -> str:
        """Persist through the atomic checkpoint layout: one stacked tree of
        the in-flight lane states, cursors in the manifest's extra."""
        if self.lanes:
            tree = {"params": packing.stack_trees(
                        [r.params for r in self.lanes]),
                    "opt_state": packing.stack_trees(
                        [r.opt_state for r in self.lanes]),
                    "hparams": packing.stack_trees(
                        [r.hparams for r in self.lanes])}
        else:
            tree = {}
        extra = {"pool_snapshot": True, "capacity": self.capacity,
                 "task_ids": [r.task_id for r in self.lanes],
                 "steps_done": [r.step_done for r in self.lanes],
                 "queued": list(self.queued)}
        return ck.save_checkpoint(directory, tree, step, extra)

    @classmethod
    def load(cls, directory: str, template_params: Any, template_opt: Any,
             template_hparams: Any, step: int = None) -> "PoolSnapshot":
        """Restore from disk. Templates supply the per-lane tree structure,
        dtypes and device (the same ones a LanePool is built from)."""
        extra, step = ck.load_extra(directory, step)
        if not extra.get("pool_snapshot"):
            raise ValueError(f"{directory} is not a PoolSnapshot checkpoint")
        n = len(extra["task_ids"])
        if n:
            like = {"params": packing.stack_trees([template_params] * n),
                    "opt_state": packing.stack_trees([template_opt] * n),
                    "hparams": packing.stack_trees([template_hparams] * n)}
            tree, _, _ = ck.load_checkpoint(directory, like, step)
            lanes = [LaneRecord(
                task_id=tid, step_done=done,
                params=packing.tree_get_lane(tree["params"], i),
                opt_state=packing.tree_get_lane(tree["opt_state"], i),
                hparams=packing.tree_get_lane(tree["hparams"], i))
                for i, (tid, done) in enumerate(
                    zip(extra["task_ids"], extra["steps_done"]))]
        else:
            lanes = []
        return cls(capacity=int(extra["capacity"]), lanes=lanes,
                   queued=[int(i) for i in extra["queued"]])


def rehydrate(snapshot: PoolSnapshot,
              tasks: Sequence[LaneTask]) -> List[LaneTask]:
    """Rebuild the executor queue from a snapshot: in-flight tasks resume
    from their saved state and cursor, never-attached tasks keep their own
    init path. ``tasks`` must contain a LaneTask for every id the snapshot
    references. The order is deterministic: drained lanes first (in lane
    order), then the queued tail, so a resume at ANY capacity assigns work
    deterministically."""
    by_id = {t.id: t for t in tasks}
    out: List[LaneTask] = []
    for rec in snapshot.lanes:
        t = by_id[rec.task_id]
        t.step_done = rec.step_done
        t.init_fn = (lambda rec=rec: (rec.params, rec.opt_state))
        out.append(t)
    out.extend(by_id[tid] for tid in snapshot.queued)
    return out


@dataclasses.dataclass
class RefillStats:
    """What continuous refill did — the benchmark's raw material."""
    global_steps: int = 0               # pool.step() invocations
    lane_steps: int = 0                 # active lane-steps (useful work)
    attaches: int = 0                   # incl. re-attaches after a repack
    n_traces: int = 0                   # summed across repacked pools
    preempted: bool = False             # run drained to a PoolSnapshot
    repacks: int = 0                    # mid-run capacity changes
    capacity_trace: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)           # (global_step, new_capacity)
    spec_attaches: int = 0              # speculative twins launched
    spec_wins: int = 0                  # twin delivered the result first
    spec_cancelled: int = 0             # loser twins detached unfinished
    spec_lane_steps: int = 0            # pool steps burned by twins,
                                        # counted apart from lane_steps

    @property
    def occupancy(self) -> float:
        """Mean number of lanes doing useful work per global step."""
        if not self.global_steps:
            return 0.0
        return self.lane_steps / self.global_steps


class RefillExecutor:
    """Continuous refill: lanes never wait for a wave boundary.

    Each iteration: (1) attach queued tasks to every free lane, (2) one
    masked pool step, (3) retire lanes whose task hit its budget or
    early-stopped. ``on_metrics(task, step_index, lane_metrics) -> bool``
    observes per-step metrics and may request early stop by returning
    True; ``on_finish(task, params, opt_state)`` receives the final lane
    state.

    With ``checkpoint_every`` set, ``on_checkpoint(task, params,
    opt_state)`` also receives the lane state (views, read in place — the
    lane keeps running) every N task-steps.

    With ``record_history``, ``history`` records every (global_step, lane,
    task_id) occupancy so tests can verify no lane hosts two tasks at once.

    Preemption: ``should_preempt(stats)`` is consulted after every pool
    step (or call ``request_preempt()`` from a callback); when it fires the
    executor detaches every lane into ``self.snapshot`` (a PoolSnapshot),
    calls ``on_preempt(task, params, opt_state)`` per drained lane, and
    returns with ``stats.preempted`` set.

    Online elastic repacking: ``repack_policy`` is an object with
    ``observe(global_step, n_attached, capacity, queue_len)`` and
    ``decide(global_step, capacity, queue_len, live) -> new capacity or
    None``. When it decides on a new capacity the executor drains every
    lane in process, swaps ``self.pool`` for ``pool.resized(new_capacity)``
    and refills between two masked steps. A bare ``repack.RepackPolicy``
    is wrapped in a private ``repack.RepackController``.

    Speculative stragglers: with ``speculative`` set and a
    ``stragglers_fn`` naming suspect lanes, a flagged lane's task is
    duplicated onto a free slot once the queue has drained. The twin
    advances a COPY of the lane's state; first result wins, the loser is
    cancelled — exactly one ``on_finish`` fires, and twin metrics are
    suppressed.

    Traced (``core.spans``), each iteration is a ``pool.iteration`` span
    (attrs ``step``, ``active``, ``capacity``) holding ``pool.refill``
    (attr ``attached``: lanes attached), ``pool.batch``, ``pool.step`` and
    ``pool.retire``.
    """

    def __init__(self, pool: LanePool, *,
                 on_metrics: Optional[Callable[[LaneTask, int, Any], bool]] = None,
                 on_finish: Optional[Callable[[LaneTask, Any, Any], None]] = None,
                 on_step: Optional[Callable[[int, int, int], None]] = None,
                 checkpoint_every: int = 0,
                 on_checkpoint: Optional[Callable[[LaneTask, Any, Any],
                                                  None]] = None,
                 should_preempt: Optional[Callable[[RefillStats], bool]] = None,
                 on_preempt: Optional[Callable[[LaneTask, Any, Any],
                                               None]] = None,
                 speculative: bool = False,
                 stragglers_fn: Optional[Callable[[], List[int]]] = None,
                 repack_policy: Optional[Any] = None,
                 record_history: bool = False):
        self.pool = pool
        self.on_metrics = on_metrics
        self.on_finish = on_finish
        self.on_step = on_step          # (global, active, capacity)
        self.checkpoint_every = checkpoint_every
        self.on_checkpoint = on_checkpoint
        self.should_preempt = should_preempt
        self.on_preempt = on_preempt
        self.speculative = speculative
        self.stragglers_fn = stragglers_fn
        if repack_policy is not None and not hasattr(repack_policy, "decide"):
            repack_policy = RepackController(repack_policy)
        self.repack = repack_policy     # repack.RepackController (observe/
                                        # decide) — online elastic resize
        self.record_history = record_history
        self.history: List[Tuple[int, int, int]] = []
        self.snapshot: Optional[PoolSnapshot] = None
        self._trace_base = 0            # builds of pools retired by repack
        self._preempt_requested = False
        self._twin: Dict[int, int] = {}         # lane <-> twin lane
        self._spec_lanes: set = set()           # lanes hosting a twin copy
        self._speculated: set = set()           # task ids already twinned
        self._zero_batch: Any = None

    @property
    def n_traces(self) -> int:
        """Step programs built across every pool this executor has run."""
        return self._trace_base + self.pool.n_traces

    def request_preempt(self):
        """Drain to a PoolSnapshot after the current pool step (safe to
        call from any callback)."""
        self._preempt_requested = True

    def _refill(self, queue: deque, lane_task: List[Optional[LaneTask]],
                stats: RefillStats):
        for lane in self.pool.free_lanes():
            attached = False
            while queue and not attached:
                t = queue.popleft()
                params, opt_state = t.init_fn()
                if t.step_done >= t.steps:      # zero budget / fully
                    if self.on_finish is not None:   # checkpoint-restored
                        self.on_finish(t, params, opt_state)
                    continue
                self.pool.attach(lane, t.id, params, opt_state, t.hparams)
                lane_task[lane] = t
                stats.attaches += 1
                attached = True
            if not queue and not attached:
                break

    def _stacked_batch(self, lane_task: List[Optional[LaneTask]]) -> Any:
        """The tasks' batches stacked on the pool's device; free lanes get
        zeros of the same shapes."""
        dev = self.pool.device
        live = {i: packing.tree_map(
                    lambda x: torch.as_tensor(x, device=dev),
                    t.batch_fn(t.step_done))
                for i, t in enumerate(lane_task) if t is not None}
        if self._zero_batch is None:
            template = next(iter(live.values()))
            self._zero_batch = packing.tree_map(torch.zeros_like, template)
        return packing.stack_trees([live.get(i, self._zero_batch)
                                    for i in range(len(lane_task))])

    def _speculate(self, queue: deque, lane_task: List[Optional[LaneTask]],
                   stats: RefillStats):
        """Duplicate flagged straggler lanes onto free slots — only when
        the queue has drained, so speculation never displaces real work."""
        if queue or not self.speculative or self.stragglers_fn is None:
            return
        free = self.pool.free_lanes()
        if not free:
            return
        for lane in self.stragglers_fn():
            if not free:
                break
            t = lane_task[lane] if 0 <= lane < len(lane_task) else None
            if (t is None or t.id in self._speculated
                    or lane in self._spec_lanes or lane in self._twin):
                continue
            twin = dataclasses.replace(t)       # own cursor, same id
            fl = free.pop(0)
            self.pool.attach(
                fl, t.id,
                packing.tree_get_lane(self.pool.params, lane),
                packing.tree_get_lane(self.pool.opt_state, lane),
                t.hparams)
            lane_task[fl] = twin
            self._twin[lane] = fl
            self._twin[fl] = lane
            self._spec_lanes.add(fl)
            self._speculated.add(t.id)
            stats.spec_attaches += 1

    def _cancel_twin(self, lane: int, lane_task: List[Optional[LaneTask]],
                     stats: RefillStats) -> bool:
        """Winner on ``lane``: drop its twin without on_finish. Returns
        True when the winner was the speculative copy."""
        other = self._twin.pop(lane, None)
        if other is None:
            return False
        self._twin.pop(other, None)
        if lane_task[other] is not None:
            self.pool.detach(other)
            lane_task[other] = None
            stats.spec_cancelled += 1
        won_spec = lane in self._spec_lanes
        if won_spec:
            stats.spec_wins += 1
        self._spec_lanes.discard(lane)
        self._spec_lanes.discard(other)
        return won_spec

    def _drain(self, queue: deque, lane_task: List[Optional[LaneTask]],
               stats: RefillStats) -> PoolSnapshot:
        """Detach every lane into a PoolSnapshot (speculative twins are
        discarded — the primary copy carries the canonical state)."""
        lanes: List[LaneRecord] = []
        for lane, t in enumerate(lane_task):
            if t is None:
                continue
            if lane in self._spec_lanes:        # twin: primary survives
                self.pool.detach(lane)
                lane_task[lane] = None
                stats.spec_cancelled += 1
                continue
            params, opt_state = self.pool.detach(lane)
            lane_task[lane] = None
            if self.on_preempt is not None:
                self.on_preempt(t, params, opt_state)
            lanes.append(LaneRecord(task_id=t.id, step_done=t.step_done,
                                    params=params, opt_state=opt_state,
                                    hparams=t.hparams))
        self._twin.clear()
        self._spec_lanes.clear()
        queued = [t.id for t in queue]
        queue.clear()
        return PoolSnapshot(capacity=self.pool.capacity, lanes=lanes,
                            queued=queued)

    def _repack(self, queue: deque, lane_task: List[Optional[LaneTask]],
                new_capacity: int, stats: RefillStats
                ) -> List[Optional[LaneTask]]:
        """Swap the pool for one of ``new_capacity`` lanes between two
        masked steps: drain every live lane (its exact state becomes its
        own init_fn for one attach), requeue drained tasks AHEAD of the
        untouched tail, rebuild via pool.resized. Twins are cancelled."""
        resumed: List[LaneTask] = []
        for lane, t in enumerate(lane_task):
            if t is None:
                continue
            if lane in self._spec_lanes:        # twin: primary survives
                self.pool.detach(lane)
                stats.spec_cancelled += 1
                continue
            params, opt_state = self.pool.detach(lane)

            # one-shot resume closure: hands back the live state at the
            # re-attach, then restores the task's own init_fn
            def resume(t=t, params=params, opt_state=opt_state,
                       orig=t.init_fn):
                t.init_fn = orig
                return params, opt_state

            t.init_fn = resume
            resumed.append(t)
        self._twin.clear()
        self._spec_lanes.clear()
        tail = list(queue)
        queue.clear()
        queue.extend(resumed)
        queue.extend(tail)
        self._trace_base += self.pool.n_traces
        self.pool = self.pool.resized(new_capacity)
        stats.repacks += 1
        stats.capacity_trace.append((stats.global_steps, new_capacity))
        return [None] * new_capacity

    def run(self, tasks: Sequence[LaneTask]) -> RefillStats:
        queue = deque(tasks)
        pool = self.pool
        lane_task: List[Optional[LaneTask]] = [None] * pool.capacity
        stats = RefillStats()
        while queue or any(t is not None for t in lane_task):
            with spans.span("pool.iteration", step=stats.global_steps,
                            capacity=pool.capacity) as it:
                with spans.span("pool.refill") as sp:
                    before = stats.attaches + stats.spec_attaches
                    self._refill(queue, lane_task, stats)
                    self._speculate(queue, lane_task, stats)
                    sp.set(attached=stats.attaches + stats.spec_attaches
                           - before)
                if self._zero_batch is None and all(
                        t is None for t in lane_task):
                    break               # nothing attachable (empty task set)
                if self.record_history:
                    for lane, t in enumerate(lane_task):
                        if t is not None:
                            self.history.append((stats.global_steps, lane,
                                                 t.id))
                with spans.span("pool.batch"):
                    batch = self._stacked_batch(lane_task)
                with spans.span("pool.step"):
                    metrics = pool.step(batch)
                n_attached = sum(1 for t in lane_task if t is not None)
                it.set(active=n_attached)
                n_twin = sum(1 for l in self._spec_lanes
                             if lane_task[l] is not None)
                stats.lane_steps += n_attached - n_twin
                stats.spec_lane_steps += n_twin
                if self.on_step is not None:    # occupancy counts twins:
                    self.on_step(stats.global_steps,   # they really hold
                                 n_attached, pool.capacity)    # lanes
                stats.global_steps += 1
                # retire primaries BEFORE speculative twins: when both hit
                # budget in the same pass the primary delivers the final
                # on_metrics/on_finish and cancels the twin
                order = [l for l in range(len(lane_task))
                         if l not in self._spec_lanes]
                order += [l for l in range(len(lane_task))
                          if l in self._spec_lanes]
                with spans.span("pool.retire"):
                    for lane in order:
                        t = lane_task[lane]
                        if t is None:
                            continue
                        is_twin = lane in self._spec_lanes
                        stop = False
                        if self.on_metrics is not None and not is_twin:
                            lm = packing.lane_slice(metrics, lane)
                            stop = bool(self.on_metrics(t, t.step_done, lm))
                        t.step_done += 1
                        if stop:
                            t.stopped_early = True
                        if t.step_done >= t.steps or stop:
                            params, opt_state = pool.detach(lane)
                            lane_task[lane] = None
                            self._cancel_twin(lane, lane_task, stats)
                            if self.on_finish is not None:
                                self.on_finish(t, params, opt_state)
                            # the detached copy must not live on through
                            # the next refill and step: at a full-width
                            # model it is a lane
                            del params, opt_state
                        elif (self.checkpoint_every
                              and self.on_checkpoint is not None
                              and not is_twin
                              and t.step_done % self.checkpoint_every == 0):
                            self.on_checkpoint(
                                t, packing.tree_get_lane(pool.params, lane),
                                packing.tree_get_lane(pool.opt_state, lane))
                if self._preempt_requested or (
                        self.should_preempt is not None
                        and self.should_preempt(stats)):
                    self._preempt_requested = False
                    self.snapshot = self._drain(queue, lane_task, stats)
                    stats.preempted = True
                    break
                # online elastic repack: telemetry in, capacity decision out
                if self.repack is not None:
                    self.repack.observe(stats.global_steps, n_attached,
                                        pool.capacity, len(queue))
                    live = sum(1 for t in lane_task if t is not None)
                    new_cap = self.repack.decide(stats.global_steps,
                                                 pool.capacity, len(queue),
                                                 live)
                    if new_cap is not None and new_cap != pool.capacity:
                        lane_task = self._repack(queue, lane_task, new_cap,
                                                 stats)
                        pool = self.pool
        stats.n_traces = self._trace_base + pool.n_traces
        return stats


def run_waves(pool_factory: Callable[[], LanePool],
              tasks: Sequence[LaneTask],
              on_metrics: Optional[Callable[[LaneTask, int, Any], bool]] = None,
              on_finish: Optional[Callable[[LaneTask, Any, Any], None]] = None,
              ) -> RefillStats:
    """Wave-scheduling BASELINE: pack capacity-many tasks, run until the
    LAST one in the wave finishes, only then admit the next wave. Uses the
    same masked pool so the comparison isolates scheduling."""
    pool = pool_factory()
    queue = deque(tasks)
    stats = RefillStats()
    ex = RefillExecutor(pool, on_metrics=on_metrics, on_finish=on_finish)
    while queue:
        wave = [queue.popleft() for _ in range(min(pool.capacity, len(queue)))]
        lane_task: List[Optional[LaneTask]] = [None] * pool.capacity
        ex._refill(deque(wave), lane_task, stats)
        done: List[Optional[LaneTask]] = list(lane_task)
        while any(t is not None for t in done):
            batch = ex._stacked_batch(done)
            metrics = pool.step(batch)
            stats.lane_steps += sum(1 for t in done if t is not None)
            stats.global_steps += 1
            for lane, t in enumerate(done):
                if t is None:
                    continue
                stop = False
                if on_metrics is not None:
                    stop = bool(on_metrics(
                        t, t.step_done, packing.lane_slice(metrics, lane)))
                t.step_done += 1
                if stop:
                    t.stopped_early = True
                if t.step_done >= t.steps or stop:
                    params, opt_state = pool.detach(lane)
                    done[lane] = None   # lane idles until the wave drains
                    if on_finish is not None:
                        on_finish(t, params, opt_state)
                    del params, opt_state
    stats.n_traces = pool.n_traces
    return stats
