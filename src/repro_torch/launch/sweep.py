"""Parametric-study sweep — the paper's headline use case (port of
``repro.launch.sweep``).

Runs K training tasks (same architecture, different hyperparameters / data
seeds) under a triples placement: auto_nppn picks the largest safe packing
factor, tasks run as lanes of a persistent lane pool (core/lanepool.py)
with CONTINUOUS REFILL — the moment a lane's task exhausts its per-task
step budget (``SweepTask.steps``) or early-stops, the next queued task
attaches in its place, between two masked steps. The pool's step is built
once over the packing factor: ``torch.func.vmap`` of the training step in
the pool's "where" mode, as the reference vmaps it under ``jax.jit``; no
wave boundary, no rebuild, no idle lanes while work remains queued.

Checkpoints are per task (``{checkpoint_dir}/task_{id}``), written when a
lane detaches and every ``FaultPolicy.checkpoint_every`` steps mid-flight;
a re-run restores each task's saved state and skips the finished steps. OOM-backoff halves the pool capacity and re-enqueues the
unfinished tasks (in-flight progress of the failed pool is discarded, as a
packed-program OOM kills all lanes at once).

Lanes draw their parameters from ``torch.Generator(device).manual_seed(
task.seed)`` through ``model.init``; a lane's state lives on the model's
device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import optim
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import autotune, monitor, packing
from repro_torch.core import repack as rp
from repro_torch.core.faults import FaultPolicy
from repro_torch.core.lanepool import (LanePool, LaneTask, PoolStepError,
                                       RefillExecutor, RefillStats)
from repro_torch.core.monitor import RunMonitor, TenantGauges
from repro_torch.core.tenancy import MemoryAdmission
from repro_torch.launch.train import make_train_step
from repro_torch.models.model import Model


@dataclasses.dataclass
class SweepTask:
    id: int
    lr: float
    seed: int
    steps: Optional[int] = None         # per-task budget (None = sweep-wide)


@dataclasses.dataclass
class SweepResult:
    losses: Dict[int, List[float]]
    wall_s: float
    pack_factor: int
    backoffs: int = 0
    bytes_per_lane: int = 0             # admission footprint (0 = unprobed)
    admission_capped: bool = False      # pack shrunk by MemoryAdmission
    global_steps: int = 0               # masked pool steps executed
    lane_steps: int = 0                 # active lane-steps (useful work)
    refills: int = 0                    # lane attaches performed
    n_traces: int = 0                   # builds of the packed step
    preempted: bool = False             # drained to checkpoints mid-run;
                                        # re-run with the same
                                        # checkpoint_dir resumes (at any
                                        # max_pack) bit-identically
    repacks: int = 0                    # adaptive_pack capacity changes
    capacity_trace: List[tuple] = dataclasses.field(
        default_factory=list)           # (global_step, new_capacity)
    decision: Optional[autotune.PackingDecision] = None   # auto_nppn's,
                                        # when it ran (probes measured and
                                        # predicted)


def run_sweep(model: Model, tasks: Sequence[SweepTask], *,
              batch_fn: Callable[[int, int], Any],   # (seed, step) -> batch
              steps: int,
              hbm_budget: Optional[float] = None,
              max_pack: Optional[int] = None,
              checkpoint_dir: Optional[str] = None,
              policy: Optional[FaultPolicy] = None,
              opt: Optional[optim.Optimizer] = None,
              admission: Optional[MemoryAdmission] = None,
              tenant: str = "default",
              gauges: Optional[TenantGauges] = None,
              early_stop: Optional[Callable[[SweepTask, int, float], bool]]
              = None,
              preempt: Optional[Callable[[RefillStats], bool]]
              = None,
              stragglers_fn: Optional[Callable[[], List[int]]] = None,
              adaptive_pack: bool = False,
              repack_policy: Optional[rp.RepackPolicy] = None,
              measure_bytes: Optional[Callable[[], float]] = None
              ) -> SweepResult:
    """Train all tasks on a continuously-refilled lane pool.

    ``steps`` is the sweep-wide budget; a task's own ``SweepTask.steps``
    overrides it (skewed-duration sweeps). ``early_stop(task, step, loss)``
    may retire a lane early — its slot refills immediately. With
    ``admission`` set, the per-lane footprint of a profiled single-lane
    step caps the pool capacity BEFORE anything runs (multi-tenant
    admission control, DESIGN.md §4.3); ``gauges`` charges the pool to
    ``tenant`` in the shared per-tenant LLload table and receives per-step
    lane-occupancy samples for the ``sweep:{tenant}`` gang.

    Preemption (DESIGN.md §8): ``preempt(stats)`` is consulted after
    every pool step; when it fires the pool DRAINS — every in-flight
    lane's state is checkpointed at its exact cursor — and the call
    returns with ``SweepResult.preempted`` set. A later ``run_sweep``
    with the same ``checkpoint_dir`` (and ANY ``max_pack``, e.g. half
    when only partial capacity freed) resumes every task from its saved
    step and produces bit-identical remaining losses: lanes are
    independent under vmap and batches are keyed (seed, step), so the
    loss stream cannot depend on which lane or capacity served it.
    Requires ``checkpoint_dir`` — a drain without a checkpoint seam
    would silently discard progress.

    Speculative stragglers (``FaultPolicy.speculative_stragglers``):
    flagged lanes duplicate onto free pool slots, first result wins.
    On THIS substrate's single-host lockstep pool every lane steps in
    one call, so per-lane step-time skew cannot arise and the
    default monitor signal never flags anyone — pass ``stragglers_fn``
    to supply a real signal (per-device pools, external telemetry, or
    tests); the default stays ``RunMonitor.stragglers`` (EWMA per-lane
    times, live once lane times exist).

    Online elastic repacking (``adaptive_pack`` — DESIGN.md §9): skip
    the static auto_nppn probe entirely, start at the conservative
    ``RepackPolicy.start_capacity`` and let a RepackController converge
    the pack factor to the frontier ONLINE from live telemetry
    (occupancy EWMA, queue depth, measured pool footprint vs
    ``hbm_budget``). Per-task losses stay bit-identical across repacks;
    ``SweepResult.repacks``/``capacity_trace`` record the trajectory
    and the final ``pack_factor`` is the converged capacity. When
    ``admission`` is set, each repack reports the MEASURED per-lane
    footprint to it (record_measured), so later scheduler admissions
    for this tenant consume measurements instead of static profiles.
    ``measure_bytes`` injects a footprint telemetry source (default:
    the CUDA allocator's live bytes)."""
    policy = policy or FaultPolicy()
    if preempt is not None and not checkpoint_dir:
        raise ValueError("preempt requires checkpoint_dir: draining "
                         "without a checkpoint seam discards progress")
    opt = opt or optim.adamw(weight_decay=0.0)
    step_fn = make_train_step(model, opt)

    # ---- choose packing factor (auto_nppn) ----
    n = len(tasks)
    if max_pack is None:
        max_pack = n

    dev = model.device

    def make_generator(seed: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(seed)

    def make_packed(k):
        return torch.func.vmap(step_fn)

    def example_args(k):
        gen = make_generator(0)
        p = packing.pack_init(model.init, [gen] * k)
        o = packing.stack_trees([opt.init(packing.lane_slice(p, i))
                                 for i in range(k)])
        b = packing.tree_map(
            lambda x: torch.as_tensor(x, device=dev).expand(k, *np.shape(x)),
            batch_fn(0, 0))
        lr = torch.zeros((k,), dtype=torch.float32, device=dev)
        return (p, o, b, lr)

    single_profile = None
    decision = None
    repack_pol = repack_policy or rp.RepackPolicy()
    if adaptive_pack:
        # conservative start; the controller converges online (no probe)
        pack = max(1, min(repack_pol.start_capacity, max_pack, n))
    elif hbm_budget is not None:
        decision = autotune.auto_nppn(make_packed, example_args,
                                      hbm_budget, max_factor=max_pack)
        pack = decision.nppn_per_chip
        single_profile = decision.profile_single
    else:
        pack = min(max_pack, n)

    # ---- memory-aware admission: footprint caps the pool up front ----
    bytes_per_lane = 0
    admission_capped = False
    if admission is not None:
        if single_profile is None:      # auto_nppn already probed k=1
            bytes_per_lane = monitor.memory_per_lane(make_packed(1),
                                                     *example_args(1))
        else:
            bytes_per_lane = single_profile.resident_bytes
        try:
            cap = admission.require_fits(bytes_per_lane)
        except MemoryError as e:
            raise MemoryError(f"tenant {tenant!r}: {e}") from None
        if pack > cap:
            pack, admission_capped = cap, True

    # ---- continuous refill over a persistent lane pool ----
    t0 = time.perf_counter()
    losses: Dict[int, List[float]] = {t.id: [] for t in tasks}
    mon = RunMonitor(straggler_ratio=policy.straggler_ratio)
    backoffs = 0
    preempted = False
    totals = dict(global_steps=0, lane_steps=0, refills=0, n_traces=0,
                  repacks=0)
    capacity_trace: List[tuple] = []
    gang = f"sweep:{tenant}"
    adaptive_pol = None
    if adaptive_pack:
        adaptive_pol = repack_pol
        if admission is not None and bytes_per_lane > 0:
            # admission's static cap bounds online growth too (the
            # measured frontier may later shrink it further)
            adaptive_pol = dataclasses.replace(
                adaptive_pol,
                max_capacity=max(adaptive_pol.min_capacity,
                                 min(adaptive_pol.max_capacity,
                                     admission.require_fits(bytes_per_lane))))

    # ONE Checkpointer per task for the whole sweep: its save(blocking=
    # False) joins the previous thread, so async saves to a task dir
    # serialize and restore can never race a garbage collection
    _cks: Dict[int, Checkpointer] = {}
    _restored_done: set = set()         # finished in a PREVIOUS run: skip,
                                        # and do not re-save their artifact

    def ck_for(task_id: int) -> Checkpointer:
        if task_id not in _cks:
            _cks[task_id] = Checkpointer(f"{checkpoint_dir}/task_{task_id}")
        return _cks[task_id]

    def make_lane_task(t: SweepTask) -> LaneTask:
        budget = steps if t.steps is None else t.steps
        lt = LaneTask(id=t.id,
                      hparams=torch.tensor(t.lr, dtype=torch.float32),
                      init_fn=None,
                      batch_fn=lambda s, seed=t.seed: batch_fn(seed, s),
                      steps=budget)

        def init_fn(lt=lt, t=t):
            params = model.init(make_generator(t.seed))
            opt_state = opt.init(params)
            lt.step_done = 0
            if checkpoint_dir:
                try:
                    state, start, extra = ck_for(t.id).restore(
                        {"params": params, "opt_state": opt_state})
                    params, opt_state = state["params"], state["opt_state"]
                    lt.step_done = start
                    if extra.get("done"):   # finished or early-stopped in
                        lt.step_done = lt.steps     # a previous run: skip
                        _restored_done.add(t.id)
                except FileNotFoundError:
                    pass
            # keep the recorded history consistent with the attach point
            # (covers both OOM-backoff re-attach — resume from the last
            # mid-flight save, dropping unsaved steps — and fresh restart)
            losses[t.id] = losses[t.id][:lt.step_done]
            return params, opt_state

        lt.init_fn = init_fn
        return lt

    by_id = {t.id: t for t in tasks}
    queue = [make_lane_task(t) for t in tasks]
    template = model.init(make_generator(0))
    while queue:
        pool = LanePool(min(pack, len(queue)), step_fn,
                        template_params=template,
                        template_opt=opt.init(template),
                        template_hparams=torch.tensor(0.0, device=dev))
        if gauges is not None:
            gauges.on_dispatch(tenant, nodes=1, lanes=pool.capacity,
                               resident_bytes=bytes_per_lane * pool.capacity)
        t_pool = time.perf_counter()
        finished: set = set()

        def on_metrics(lt: LaneTask, step_idx: int, lane_metrics) -> bool:
            losses[lt.id].append(float(lane_metrics["loss"]))
            if early_stop is not None:
                return bool(early_stop(by_id[lt.id], step_idx,
                                       losses[lt.id][-1]))
            return False

        def on_finish(lt: LaneTask, params, opt_state):
            finished.add(lt.id)
            if checkpoint_dir and lt.id not in _restored_done:
                ck = ck_for(lt.id)      # async path joins the pending
                ck.save({"params": params, "opt_state": opt_state},
                        lt.step_done, extra={"done": True}, blocking=False)
                ck.wait()               # mid-flight save before this one

        def on_checkpoint(lt: LaneTask, params, opt_state):
            ck_for(lt.id).save({"params": params, "opt_state": opt_state},
                               lt.step_done, blocking=False)

        def on_preempt(lt: LaneTask, params, opt_state):
            # drain: the lane's exact cursor goes to the task's own
            # checkpoint dir — the resume path is the ordinary restore
            ck = ck_for(lt.id)
            ck.save({"params": params, "opt_state": opt_state},
                    lt.step_done, blocking=False)
            ck.wait()

        def on_step(global_step: int, active: int, capacity: int):
            if gauges is not None:
                gauges.on_lane_sample(tenant, gang, active, capacity)

        # one controller PER POOL ATTEMPT: an OOM-backoff retry gets a
        # fresh cooldown anchor and repack budget (a private gauge set —
        # the sweep's own on_step already samples the shared ``gauges``
        # for this gang; sharing them here would double-decay the EWMA)
        controller = None
        if adaptive_pol is not None:
            controller = rp.RepackController(
                adaptive_pol, hbm_budget=hbm_budget, tenant=tenant,
                gang=f"repack:{gang}", admission=admission,
                measure_bytes=measure_bytes)

        ex = RefillExecutor(
            pool, on_metrics=on_metrics, on_finish=on_finish,
            on_step=on_step,
            checkpoint_every=(policy.checkpoint_every
                              if checkpoint_dir else 0),
            on_checkpoint=on_checkpoint if checkpoint_dir else None,
            should_preempt=preempt,
            on_preempt=on_preempt if checkpoint_dir else None,
            speculative=policy.speculative_stragglers,
            stragglers_fn=stragglers_fn or mon.stragglers,
            repack_policy=controller)
        try:
            stats = ex.run(queue)
        except PoolStepError:   # pool-wide OOM: halve capacity, redo
                                # unfinished (callback bugs propagate raw)
            if policy.oom_backoff and ex.pool.capacity > policy.min_pack_factor:
                backoffs += 1
                # halve from where the pool actually WAS (adaptive repack
                # may have moved it since dispatch)
                pack = max(policy.min_pack_factor, ex.pool.capacity // 2)
                totals["n_traces"] += ex.n_traces
                if adaptive_pol is not None:
                    # the retry's fresh controller must not regrow past
                    # the capacity that just OOM'd, or the halve/regrow
                    # cycle never terminates — each backoff lowers the
                    # ceiling, preserving the static path's log2 bound
                    adaptive_pol = dataclasses.replace(
                        adaptive_pol,
                        max_capacity=max(adaptive_pol.min_capacity,
                                         min(adaptive_pol.max_capacity,
                                             pack)))
                # unfinished tasks re-attach via init_fn, which resumes
                # from their last saved checkpoint (or step 0) and trims
                # the loss history to match — the failed pool's unsaved
                # progress is lost, as a packed OOM kills all lanes
                queue = [lt for lt in queue if lt.id not in finished]
                if gauges is not None:
                    gauges.on_release(
                        tenant, nodes=1,
                        node_time=time.perf_counter() - t_pool,
                        lanes=pool.capacity,
                        resident_bytes=bytes_per_lane * pool.capacity)
                continue
            raise
        totals["global_steps"] += stats.global_steps
        totals["lane_steps"] += stats.lane_steps
        totals["refills"] += stats.attaches
        totals["n_traces"] += stats.n_traces
        totals["repacks"] += stats.repacks
        capacity_trace.extend(stats.capacity_trace)
        if adaptive_pack:
            pack = ex.pool.capacity     # report the CONVERGED factor
        if stats.preempted:
            preempted = True            # drained to per-task checkpoints;
                                        # a re-run resumes every cursor
        if gauges is not None:
            gauges.on_release(tenant, nodes=1,
                              node_time=time.perf_counter() - t_pool,
                              lanes=pool.capacity,
                              resident_bytes=bytes_per_lane * pool.capacity)
        queue = []

    for ck in _cks.values():            # join any pending async saves
        ck.wait()
    return SweepResult(losses=losses, wall_s=time.perf_counter() - t0,
                       pack_factor=pack, backoffs=backoffs,
                       bytes_per_lane=bytes_per_lane,
                       admission_capped=admission_capped,
                       global_steps=totals["global_steps"],
                       lane_steps=totals["lane_steps"],
                       refills=totals["refills"],
                       n_traces=totals["n_traces"],
                       preempted=preempted,
                       repacks=totals["repacks"],
                       capacity_trace=capacity_trace,
                       decision=decision)
