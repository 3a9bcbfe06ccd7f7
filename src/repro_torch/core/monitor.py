"""LLload analogue: resource monitoring for triples jobs (port of the
profile and runtime half of ``repro.core.monitor``).

  * static  — ``profile_fn`` measures one call of a step: its FLOPs and the
    bytes it keeps resident. The reference reads both from XLA's compiled
    program without running it; the port has no compiled program, so it
    runs the step once on the example arguments.
  * runtime — per-step wall time and live device bytes; produces the
    LLload-style summary and flags stragglers.
  * gauges — the per-tenant, per-gang and per-slice LLload tables
    (``TenantGauges``) and ``llload_table``: plain Python, copied from the
    reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode


# ---------------------------------------------------------------------------
# static profile of one step
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StaticProfile:
    """What LLload would show once the job is resident, measured pre-run."""
    argument_bytes: int
    temp_bytes: int
    output_bytes: int
    flops: float
    bytes_accessed: float
    predicted: bool = False         # extrapolated from measured steps, not
                                    # run (``autotune.auto_nppn``)

    @property
    def resident_bytes(self) -> int:
        return self.argument_bytes + self.temp_bytes + self.output_bytes

    def fits(self, hbm_budget: float, headroom: float = 0.95) -> bool:
        return self.resident_bytes <= hbm_budget * headroom

    def load_proxy(self, peak_flops: float, step_time_s: float) -> float:
        """GPU-load analogue: achieved FLOP/s over peak (the paper's
        'GPU load' y-axis, Figs 2/7)."""
        return self.flops / step_time_s / peak_flops


def _tensors(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _nbytes(tree: Any) -> int:
    return int(sum(t.numel() * t.element_size() for t in _tensors(tree)))


def profile_fn(fn, *example_args) -> StaticProfile:
    """Run ``fn(*example_args)`` once and profile it.

    ``flops`` is ``torch.utils.flop_counter.FlopCounterMode``'s count (the
    matmul, convolution and attention ops it knows). ``argument_bytes`` and
    ``output_bytes`` are the bytes of the tensors passed in and returned;
    ``bytes_accessed`` is their sum (each input read once, each output
    written once). ``temp_bytes`` depends on the device of the arguments:
    on CUDA it is the peak of ``torch.cuda.max_memory_allocated`` during
    the call above what was allocated before it, less the outputs; on the
    CPU nothing tracks allocations, so it is 0 and ``resident_bytes``
    counts arguments and outputs only."""
    arg_tensors = _tensors(example_args)
    on_cuda = any(t.is_cuda for t in arg_tensors)
    if on_cuda:
        device = next(t.device for t in arg_tensors if t.is_cuda)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        before = torch.cuda.memory_allocated(device)
    with FlopCounterMode(display=False) as counter:
        out = fn(*example_args)
    out_bytes = _nbytes(out)
    temp = 0
    if on_cuda:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
        temp = max(0, peak - before - out_bytes)
    arg_bytes = _nbytes(example_args)
    return StaticProfile(argument_bytes=arg_bytes, temp_bytes=int(temp),
                         output_bytes=out_bytes,
                         flops=float(counter.get_total_flops()),
                         bytes_accessed=float(arg_bytes + out_bytes))


def memory_per_lane(step_fn, *one_lane_args) -> int:
    """Bytes one lane needs (arguments + temporaries + outputs), from a
    profiled single-lane step: the per-task entry of the LLload table."""
    return profile_fn(step_fn, *one_lane_args).resident_bytes


# ---------------------------------------------------------------------------
# runtime monitor
# ---------------------------------------------------------------------------

def live_device_bytes() -> int:
    """Bytes PyTorch holds allocated on the current CUDA device (the 'GPU
    memory used' column); 0 on a machine without a card."""
    if not torch.cuda.is_available():
        return 0
    return int(torch.cuda.memory_allocated())


@dataclasses.dataclass
class StepRecord:
    step: int
    wall_s: float
    live_bytes: int
    lane_times: Optional[np.ndarray] = None


@dataclasses.dataclass
class RunMonitor:
    """Collects per-step timing/memory; flags stragglers.

    A lane whose EWMA step time exceeds ``straggler_ratio`` × the median
    lane EWMA is reported (the paper's motivation for watching LLload
    while the sweep runs).
    """
    straggler_ratio: float = 1.5
    history: List[StepRecord] = dataclasses.field(default_factory=list)
    _ewma: Optional[np.ndarray] = None
    _t0: Optional[float] = None

    def start_step(self):
        self._t0 = time.perf_counter()

    def end_step(self, step: int, lane_times: Optional[np.ndarray] = None):
        wall = time.perf_counter() - self._t0
        self.history.append(StepRecord(step, wall, live_device_bytes(),
                                       lane_times))
        if lane_times is not None:
            lt = np.asarray(lane_times, dtype=np.float64)
            self._ewma = lt if self._ewma is None else 0.7 * self._ewma + 0.3 * lt
        return wall

    def stragglers(self) -> List[int]:
        if self._ewma is None or len(self._ewma) < 2:
            return []
        med = float(np.median(self._ewma))
        if med <= 0:
            return []
        return [i for i, t in enumerate(self._ewma)
                if t > self.straggler_ratio * med]

    def summary(self) -> Dict[str, float]:
        if not self.history:
            return {}
        walls = np.array([r.wall_s for r in self.history])
        return {"steps": len(walls), "mean_s": float(walls.mean()),
                "p50_s": float(np.median(walls)), "max_s": float(walls.max()),
                "last_live_bytes": self.history[-1].live_bytes}


# ---------------------------------------------------------------------------
# per-tenant gauges (multi-tenant LLload — DESIGN.md §4)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TenantGauge:
    """Live per-tenant counters, the multi-user row of the LLload table."""
    user: str
    nodes_held: int = 0
    lanes: int = 0                      # packed lanes currently resident
    resident_bytes: int = 0
    node_time: float = 0.0              # accumulated node-seconds/rounds
    jobs_done: int = 0
    jobs_rejected: int = 0
    jobs_preempted: int = 0             # gangs checkpointed off their nodes
    jobs_resumed: int = 0               # preempted gangs re-dispatched
    watchdog_restarts: int = 0          # wedged gangs force-restarted
    slices: int = 0                     # spatial slices currently held
    waits: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class GangLaneGauge:
    """Per-GANG lane-occupancy gauge (one gang = one lane pool).

    Occupancy samples are decayed PER GANG, not per node or per tenant:
    under continuous refill, lanes of different gangs churn at different
    rates, and a shared EWMA would smear a draining gang's falling
    occupancy over a full one. ``occupancy`` is an EWMA of
    active/capacity; ``last`` the raw latest sample."""
    user: str
    gang: str
    capacity: int = 0
    active: int = 0
    occupancy: float = 0.0              # decayed (EWMA) fraction
    last: float = 0.0                   # latest raw fraction
    samples: int = 0
    heartbeats: int = 0                 # rounds with task-completion progress
    silent_rounds: int = 0              # consecutive rounds without progress
                                        # (the watchdog's wedge signal,
                                        # DESIGN.md §15)


@dataclasses.dataclass
class SliceGauge:
    """One allocated spatial slice (core/spatial.py, DESIGN.md §10) —
    the per-slice row of the operator's LLload table: who holds which
    fraction of which node, and how many lanes run inside it."""
    user: str
    node: int
    slice_index: int
    chip_frac: float
    hbm_frac: float
    lanes: int


class TenantGauges:
    """Per-tenant resource gauges the scheduler updates at dispatch/release.

    The paper's workflow is a human watching LLload for ONE job; under
    tenancy an operator needs the same table split by user — who holds
    which nodes, how many packed lanes, how much HBM, how many spatial
    slices, and the fair-share usage each tenant has accumulated."""

    def __init__(self, occupancy_decay: float = 0.7):
        if not 0 < occupancy_decay < 1:
            raise ValueError(
                f"occupancy_decay must be in (0, 1), got {occupancy_decay}")
        self._g: Dict[str, TenantGauge] = {}
        self._gangs: Dict[str, GangLaneGauge] = {}
        self._slices: Dict[tuple, SliceGauge] = {}   # (node, slice) -> gauge
        self.occupancy_decay = occupancy_decay

    def gauge(self, user: str) -> TenantGauge:
        if user not in self._g:
            self._g[user] = TenantGauge(user=user)
        return self._g[user]

    # ---------------------------------------------- per-gang lane occupancy
    def gang_gauge(self, gang: str, user: str = "") -> GangLaneGauge:
        if gang not in self._gangs:
            self._gangs[gang] = GangLaneGauge(user=user, gang=gang)
        return self._gangs[gang]

    def on_lane_sample(self, user: str, gang: str, active: int,
                       capacity: int):
        """One lane-occupancy sample for ``gang``'s pool: EWMA-decayed per
        gang so refill churn on one gang cannot destabilize another's
        reading."""
        g = self.gang_gauge(gang, user)
        g.user = g.user or user
        g.capacity = capacity
        g.active = active
        frac = active / capacity if capacity else 0.0
        g.last = frac
        if g.samples == 0:
            g.occupancy = frac
        else:
            d = self.occupancy_decay
            g.occupancy = d * g.occupancy + (1 - d) * frac
        g.samples += 1

    def on_heartbeat(self, user: str, gang: str, silent: int):
        """One scheduler-round heartbeat for ``gang``: ``silent`` is how
        many consecutive rounds it has gone without completing a task
        (0 = progressed this round). The watchdog reads this back as its
        wedge signal; the gauge keeps it visible in the gang table."""
        g = self.gang_gauge(gang, user)
        g.user = g.user or user
        if silent == 0:
            g.heartbeats += 1
        g.silent_rounds = silent

    def on_watchdog_restart(self, user: str):
        """The watchdog preempted a wedged gang for elastic resume (NOT
        a fairness preemption — counted separately so the operator can
        tell policy pressure from fault recovery)."""
        self.gauge(user).watchdog_restarts += 1

    def on_gang_done(self, gang: str):
        """Retire a finished gang's occupancy gauge."""
        self._gangs.pop(gang, None)

    def user_occupancy(self, user: str) -> float:
        """Highest occupancy-EWMA across this user's live gang gauges —
        the default interference-intensity signal the spatial mode
        planner consumes (``spatial.ewma_interference``): a tenant whose
        lanes run saturated is the tenant whose co-residents contend for
        the chip's HBM bandwidth. 0.0 when the user has no live gang."""
        return max((g.occupancy for g in self._gangs.values()
                    if g.user == user), default=0.0)

    # -------------------------------------------------- per-slice gauges
    def on_slice_alloc(self, user: str, node: int, slice_index: int,
                       chip_frac: float, hbm_frac: float, lanes: int = 0):
        """A spatial slice was granted: one row into the slice table and
        the holder's slice count."""
        self._slices[(node, slice_index)] = SliceGauge(
            user=user, node=node, slice_index=slice_index,
            chip_frac=chip_frac, hbm_frac=hbm_frac, lanes=lanes)
        self.gauge(user).slices += 1

    def on_slice_release(self, node: int, slice_index: int):
        g = self._slices.pop((node, slice_index), None)
        if g is not None:
            tg = self.gauge(g.user)
            tg.slices = max(0, tg.slices - 1)

    def slice_table(self) -> str:
        """Render the live spatial-partition snapshot (DESIGN.md §10)."""
        lines = [f"{'NODE':>4s} {'SLICE':>5s} {'TENANT':12s} "
                 f"{'CHIP%':>6s} {'HBM%':>6s} {'LANES':>5s}"]
        for key in sorted(self._slices):
            g = self._slices[key]
            lines.append(f"{g.node:>4d} {g.slice_index:>5d} {g.user:12s} "
                         f"{g.chip_frac:>6.1%} {g.hbm_frac:>6.1%} "
                         f"{g.lanes:>5d}")
        return "\n".join(lines)

    def gang_table(self) -> str:
        """Render the per-gang lane-occupancy snapshot."""
        lines = [f"{'GANG':20s} {'TENANT':12s} {'LANES':>5s} "
                 f"{'ACTIVE':>6s} {'OCC(EWMA)':>9s} {'OCC(LAST)':>9s}"]
        for gang in sorted(self._gangs):
            g = self._gangs[gang]
            lines.append(f"{gang:20s} {g.user:12s} {g.capacity:>5d} "
                         f"{g.active:>6d} {g.occupancy:>8.1%} "
                         f"{g.last:>8.1%}")
        return "\n".join(lines)

    def on_dispatch(self, user: str, nodes: int, lanes: int = 0,
                    resident_bytes: int = 0,
                    wait: Optional[float] = None):
        """``wait`` is sampled into the tenant's wait distribution only
        when given — a preempted gang's RESUME dispatch must not add a
        second partial sample for a job that already recorded its queue
        wait at first dispatch."""
        g = self.gauge(user)
        g.nodes_held += nodes
        g.lanes += lanes
        g.resident_bytes += resident_bytes
        if wait is not None:
            g.waits.append(wait)

    def on_release(self, user: str, nodes: int, node_time: float,
                   lanes: int = 0, resident_bytes: int = 0,
                   rejected: bool = False):
        g = self.gauge(user)
        g.nodes_held = max(0, g.nodes_held - nodes)
        g.lanes = max(0, g.lanes - lanes)
        g.resident_bytes = max(0, g.resident_bytes - resident_bytes)
        g.node_time += node_time
        if rejected:
            g.jobs_rejected += 1
        else:
            g.jobs_done += 1

    def on_reject(self, user: str):
        self.gauge(user).jobs_rejected += 1

    def on_preempt(self, user: str, nodes: int, node_time: float,
                   lanes: int = 0, resident_bytes: int = 0):
        """A gang was checkpointed off its nodes: release the holdings,
        bill the held time, count the preemption (NOT a completion)."""
        g = self.gauge(user)
        g.nodes_held = max(0, g.nodes_held - nodes)
        g.lanes = max(0, g.lanes - lanes)
        g.resident_bytes = max(0, g.resident_bytes - resident_bytes)
        g.node_time += node_time
        g.jobs_preempted += 1

    def on_resume(self, user: str):
        """A preempted gang re-dispatched (its on_dispatch carries the
        granted — possibly elastically narrowed — holdings)."""
        self.gauge(user).jobs_resumed += 1

    # ------------------------------------------------- wait distributions
    #: bucket upper bounds (rounds/seconds); the last bucket is open-ended
    WAIT_BINS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)

    def wait_histogram(self, user: str,
                       bins: Optional[tuple] = None) -> List[int]:
        """Per-tenant queue-wait histogram: counts per bucket of
        ``bins + (inf,)``. The preemption benchmark reads the small-job
        tail off this (does preemption move waits out of the top bucket)."""
        edges = list(bins if bins is not None else self.WAIT_BINS)
        counts = [0] * (len(edges) + 1)
        for w in self.gauge(user).waits:
            for i, e in enumerate(edges):
                if w <= e:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
        return counts

    def wait_quantile(self, user: str, q: float) -> float:
        """Empirical wait quantile (q in [0, 1]) for one tenant."""
        ws = sorted(self.gauge(user).waits)
        if not ws:
            return 0.0
        idx = min(len(ws) - 1, max(0, int(round(q * (len(ws) - 1)))))
        return ws[idx]

    # -------------------------------------------- snapshot (DESIGN.md §15)
    def state_dict(self) -> dict:
        """JSON-safe state for control-plane snapshots: the gauges must
        survive compaction exactly like the accountant does, or a
        recovered daemon's LLload table forgets history."""
        return {
            "occupancy_decay": self.occupancy_decay,
            "tenants": {u: dataclasses.asdict(g)
                        for u, g in sorted(self._g.items())},
            "gangs": {k: dataclasses.asdict(g)
                      for k, g in sorted(self._gangs.items())},
            "slices": [dataclasses.asdict(g)
                       for _, g in sorted(self._slices.items())],
        }

    def load_state(self, state: dict):
        self.occupancy_decay = state["occupancy_decay"]
        self._g = {u: TenantGauge(**row)
                   for u, row in state["tenants"].items()}
        self._gangs = {k: GangLaneGauge(**row)
                       for k, row in state["gangs"].items()}
        self._slices = {(row["node"], row["slice_index"]): SliceGauge(**row)
                        for row in state["slices"]}

    def table(self) -> str:
        """Render the per-tenant LLload-style snapshot."""
        lines = [f"{'TENANT':12s} {'NODES':>5s} {'SLC':>3s} {'LANES':>5s} "
                 f"{'HBM-USED':>10s} {'NODE-TIME':>10s} {'DONE':>4s} "
                 f"{'REJ':>3s} {'PRE':>3s} {'RES':>3s} {'MEAN-WAIT':>9s}"]
        for user in sorted(self._g):
            g = self._g[user]
            mw = sum(g.waits) / len(g.waits) if g.waits else 0.0
            lines.append(
                f"{user:12s} {g.nodes_held:>5d} {g.slices:>3d} {g.lanes:>5d} "
                f"{g.resident_bytes/1e9:>8.1f}GB {g.node_time:>10.1f} "
                f"{g.jobs_done:>4d} {g.jobs_rejected:>3d} "
                f"{g.jobs_preempted:>3d} {g.jobs_resumed:>3d} {mw:>9.1f}")
        return "\n".join(lines)


def llload_table(node_name: str, profiles: Dict[str, StaticProfile],
                 hbm_total: float, step_times: Dict[str, float],
                 peak_flops: float) -> str:
    """Render the LLload-style snapshot (paper Fig. 1) for compiled jobs."""
    lines = [f"{'JOB':24s} {'GPUMEM-USED':>12s} {'GPUMEM-FREE':>12s} "
             f"{'GPULOAD':>8s}"]
    for name, p in profiles.items():
        used = p.resident_bytes
        load = (p.load_proxy(peak_flops, step_times[name])
                if name in step_times else float("nan"))
        lines.append(f"{name:24s} {used/1e9:10.1f}GB {(hbm_total-used)/1e9:10.1f}GB "
                     f"{load:8.2f}")
    return "\n".join(lines)
