"""Online elastic repacking: close the paper's LLload feedback loop
(port of ``repro.core.repack``, plain Python but for its default
footprint source, ``monitor.live_device_bytes``).

The paper's workflow is a HUMAN control loop — run LLload, read GPU
load + memory, pick NPPN, resubmit. ``auto_nppn`` (core/autotune.py)
automated the ahead-of-time half: probe compiled footprints, choose a
pack factor, freeze it for the whole run. But a frozen factor is wrong
the moment the workload changes phase: queue depth collapses (lanes
idle), or the live footprint grows toward the OOM frontier (the paper's
21/48 dead tasks, mid-run edition). MISO (Li et al., 2022) and Xing et
al. (2025) both show workload-aware DYNAMIC right-sizing beats any
static choice.

This module is the online half of the loop:

  * ``RepackPolicy`` — the pure decision rule: given occupancy (EWMA),
    queue depth and the measured per-lane HBM footprint, propose a new
    pool capacity. Grow when lanes are saturated and work is queued and
    memory headroom exists; shrink when occupancy sags; shrink
    IMMEDIATELY (cooldown ignored) when the measured footprint pushes
    the current capacity over the OOM frontier.

  * ``RepackController`` — the stateful telemetry watcher wired into a
    running executor: per-step lane-occupancy samples feed a per-gang
    EWMA gauge (core/monitor.py GangLaneGauge — the same decay model
    the scheduler's LLload table uses), the measured pool footprint
    feeds the frontier guard, and each repack event optionally reports
    the MEASURED per-lane bytes to ``tenancy.MemoryAdmission`` so
    scheduler admission stops trusting stale static profiles.

The mechanism that makes a mid-run capacity change SAFE is the
drain/rehydrate seam (core/lanepool.py): lane state is per-task, not
per-slot, and batches are keyed (task, step), so draining a pool and
reattaching every cursor at a different capacity is bit-identical to an
uninterrupted run. ``RefillExecutor(repack_policy=...)`` performs the
swap between two masked steps; ``launch/sweep.py`` (``adaptive_pack``)
and ``launch/serve.py`` (``adaptive_lanes``) ride the same loop, and
``core/simulate.py`` prices ``repack_latency_s`` so ``compare_modes``
can weigh the policy against a static oracle. DESIGN.md §9.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional

from repro_torch.core.monitor import TenantGauges, live_device_bytes


@dataclasses.dataclass(frozen=True)
class RepackPolicy:
    """Pure decision rule for online pool resizing.

    Knobs (DESIGN.md §9): occupancy thresholds bracket a dead band so a
    healthy pool is never churned; ``grow_factor`` is multiplicative in
    both directions (capacity ladder ~ powers of grow_factor, bounding
    recompiles to a logarithmic count); ``cooldown_steps`` spaces
    voluntary repacks apart — the OOM guard alone may override it;
    ``headroom`` discounts the HBM budget exactly like MemoryAdmission
    so the online frontier and the admission frontier agree.
    """
    grow_occupancy: float = 0.85        # EWMA occupancy to justify growing
    shrink_occupancy: float = 0.45      # EWMA occupancy to justify shrinking
    grow_factor: float = 2.0            # multiplicative resize step
    min_capacity: int = 1
    max_capacity: int = 64
    cooldown_steps: int = 8             # pool steps between voluntary repacks
    headroom: float = 0.9               # fraction of hbm_budget usable
    start_capacity: int = 2             # where adaptive sweeps begin
    repack_latency_s: float = 0.0       # priced per repack (simulator /
                                        # bench cost model)
    max_repacks: int = 32               # thrash bound per run

    def __post_init__(self):
        if not 0 <= self.shrink_occupancy < self.grow_occupancy <= 1:
            raise ValueError(
                f"need 0 <= shrink_occupancy < grow_occupancy <= 1, got "
                f"{self.shrink_occupancy} / {self.grow_occupancy}")
        if self.grow_factor <= 1:
            raise ValueError(f"grow_factor must be > 1: {self.grow_factor}")
        if not 1 <= self.min_capacity <= self.max_capacity:
            raise ValueError(
                f"need 1 <= min_capacity <= max_capacity, got "
                f"{self.min_capacity} / {self.max_capacity}")
        if not 0 < self.headroom <= 1:
            raise ValueError(f"headroom must be in (0, 1]: {self.headroom}")

    def frontier(self, bytes_per_lane: float,
                 hbm_budget: Optional[float]) -> int:
        """Largest capacity the measured footprint allows (the OOM
        frontier, discounted by headroom). Unbounded when either side of
        the ratio is unknown."""
        if not hbm_budget or bytes_per_lane <= 0:
            return self.max_capacity
        return max(0, int((self.headroom * hbm_budget) // bytes_per_lane))

    def propose(self, *, capacity: int, occupancy: float, queued: int,
                active: int, bytes_per_lane: float = 0.0,
                hbm_budget: Optional[float] = None) -> Optional[int]:
        """New capacity, or None to stand pat. Shrink-to-frontier takes
        precedence over everything (it is the OOM guard); growth requires
        saturation AND queued work AND frontier headroom; shrink requires
        sagging occupancy and never cuts below the live lane count."""
        frontier = self.frontier(bytes_per_lane, hbm_budget)
        if frontier < capacity:         # over the frontier: shrink NOW —
            # and ONLY shrink: if min_capacity pins us at or above the
            # current capacity, growing a pool already past the frontier
            # would be worse than standing pat
            new = max(self.min_capacity, min(frontier, self.max_capacity))
            return new if new < capacity else None
        if occupancy >= self.grow_occupancy and queued > 0:
            want = min(int(math.ceil(capacity * self.grow_factor)),
                       active + queued,         # never grow past demand
                       frontier, self.max_capacity)
            return want if want > capacity else None
        if occupancy <= self.shrink_occupancy:
            want = max(self.min_capacity, active,
                       int(math.ceil(capacity / self.grow_factor)))
            return want if want < capacity else None
        return None


@dataclasses.dataclass(frozen=True)
class RepackEvent:
    """One capacity change, for trajectories and postmortems."""
    step: int                           # global pool step it happened after
    old_capacity: int
    new_capacity: int
    occupancy: float                    # EWMA at decision time
    queued: int
    bytes_per_lane: float               # measured (0 = unmeasured)
    reason: str                         # grow|shrink|oom-guard


class RepackController:
    """Stateful telemetry watcher driving one pool's elastic repacking.

    ``observe`` is called once per pool step (the executor wires it);
    ``decide`` is consulted after the retirement phase and returns the
    new capacity when a repack should happen. Occupancy is EWMA-decayed
    through a per-gang GangLaneGauge (core/monitor.py) — pass shared
    ``gauges`` to surface the same numbers in the operator's LLload
    table, or leave None for a private gauge set. ``measure_bytes``
    supplies the live pool footprint in bytes (default: the CUDA
    allocator's count via monitor.live_device_bytes; benches/tests inject
    scripted trajectories); it is divided by current capacity to get the
    per-lane figure the frontier guard and admission reporting use.

    With ``admission`` set (tenancy.MemoryAdmission), every repack event
    records the measured per-lane footprint under ``tenant`` — from then
    on scheduler admission for that tenant consumes the MEASURED number
    instead of the static profile (core/scheduler.py submit).
    """

    def __init__(self, policy: Optional[RepackPolicy] = None, *,
                 hbm_budget: Optional[float] = None,
                 gauges: Optional[TenantGauges] = None,
                 tenant: str = "default", gang: str = "repack",
                 admission=None,
                 measure_bytes: Optional[Callable[[], float]] = None,
                 measure_every: Optional[int] = None):
        self.policy = policy or RepackPolicy()
        self.hbm_budget = hbm_budget
        self.gauges = gauges or TenantGauges()
        self.tenant = tenant
        self.gang = gang
        self.admission = admission
        # the default source is sampled every 8 steps, as the reference's
        # (which walks every live array), unless the caller injects a
        # cheap/scripted source (which defaults to every step)
        if measure_every is None:
            measure_every = 8 if measure_bytes is None else 1
        if measure_every < 1:
            raise ValueError(f"measure_every must be >= 1: {measure_every}")
        self.measure_every = measure_every
        self.measure_bytes = measure_bytes or live_device_bytes
        self.bytes_per_lane: float = 0.0
        self.events: List[RepackEvent] = []
        self._samples = 0
        self._last_repack_step: Optional[int] = None

    # ------------------------------------------------------------ telemetry
    @property
    def repacks(self) -> int:
        return len(self.events)

    @property
    def occupancy(self) -> float:
        """Current EWMA lane occupancy (0 until the first sample)."""
        return self.gauges.gang_gauge(self.gang, self.tenant).occupancy

    def observe(self, step: int, active: int, capacity: int, queued: int):
        """One pool-step sample: occupancy into the per-gang EWMA gauge,
        measured footprint into the frontier guard (every
        ``measure_every``-th sample)."""
        self.gauges.on_lane_sample(self.tenant, self.gang, active, capacity)
        if self._samples % self.measure_every == 0:
            total = float(self.measure_bytes() or 0.0)
            if total > 0 and capacity > 0:
                self.bytes_per_lane = total / capacity
        self._samples += 1

    # ------------------------------------------------------------- decision
    def decide(self, step: int, capacity: int, queued: int,
               active: int) -> Optional[int]:
        """New capacity or None. Voluntary repacks respect the cooldown
        and the thrash bound; the OOM-guard shrink respects neither —
        stepping a pool past the frontier loses every lane at once."""
        pol = self.policy
        frontier = pol.frontier(self.bytes_per_lane, self.hbm_budget)
        over_frontier = frontier < capacity
        if (self._last_repack_step is not None
                and step < self._last_repack_step):
            # the step counter regressed: a NEW executor run is reusing
            # this controller (OOM-backoff retry) — a stale anchor would
            # jam the cooldown shut for its first _last_repack_step steps
            self._last_repack_step = None
        if not over_frontier:
            if self.repacks >= pol.max_repacks:
                return None
            if (self._last_repack_step is not None
                    and step - self._last_repack_step < pol.cooldown_steps):
                return None
        occ = self.occupancy
        new = pol.propose(capacity=capacity, occupancy=occ, queued=queued,
                          active=active, bytes_per_lane=self.bytes_per_lane,
                          hbm_budget=self.hbm_budget)
        if new is None or new == capacity:
            return None
        reason = ("oom-guard" if over_frontier
                  else "grow" if new > capacity else "shrink")
        self._last_repack_step = step
        self.events.append(RepackEvent(
            step=step, old_capacity=capacity, new_capacity=new,
            occupancy=occ, queued=queued,
            bytes_per_lane=self.bytes_per_lane, reason=reason))
        if self.admission is not None and self.bytes_per_lane > 0:
            self.admission.record_measured(self.tenant, self.bytes_per_lane)
        return new

    def capacity_trace(self) -> List[tuple]:
        """[(step, new_capacity)] — the trajectory benches persist."""
        return [(e.step, e.new_capacity) for e in self.events]
