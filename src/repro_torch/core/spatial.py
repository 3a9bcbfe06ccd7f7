"""Spatial slice-sharing: MIG-style node partitioning + a mode planner
(a copy of ``repro.core.spatial``, which is plain Python).

Triples mode time-shares whole chips: co-resident lanes of a packed
program share a chip's MXU and HBM bandwidth, and a memory-bound lane
thrashes its neighbours — the `pack_slowdown × (pack − 1)` tax every
layer of this repo prices. MISO (Li et al., 2022) shows that MIG-style
SPATIAL partitioning recovers that isolation on multi-tenant clusters,
and Xing et al. (2025) argue real clusters need temporal and spatial
sharing COMPOSED, not either/or. This module adds the spatial third
mode (DESIGN.md §10):

  * **Slice model** — ``SliceConfig``: a legal partition of one node
    into slices, each owning a chip fraction and an HBM fraction
    (``legal_configs`` is the MIG-profile analogue: symmetric
    1/2/4/8-way splits plus a half+quarters mix). A slice hosts its own
    pack lanes; lanes in DIFFERENT slices of a node are isolated — no
    cross-slice interference term.

  * **Interference-aware mode planner** — ``ModePlanner.plan_node``:
    given the queued jobs competing for one node (as ``JobProfile``
    rows: measured per-lane HBM footprint from ``MemoryAdmission``,
    interference intensity from ``GangLaneGauge`` occupancy-EWMA
    telemetry or an explicit workload score), predict the makespan of
    every candidate — ``exclusive`` (one lane per chip, serialized),
    ``triples`` lane-packing (max admissible pack, serialized, paying
    `base + intensity` slowdown per extra co-resident), and ``spatial``
    (each legal config: jobs run CONCURRENTLY in isolated slices,
    paying only intra-slice slowdown plus a priced partition-reconfigure
    latency) — and return the cheapest as a ``NodeModePlan``.

The planner is pure arithmetic over its inputs (no clocks, no RNG, no
jax import), so the live scheduler (core/scheduler.py), the event
simulator (core/simulate.py) and the property tests all consume the
SAME object — plans cannot drift between the layers. Admission
arithmetic is delegated to ``tenancy.MemoryAdmission`` (``max_pack``,
``slice_lane_cap``) so the spatial frontier and the admission frontier
agree by construction.

Over-subscription invariant (property-tested): for every planned
placement, the summed chip fractions and HBM fractions per node are
≤ 1.0, each slice hosts at most one job, and a slice's lanes × the
job's per-lane footprint fits ``headroom × slice HBM``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import tenancy as ten
from repro_torch.core import triples as T


# ---------------------------------------------------------------------------
# slice model
# ---------------------------------------------------------------------------

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class SliceSpec:
    """One spatial slice of a node: a chip share and an HBM share."""
    index: int
    chip_frac: float
    hbm_frac: float

    def __post_init__(self):
        if not 0 < self.chip_frac <= 1 or not 0 < self.hbm_frac <= 1:
            raise ValueError(f"slice fractions must be in (0, 1]: {self}")


@dataclasses.dataclass(frozen=True)
class SliceConfig:
    """A legal partition of one node (the MIG-profile analogue).

    Fractions must sum to ≤ 1.0 on both axes — a configuration can
    deliberately leave capacity unpartitioned, but can never promise
    more chips or HBM than the node has.
    """
    name: str
    slices: Tuple[SliceSpec, ...]

    def __post_init__(self):
        if not self.slices:
            raise ValueError("a SliceConfig needs at least one slice")
        if sum(s.chip_frac for s in self.slices) > 1 + _EPS:
            raise ValueError(f"chip fractions of {self.name} exceed 1.0")
        if sum(s.hbm_frac for s in self.slices) > 1 + _EPS:
            raise ValueError(f"HBM fractions of {self.name} exceed 1.0")
        if [s.index for s in self.slices] != list(range(len(self.slices))):
            raise ValueError(f"slice indices of {self.name} must be dense")

    def __len__(self) -> int:
        return len(self.slices)

    def hbm_bytes(self, index: int, node_spec: T.NodeSpec) -> float:
        """HBM budget of slice ``index`` on a node of ``node_spec``."""
        return self.slices[index].hbm_frac * node_spec.hbm_per_node

    def chips_of(self, index: int, node_spec: T.NodeSpec) -> Tuple[int, ...]:
        """Chip ids slice ``index`` overlaps. Slices tile the node's chips
        in index order; a fractional share rounds OUTWARD, so a half-chip
        slice still names the chip it lives on (two half-chip slices of
        chip 0 both return ``(0,)`` — their HBM fractions, not the chip
        id, are what keeps them apart)."""
        cpn = node_spec.chips_per_node
        start = sum(s.chip_frac for s in self.slices[:index]) * cpn
        end = start + self.slices[index].chip_frac * cpn
        first = int(math.floor(start + _EPS))
        last = max(first + 1, int(math.ceil(end - _EPS)))
        return tuple(range(first, min(last, cpn)) or (cpn - 1,))


def legal_configs(max_ways: int = 8) -> Tuple[SliceConfig, ...]:
    """The legal partition table: symmetric 1/2/4/8-way equal splits plus
    an asymmetric half + two quarters (for one big co-tenant beside two
    small ones). ``max_ways`` trims the table for small nodes."""
    configs: List[SliceConfig] = []
    ways = 1
    while ways <= max_ways:
        frac = 1.0 / ways
        configs.append(SliceConfig(
            name=f"{ways}w",
            slices=tuple(SliceSpec(i, frac, frac) for i in range(ways))))
        ways *= 2
    if max_ways >= 4:
        configs.append(SliceConfig(
            name="1h2q", slices=(SliceSpec(0, 0.5, 0.5),
                                 SliceSpec(1, 0.25, 0.25),
                                 SliceSpec(2, 0.25, 0.25))))
    return tuple(configs)


# ---------------------------------------------------------------------------
# planner inputs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class JobProfile:
    """The planner's view of one queued job competing for a node.

    ``bytes_per_lane`` should be ``MemoryAdmission.effective_bytes`` —
    the measured footprint when telemetry has one, the static profile
    otherwise. ``intensity`` is the interference score in [0, 1]: how
    hard a co-resident lane of this job thrashes a neighbour's HBM/SM
    share (0 = compute-bound and polite, 1 = fully memory-bound). The
    default live source is the job owner's gang occupancy-EWMA
    (``monitor.TenantGauges.user_occupancy``); workloads that know
    their phase behaviour pass an explicit score, and jobs whose
    compiled program has been roofline-profiled get a MEASURED score
    via ``measured_interference``. ``kind`` names the job family
    ("train"/"serve"/"sweep"/...) so measured intensity can be shared
    across jobs of one family (admission key ``kind:<kind>``).
    """
    job_id: int
    user: str = ""
    n_tasks: int = 1
    bytes_per_lane: float = 0.0
    intensity: float = 0.0
    task_s: float = 1.0                 # est seconds (or rounds) per task
    want_lanes: int = 0                 # requested concurrency (0 = n_tasks)
    kind: str = ""                      # job family for measured intensity

    def __post_init__(self):
        if not 0 <= self.intensity <= 1:
            raise ValueError(f"intensity must be in [0, 1]: {self}")

    @property
    def demand(self) -> int:
        return self.want_lanes if self.want_lanes > 0 else max(1, self.n_tasks)


@dataclasses.dataclass(frozen=True)
class SlicePlacement:
    """One job's grant inside one slice of the planned node."""
    job_id: int
    slice_index: int
    lanes: int
    chip_frac: float
    hbm_frac: float


@dataclasses.dataclass(frozen=True)
class NodeModePlan:
    """``ModePlanner.plan_node``'s verdict for one node + job group."""
    mode: str                           # exclusive|triples|spatial
    config: Optional[SliceConfig]       # set iff mode == "spatial"
    placements: Tuple[SlicePlacement, ...]
    costs: Dict[str, float]             # predicted makespan per candidate
    reconfig_s: float = 0.0             # priced partition-reconfigure cost

    def slices_of(self, job_id: int) -> Tuple[int, ...]:
        return tuple(p.slice_index for p in self.placements
                     if p.job_id == job_id)

    def lanes_of(self, job_id: int) -> int:
        return sum(p.lanes for p in self.placements if p.job_id == job_id)

    def chip_frac_of(self, job_id: int) -> float:
        return sum(p.chip_frac for p in self.placements
                   if p.job_id == job_id)


# ---------------------------------------------------------------------------
# the interference-aware mode planner
# ---------------------------------------------------------------------------

class ModePlanner:
    """Choose exclusive / triples / spatial per node, per dispatch round.

    ``interference`` is the pluggable score: a callable mapping a
    ``JobProfile`` to an intensity in [0, 1] that OVERRIDES the
    profile's own value (e.g. a gauges-backed EWMA reader built with
    ``ewma_interference``); None trusts the profiles. ``base_slowdown``
    is the polite co-residency tax (the simulator's ``pack_slowdown``),
    to which a lane's intensity is added — a memory-bound lane at
    intensity 0.6 costs each co-resident `base + 0.6` per wave.
    ``reconfig_latency_s`` prices one partition reconfiguration; spatial
    must win by MORE than the reconfigure to be chosen.
    """

    def __init__(self, node_spec: Optional[T.NodeSpec] = None,
                 admission: Optional[ten.MemoryAdmission] = None, *,
                 base_slowdown: float = 0.15,
                 reconfig_latency_s: float = 0.0,
                 max_pack_per_chip: int = 8,
                 min_grant_frac: float = 0.5,
                 configs: Optional[Sequence[SliceConfig]] = None,
                 interference: Optional[Callable[[JobProfile],
                                                 float]] = None):
        self.node_spec = node_spec or T.NodeSpec()
        self.admission = admission or ten.MemoryAdmission(self.node_spec)
        if base_slowdown < 0:
            raise ValueError(f"base_slowdown must be >= 0: {base_slowdown}")
        if max_pack_per_chip < 1:
            raise ValueError(
                f"max_pack_per_chip must be >= 1: {max_pack_per_chip}")
        if not 0 <= min_grant_frac <= 1:
            raise ValueError(
                f"min_grant_frac must be in [0, 1]: {min_grant_frac}")
        self.base_slowdown = base_slowdown
        self.reconfig_latency_s = reconfig_latency_s
        self.max_pack_per_chip = max_pack_per_chip
        self.min_grant_frac = min_grant_frac
        self.configs = tuple(configs if configs is not None
                             else legal_configs())
        self.interference = interference

    # ------------------------------------------------------------- helpers
    @property
    def max_group(self) -> int:
        """Most jobs one partitioned node can host (widest legal config)."""
        return max(len(c) for c in self.configs)

    @staticmethod
    def group_size(eligible: int, free_nodes: int, max_group: int) -> int:
        """How many queued jobs the spatial phase should plan as ONE
        node's group — the policy shared verbatim by the live scheduler
        and the simulator so their dispatch decisions cannot drift.
        Single-job planning by default (partition a node to isolate one
        job's own memory-bound lanes); co-tenant grouping only when ≥ 2
        jobs are stranded with no free node in sight — a freeing
        neighbour node is the better deal for a merely-waiting pair.
        ``max_group`` is the caller's current ceiling (demoted to 1
        after a group veto so single-job isolation still gets its try).
        """
        stranded = eligible - free_nodes
        if max_group < 2 or stranded < 2:
            return 1
        return min(max_group, stranded + 1)

    def _intensity(self, p: JobProfile) -> float:
        if self.interference is not None:
            return min(1.0, max(0.0, float(self.interference(p))))
        return p.intensity

    def _slowdown(self, lanes_per_chip: int, intensity: float) -> float:
        """Per-wave slowdown of ``lanes_per_chip`` co-residents on one
        chip (or one slice): 1 at isolation, `base + intensity` per
        extra neighbour — the interference-aware generalization of the
        simulator's flat ``pack_slowdown``."""
        return 1.0 + max(0, lanes_per_chip - 1) * (self.base_slowdown
                                                   + intensity)

    def triples_pack(self, p: JobProfile) -> int:
        """The pack the triples path would grant this job: its demand,
        capped by the admission frontier and the planner's lane bound."""
        cpn = self.node_spec.chips_per_node
        cap = min(self.admission.max_pack(p.bytes_per_lane),
                  self.max_pack_per_chip)
        want = math.ceil(p.demand / cpn)
        return max(1, min(cap, want))

    # ------------------------------------------------- candidate costing
    def _serial_cost(self, profiles: Sequence[JobProfile],
                     pack_of: Callable[[JobProfile], int]) -> float:
        """Makespan of the jobs run one-after-another on the whole node
        (the whole-node single-owner policy serializes them)."""
        cpn = self.node_spec.chips_per_node
        total = 0.0
        for p in profiles:
            pack = pack_of(p)
            lanes = pack * cpn
            waves = math.ceil(p.n_tasks / lanes)
            total += waves * p.task_s * self._slowdown(pack,
                                                       self._intensity(p))
        return total

    def _spatial_assign(self, profiles: Sequence[JobProfile],
                        config: SliceConfig
                        ) -> Optional[List[SlicePlacement]]:
        """Assign jobs to slices of ``config``: largest footprint onto
        the largest-HBM slice first (mandatory — every job gets one
        slice), leftover slices to the jobs with the most unmet demand,
        then each job's lanes spread EVENLY over its slices (balance
        minimizes the worst intra-slice co-residency, which is the whole
        point of isolating). None when any job cannot fit a single lane
        in its slice (the admission veto, ``MemoryAdmission.admit_slice``).
        """
        if len(profiles) > len(config.slices):
            return None
        order = sorted(profiles, key=lambda p: (-p.bytes_per_lane, p.job_id))
        free = sorted(config.slices, key=lambda s: (-s.hbm_frac, s.index))
        owned: Dict[int, List[SliceSpec]] = {}

        def cap(p: JobProfile, sl: SliceSpec) -> int:
            return min(self.slice_lane_bound(sl),
                       self.admission.slice_lane_cap(
                           p.bytes_per_lane,
                           config.hbm_bytes(sl.index, self.node_spec)))

        for p in order:                 # one slice per job, mandatory
            sl = free.pop(0)
            if cap(p, sl) < 1:
                return None             # slice HBM below the footprint
            owned[p.job_id] = [sl]
        by_id = {p.job_id: p for p in order}

        def crowding(jid: int) -> float:
            """Lanes per owned slice if demand were spread evenly — the
            co-residency an extra slice would dilute."""
            return by_id[jid].demand / len(owned[jid])

        while free:                     # spare slices: dilute the worst
            jid = max(owned, key=lambda j: (crowding(j), -j))
            if crowding(jid) <= 1.0 or cap(by_id[jid], free[0]) < 1:
                break                   # everyone fully isolated already
            owned[jid].append(free.pop(0))
        placements: List[SlicePlacement] = []
        for p in order:                 # balanced lanes over owned slices
            slices = sorted(owned[p.job_id], key=lambda s: s.index)
            remaining = p.demand
            for i, sl in enumerate(slices):
                budget = config.hbm_bytes(sl.index, self.node_spec)
                lanes = min(cap(p, sl),
                            math.ceil(remaining / (len(slices) - i)))
                if lanes < 1:
                    if i == 0:          # a job must land somewhere
                        lanes = 1
                    else:
                        continue
                if not self.admission.admit_slice(p.bytes_per_lane, lanes,
                                                  budget).admitted:
                    return None
                placements.append(SlicePlacement(
                    job_id=p.job_id, slice_index=sl.index, lanes=lanes,
                    chip_frac=sl.chip_frac, hbm_frac=sl.hbm_frac))
                remaining -= lanes
            granted = p.demand - remaining
            if granted < math.ceil(self.min_grant_frac * p.demand):
                # under-provisioned grant: the job would hold tiny slices
                # for its whole (stretched) run while capacity frees
                # elsewhere — the MIG-rigidity failure mode. Veto the
                # config; temporal modes or a smaller group must serve it.
                return None
        return placements

    def slice_lane_bound(self, sl: SliceSpec) -> int:
        """Compute-side lane bound of one slice: its chip share scaled by
        the planner's per-chip lane bound (the HBM side is
        ``MemoryAdmission.slice_lane_cap``)."""
        cpn = self.node_spec.chips_per_node
        return max(1, int(math.ceil(sl.chip_frac * cpn
                                    * self.max_pack_per_chip)))

    def slice_slowdown(self, pl: SlicePlacement, intensity: float) -> float:
        """Per-wave slowdown inside one slice. A slice pays the BASE
        compute-sharing tax at its per-chip-equivalent lane density
        (``lanes / (chip_frac × chips)`` — partitioning does not mint
        compute) and the intensity term only among the lanes INSIDE the
        slice: the slice's HBM/bandwidth share is hard-partitioned, so a
        memory-bound lane in another slice cannot thrash it. Shrinking
        the interference domain is the entire case for the spatial mode
        — and why, at zero intensity, spatial only ties triples and the
        tie-break keeps the temporal mode."""
        cpn = self.node_spec.chips_per_node
        n_eq = pl.lanes / max(_EPS, pl.chip_frac * cpn)
        return (1.0 + max(0.0, n_eq - 1.0) * self.base_slowdown
                + max(0, pl.lanes - 1) * intensity)

    def _spatial_cost(self, profiles: Sequence[JobProfile],
                      placements: Sequence[SlicePlacement]) -> float:
        """Makespan of the jobs run CONCURRENTLY in isolated slices: the
        slowest job, paying only intra-slice slowdown, plus the priced
        partition reconfiguration."""
        worst = 0.0
        for p in profiles:
            mine = [pl for pl in placements if pl.job_id == p.job_id]
            lanes = sum(pl.lanes for pl in mine)
            waves = math.ceil(p.n_tasks / lanes)
            worst = max(worst, waves * p.task_s
                        * max(self.slice_slowdown(pl, self._intensity(p))
                              for pl in mine))
        return worst + self.reconfig_latency_s

    # --------------------------------------------------------------- plan
    def plan_node(self, profiles: Sequence[JobProfile]) -> NodeModePlan:
        """Pick the cheapest mode for one node and this job group.

        Ties break toward the earlier candidate in (exclusive, triples,
        spatial) order — spatial must STRICTLY beat the temporal modes,
        so a workload that gains nothing from isolation never pays a
        partition reconfigure."""
        if not profiles:
            raise ValueError("plan_node needs at least one JobProfile")
        costs: Dict[str, float] = {
            "exclusive": self._serial_cost(profiles, lambda p: 1),
            "triples": self._serial_cost(profiles, self.triples_pack),
        }
        best_cfg: Optional[SliceConfig] = None
        best_pl: Tuple[SlicePlacement, ...] = ()
        for cfg in self.configs:
            pl = self._spatial_assign(profiles, cfg)
            if pl is None:
                continue
            cost = self._spatial_cost(profiles, pl)
            key = f"spatial:{cfg.name}"
            costs[key] = cost
            if best_cfg is None or cost < costs[f"spatial:{best_cfg.name}"]:
                best_cfg, best_pl = cfg, tuple(pl)
        mode = "exclusive"
        best = costs["exclusive"]
        if costs["triples"] < best:
            mode, best = "triples", costs["triples"]
        if best_cfg is not None and costs[f"spatial:{best_cfg.name}"] < best:
            return NodeModePlan(mode="spatial", config=best_cfg,
                                placements=best_pl, costs=costs,
                                reconfig_s=self.reconfig_latency_s)
        return NodeModePlan(mode=mode, config=None, placements=(),
                            costs=costs)


# ---------------------------------------------------------------------------
# shared phase policy: which queued jobs may the spatial phase consider
# ---------------------------------------------------------------------------

def select_spatial_group(pending: Sequence[ten.PendingJob],
                         free_nodes: int,
                         held: Dict[str, int],
                         quota_of: Callable[[str], Optional[int]],
                         max_group: int,
                         skipped: Optional[set] = None,
                         eligible_fn: Optional[Callable[[ten.PendingJob],
                                                        bool]] = None
                         ) -> Tuple[List[ten.PendingJob], int]:
    """The spatial phase's job-selection policy, shared VERBATIM by the
    live scheduler and the simulator so their dispatch decisions cannot
    drift. Returns ``(group, avail)``: the fair-share-ordered jobs to
    plan as one node's group, and the free nodes actually available to
    a partition.

    Three rules:

    * **EASY reservation holds** — walking the queue in fair-share
      order, a wider job that FITS the remaining free nodes pre-claims
      them (it will dispatch whole-node this same round); the first
      wider job that does NOT fit is a blocked head, and nothing behind
      it may slice-bypass its reservation.
    * **quota holds** — a tenant at ``max_nodes`` cannot acquire
      capacity through slices (a partitioned node counts as one held
      node per user holding any slice on it, so same-user co-residents
      in ONE group cost one node together).
    * **group size** — ``ModePlanner.group_size``: single-job isolation
      by default, co-tenant grouping only when ≥ 2 jobs are stranded.
    """
    skipped = skipped or set()
    claimed = 0
    eligible: List[ten.PendingJob] = []
    for pj in pending:
        if pj.id in skipped or (eligible_fn is not None
                                and not eligible_fn(pj)):
            continue
        if pj.n_nodes > 1:
            if pj.n_nodes <= free_nodes - claimed:
                claimed += pj.n_nodes
                continue
            break                       # blocked head: reservation wins
        cap = quota_of(pj.user)
        if cap is not None and held.get(pj.user, 0) + 1 > cap:
            continue
        eligible.append(pj)
    avail = free_nodes - claimed
    if avail < 1 or not eligible:
        return [], avail
    k = ModePlanner.group_size(len(eligible), avail, max_group)
    return eligible[:k], avail


# ---------------------------------------------------------------------------
# telemetry-backed interference source
# ---------------------------------------------------------------------------

def ewma_interference(gauges, floor: float = 0.0
                      ) -> Callable[[JobProfile], float]:
    """Build a pluggable interference source from live gauge telemetry.

    Returns a callable for ``ModePlanner(interference=...)`` that scores
    a profile by the occupancy-EWMA of its owner's busiest gang
    (``monitor.TenantGauges.user_occupancy`` — saturated lanes are the
    lanes that contend for HBM bandwidth), never below the profile's own
    declared intensity or ``floor``. Duck-typed so this module stays
    import-light (no jax at load)."""

    def score(p: JobProfile) -> float:
        occ = float(gauges.user_occupancy(p.user)) if p.user else 0.0
        return min(1.0, max(p.intensity, occ, floor))

    return score


def measured_interference(admission, gauges=None, floor: float = 0.0
                          ) -> Callable[[JobProfile], float]:
    """Roofline-measured interference source, composed with the EWMA.

    ``admission`` is a ``MemoryAdmission`` whose ``measured_intensity``
    holds recorded memory-bound fractions (``IntensityProfile``, recorded
    at first dispatch). For a profile whose job family (key
    ``kind:<kind>``) or owner (key ``<user>``) has a measurement, that
    measurement REPLACES the occupancy proxy: a busy but compute-bound
    tenant stops being priced as thrashy, and a quiet memory-bound one
    stops hiding behind a cold EWMA. The profile's declared intensity and
    ``floor`` still lower-bound the score either way. With no measurement
    the score is exactly ``ewma_interference``'s (or the declared
    intensity when no gauges are wired), so disabling the signal — not
    recording anything — reproduces the default planner bit-for-bit.
    """

    def score(p: JobProfile) -> float:
        m = admission.measured_intensity(f"kind:{p.kind}") if p.kind else None
        if m is None and p.user:
            m = admission.measured_intensity(p.user)
        if m is not None:
            return min(1.0, max(p.intensity, float(m), floor))
        occ = (float(gauges.user_occupancy(p.user))
               if (gauges is not None and p.user) else 0.0)
        return min(1.0, max(p.intensity, occ, floor))

    return score
