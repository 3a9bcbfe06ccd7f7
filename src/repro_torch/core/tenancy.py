"""Multi-tenant fair-share scheduling with memory-aware admission control
(a copy of ``repro.core.tenancy``, which is plain Python; only its import
of ``triples`` changed).

The paper's triples mode exists because the LLSC whole-node policy strands
capacity when tasks are small — but the seed scheduler still served ONE
user at a time, so the multi-tenant utilization story (the paper's actual
economic motivation, §I) was unmodeled. This module adds the three pieces
a shared facility needs (DESIGN.md §4):

  * fair-share accounting — per-tenant decayed usage over share weight
    orders the pending queue, so a light user is not starved by a heavy
    one (the LLSC "fairshare" knob);
  * a pending-job queue with FIFO + EASY backfill — the head-of-line gang
    reserves capacity at its *shadow time* (earliest instant enough nodes
    free up); smaller triples jobs may jump the queue only if they fit in
    the spare nodes at that instant or finish before it, so backfill can
    NEVER delay the waiting gang;
  * memory-aware admission control — the per-lane HBM footprint
    (packing.memory_per_lane) caps pack_factor per chip BEFORE dispatch,
    replacing the paper's observed failure mode (21/48 tasks dead on CUDA
    OOM) with an up-front admit/clamp/reject decision.

Everything here is pure accounting over ``ClusterState`` — the scheduler
(core/scheduler.py) and the event-driven simulator (core/simulate.py) both
consume it, so live dispatch and replayed workloads share one policy.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import math
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple, Union)

from repro_torch.core import triples as T


# ---------------------------------------------------------------------------
# fair-share accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Policy knobs for one tenant."""
    share: float = 1.0                  # fair-share weight (bigger = more)
    max_nodes: Optional[int] = None     # hard cap on concurrently held nodes

    def __post_init__(self):
        if self.share <= 0:
            raise ValueError(f"share must be positive, got {self.share}")


_DEFAULT_QUOTA = TenantQuota()          # shared default: quota() sits on the
                                        # per-event dispatch path, and a fresh
                                        # TenantQuota per lookup was the top
                                        # line of the 10^6-event profile


class FairShareAccountant:
    """Per-tenant normalized usage; orders the queue.

    Usage is node-seconds (simulator) or node-rounds (live cooperative
    scheduler), exponentially decayed with ``half_life`` so old consumption
    stops counting against a tenant — the standard Slurm/LLSC decay model.
    Priority key is ``usage / share``: lowest goes first, FIFO breaks ties.
    """

    def __init__(self, quotas: Optional[Dict[str, TenantQuota]] = None,
                 half_life: Optional[float] = None):
        self.quotas = dict(quotas or {})
        self.half_life = half_life
        self._usage: Dict[str, float] = {}
        self._last_decay: float = 0.0

    def quota(self, user: str) -> TenantQuota:
        return self.quotas.get(user, _DEFAULT_QUOTA)

    def usage(self, user: str) -> float:
        return self._usage.get(user, 0.0)

    def decay_to(self, now: float):
        """Apply exponential decay up to ``now`` (monotone clock)."""
        if self.half_life is None or now <= self._last_decay:
            self._last_decay = max(self._last_decay, now)
            return
        factor = 0.5 ** ((now - self._last_decay) / self.half_life)
        for u in self._usage:
            self._usage[u] *= factor
        self._last_decay = now

    def charge(self, user: str, node_time: float):
        """Record ``node_time`` node-seconds/rounds of consumption."""
        self._usage[user] = self._usage.get(user, 0.0) + node_time

    def priority_key(self, user: str, submit_seq: int) -> Tuple[float, int]:
        """Sort key: (normalized usage, submit order). Lower = sooner."""
        return (self.usage(user) / self.quota(user).share, submit_seq)

    def norm_usage(self, user: str) -> float:
        """Decayed usage over share weight — the fair-share coordinate."""
        return self.usage(user) / self.quota(user).share

    def state_dict(self) -> Dict[str, object]:
        """Mutable accounting state for control-plane snapshots
        (core/controlplane.py). Quotas/half_life are configuration, not
        state: a recovered plane gets them from its constructor."""
        return {"usage": dict(self._usage), "last_decay": self._last_decay}

    def load_state(self, state: Dict[str, object]):
        self._usage = {u: float(v) for u, v in state["usage"].items()}
        self._last_decay = float(state["last_decay"])


# ---------------------------------------------------------------------------
# fair-share preemption policy (DESIGN.md §8)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PreemptionPolicy:
    """When may a running gang be checkpointed to yield its nodes?

    The queue-only scheduler lets a large sweep hold its whole-node
    allocation until every task completes, starving small interactive
    jobs (the MISO motivation). Under this policy a gang is PREEMPTIBLE
    when (a) a queued job has waited past ``wait_threshold`` (rounds on
    the live scheduler, virtual seconds in the simulator) and (b) the
    gang owner's decayed normalized usage exceeds the waiter's by the
    ``overshare`` factor — i.e. the victim is over its fair share
    relative to the starved tenant, so preempting it moves the cluster
    TOWARD the fair-share allocation rather than churning peers.

    Victim choice minimizes ``remaining node-work / over-share``: among
    eligible gangs, prefer the one with the least work left to disturb,
    discounted by how far over share its owner is (a heavy over-sharer
    with little remaining work is the cheapest correction). Checkpoint
    thrash is bounded two ways: a job is preempted at most
    ``max_preemptions`` times, and each resume pays ``resume_overhead``
    (checkpoint restore + repack) so the policy's own benefit must cover
    it.

    Elastic resize: a preempted gang re-enters the queue with
    ``min_nodes = ceil(elastic_min_frac × nnode)``, so it may resume on
    PARTIAL capacity (a preempted 8-node sweep continues on 4 free
    nodes instead of waiting for all 8 — lane state is per-task, not
    per-slot, so the narrower gang replans the remaining work without
    recomputation).
    """
    wait_threshold: float = 4.0
    overshare: float = 1.0
    max_preemptions: int = 1
    elastic_min_frac: float = 0.5
    resume_overhead: float = 0.0

    def min_nodes(self, nnode: int) -> int:
        """Narrowest width a preempted gang may resume at."""
        return max(1, math.ceil(nnode * self.elastic_min_frac))

    @staticmethod
    def _norm(acct: FairShareAccountant, user: str,
              accrued: Optional[Dict[str, float]]) -> float:
        """Share-normalized usage INCLUDING in-flight consumption.

        The accountant only charges node-time at release, so a gang that
        has held the whole cluster for an hour still shows zero decayed
        usage while it runs — exactly the tenant preemption exists to
        police. ``accrued`` maps user -> node-time held-but-uncharged
        (rounds on the live scheduler, seconds in the simulator)."""
        extra = accrued.get(user, 0.0) if accrued else 0.0
        return (acct.usage(user) + extra) / acct.quota(user).share

    def eligible(self, acct: FairShareAccountant, waiter_user: str,
                 victim_user: str,
                 accrued: Optional[Dict[str, float]] = None) -> bool:
        """Is ``victim_user``'s gang fair game for ``waiter_user``?"""
        if victim_user == waiter_user:
            return False
        v = self._norm(acct, victim_user, accrued)
        return v > 0 and v > self.overshare * self._norm(
            acct, waiter_user, accrued)

    def choose_victim(self, acct: FairShareAccountant, waiter_user: str,
                      candidates: Sequence[Tuple[int, str, float, int]],
                      accrued: Optional[Dict[str, float]] = None
                      ) -> Optional[int]:
        """Pick the victim gang for a starved waiter, or None.

        ``candidates`` rows are ``(victim_id, user, remaining_node_work,
        times_preempted)``. Deterministic: score ties break on id.
        """
        w = self._norm(acct, waiter_user, accrued)
        best: Optional[Tuple[float, int]] = None
        for vid, user, remaining, count in candidates:
            if count >= self.max_preemptions:
                continue
            if not self.eligible(acct, waiter_user, user, accrued):
                continue
            over = (self._norm(acct, user, accrued) + 1e-12) / (w + 1e-12)
            score = remaining / over
            if best is None or (score, vid) < best:
                best = (score, vid)
        return best[1] if best is not None else None


# ---------------------------------------------------------------------------
# memory-aware admission control
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    admitted: bool
    pack_factor: int                    # granted lanes per chip (0 if rejected)
    max_pack: int                       # cap implied by the footprint
    reason: str = ""


class MemoryAdmission:
    """Cap pack_factor per chip from the per-lane HBM footprint.

    ``bytes_per_lane`` is what ``packing.memory_per_lane`` reports for the
    compiled single-lane step (args + temps + outputs). The cap is

        max_pack = floor(headroom * hbm_per_chip / bytes_per_lane)

    so admission happens before dispatch instead of relying on OOM backoff
    after the fact (on TPU a packed-program OOM kills ALL lanes at once,
    so the predictive guard is mandatory — DESIGN.md §4.3).
    """

    def __init__(self, node_spec: Optional[T.NodeSpec] = None,
                 headroom: float = 0.9):
        if not 0 < headroom <= 1:
            raise ValueError(f"headroom must be in (0, 1], got {headroom}")
        self.node_spec = node_spec or T.NodeSpec()
        self.headroom = headroom
        self.measured: Dict[str, float] = {}    # key -> measured B/lane
        self.intensity: Dict[str, float] = {}   # key -> memory-bound frac

    # -------------------------------------------- measured footprints
    def record_measured(self, key: str, bytes_per_lane: float):
        """Record a MEASURED per-lane footprint for ``key`` (a tenant or
        job family). Repack events report these (core/repack.py): the
        live telemetry of a running pool beats the compile-time profile,
        which goes stale the moment the workload changes phase."""
        if key and bytes_per_lane > 0:
            self.measured[key] = float(bytes_per_lane)

    def effective_bytes(self, key: str, static_bytes: float) -> float:
        """The footprint admission should trust for ``key``.

        Measurements are keyed PER TENANT while static profiles are per
        job, so a measurement may come from a different (smaller)
        workload of the same tenant — trusting it downward would wave an
        over-footprint gang straight into the paper's 21/48 OOM. The
        measurement therefore only TIGHTENS admission (measured larger
        than the profile: the live footprint grew past what the compiler
        predicted) or fills in an unknown profile (``static_bytes <=
        0``); a pessimistic static profile is never relaxed by a
        measurement of unverifiable provenance."""
        m = self.measured.get(key, 0.0) if key else 0.0
        if m <= 0:
            return static_bytes
        if static_bytes <= 0:
            return m
        return max(m, static_bytes)

    # -------------------------------------------- measured intensity
    def record_intensity(self, key: str, memory_bound_frac: float):
        """Record a roofline-MEASURED memory-bound fraction for ``key``
        (``IntensityProfile.memory_bound_frac``, recorded by the
        scheduler at a job's first dispatch the same way repack events
        call ``record_measured``). Unlike footprints this is not a safety
        bound but a planning signal, and it is exact for the compiled
        program it came from — so the newest measurement simply replaces
        the old (a job family that changes phase re-measures both ways)."""
        if key and memory_bound_frac >= 0.0:
            self.intensity[key] = min(1.0, float(memory_bound_frac))

    def measured_intensity(self, key: str) -> Optional[float]:
        """The measured memory-bound fraction for ``key``, or None when
        nothing was ever recorded (callers fall back to the
        occupancy-EWMA proxy — spatial.measured_interference)."""
        if not key:
            return None
        return self.intensity.get(key)

    def state_dict(self) -> Dict[str, object]:
        """Mutable measurement state for control-plane snapshots
        (core/controlplane.py) — the footprints and intensities learned
        from live telemetry, which static config cannot rebuild."""
        return {"measured": dict(self.measured),
                "intensity": dict(self.intensity)}

    def load_state(self, state: Dict[str, object]):
        self.measured = {k: float(v)
                         for k, v in state["measured"].items()}
        self.intensity = {k: float(v)
                          for k, v in state["intensity"].items()}

    def max_pack(self, bytes_per_lane: float) -> int:
        """Largest lanes-per-chip count the footprint allows (0 = none)."""
        if bytes_per_lane <= 0:
            return 10**9                # unknown footprint: unconstrained
        budget = self.headroom * self.node_spec.hbm_per_chip
        return int(budget // bytes_per_lane)

    def _over_budget_reason(self, bytes_per_lane: float) -> str:
        return (f"one lane needs {bytes_per_lane/1e6:.1f} MB > "
                f"{self.headroom:.0%} of "
                f"{self.node_spec.hbm_per_chip/1e6:.1f} MB/chip; "
                f"increase NTPP")

    def require_fits(self, bytes_per_lane: float) -> int:
        """max_pack, raising MemoryError when even one lane cannot fit."""
        cap = self.max_pack(bytes_per_lane)
        if cap < 1:
            raise MemoryError(self._over_budget_reason(bytes_per_lane))
        return cap

    def admit(self, trip: T.Triples, bytes_per_lane: float) -> AdmissionDecision:
        """Admit/reject the triples' implied pack_factor as requested."""
        cap = self.max_pack(bytes_per_lane)
        want = trip.pack_factor(self.node_spec)
        if cap < 1:
            return AdmissionDecision(
                False, 0, cap, self._over_budget_reason(bytes_per_lane))
        if want > cap:
            return AdmissionDecision(
                False, 0, cap,
                f"pack_factor {want} exceeds footprint cap {cap}")
        return AdmissionDecision(True, want, cap, "fits")

    # ------------------------------------------------ spatial slices (§10)
    def slice_lane_cap(self, bytes_per_lane: float,
                       slice_hbm_bytes: float) -> int:
        """Largest lane count ``bytes_per_lane`` admits inside ONE spatial
        slice of ``slice_hbm_bytes`` HBM — the per-slice analogue of
        ``max_pack``, same headroom, so the spatial planner's frontier
        and whole-chip admission agree by construction (DESIGN.md §10)."""
        if bytes_per_lane <= 0:
            return 10**9                # unknown footprint: unconstrained
        return int((self.headroom * slice_hbm_bytes) // bytes_per_lane)

    def admit_slice(self, bytes_per_lane: float, lanes: int,
                    slice_hbm_bytes: float) -> AdmissionDecision:
        """Veto a slice grant whose HBM fraction is below the job's
        (measured) footprint: a slice that cannot hold even ONE lane is
        rejected outright, and a grant of more lanes than the slice's
        budget admits is rejected — spatial isolation must never become
        the new 21/48 OOM path."""
        cap = self.slice_lane_cap(bytes_per_lane, slice_hbm_bytes)
        if cap < 1:
            return AdmissionDecision(
                False, 0, cap,
                f"slice HBM {slice_hbm_bytes/1e6:.0f} MB at "
                f"{self.headroom:.0%} headroom is below the per-lane "
                f"footprint {bytes_per_lane/1e6:.1f} MB; use a bigger "
                f"slice or triples lanes")
        if lanes > cap:
            return AdmissionDecision(
                False, 0, cap,
                f"{lanes} lanes exceed the slice cap {cap}")
        return AdmissionDecision(True, lanes, cap, "fits")

    def admit_colocated(self, packs: Sequence[int],
                        bytes_per_lanes: Sequence[float]) -> bool:
        """May these jobs co-reside on one gang's chips? True when their
        combined per-chip lane count fits the budget, conservatively
        pricing every lane at the LARGEST per-lane footprint among them.
        Jobs with unknown footprints (all <= 0) are unconstrained. Used
        by lane-level backfill — live scheduler and simulator share this
        one formula so their decisions cannot drift apart (DESIGN.md §7).
        """
        bpl = max(bytes_per_lanes, default=0.0)
        if bpl <= 0:
            return True
        return sum(packs) <= self.max_pack(bpl)

    def clamp(self, trip: T.Triples, bytes_per_lane: float) -> T.Triples:
        """Largest admissible triples ≤ the request (shrink NPPN).

        Raises MemoryError when even a single lane per chip cannot fit.
        """
        cap = self.require_fits(bytes_per_lane)
        if trip.pack_factor(self.node_spec) <= cap:
            return trip
        cpn = self.node_spec.chips_per_node
        nppn = max(1, (cap * cpn) // trip.ntpp)
        return T.Triples(nnode=trip.nnode, nppn=nppn, ntpp=trip.ntpp)


# ---------------------------------------------------------------------------
# pending-job queue: fair-share order, FIFO head reservation, EASY backfill
# ---------------------------------------------------------------------------

@dataclasses.dataclass(slots=True)
class PendingJob:
    """One gang job waiting for dispatch. ``slots`` keeps the per-job
    footprint flat — a bursty 10^6-event trace can hold tens of thousands
    of these queued at once."""
    id: int
    user: str
    n_nodes: int
    submit_seq: int
    submit_t: float = 0.0
    est_duration: float = 0.0           # rounds (live) or seconds (sim)
    bytes_per_lane: float = 0.0
    n_slots: int = 0                    # lanes the job wants (0 = unknown —
                                        # such a job never lane-backfills)
    n_tasks: int = 0                    # work units (width-rescales est)
    min_nodes: int = 0                  # 0 = rigid; >0 = elastic: the job
                                        # may dispatch on any width in
                                        # [min_nodes, n_nodes] (preempted
                                        # gangs resuming on partial capacity)
    granted_nodes: int = 0              # width pop_dispatchable granted
    payload: object = None              # scheduler Tasks / SimJob / anything


def shadow_analysis(free: int, head_need: int,
                    running: Sequence[Tuple[int, float]]) -> Tuple[float, int]:
    """EASY-backfill reservation for the head-of-line gang.

    ``running`` is [(nodes_held, remaining_time)] for each active job.
    Returns ``(shadow_time, spare_nodes)``: the earliest time at which
    ``head_need`` nodes are simultaneously free, and how many nodes beyond
    the head's need are free at that instant. A backfill candidate is safe
    iff it fits in the spare nodes (it cannot collide with the reservation)
    or it completes before the shadow time (it returns its nodes in time).
    """
    if free >= head_need:
        return (0.0, free - head_need)
    avail = free
    shadow = math.inf
    by_finish = sorted(running, key=lambda r: r[1])
    for nodes_held, remaining in by_finish:
        avail += nodes_held
        if avail >= head_need:
            shadow = remaining
            break
    return (shadow, max(0, avail - head_need))


def _need_of(job: PendingJob) -> int:
    """Narrowest width the job can dispatch at (elastic floor or rigid)."""
    return job.min_nodes if 0 < job.min_nodes < job.n_nodes else job.n_nodes


class JobQueue:
    """Fair-share-ordered pending queue with starvation-free backfill.

    Storage is indexed for the dispatch loop (DESIGN.md §11): jobs live in
    per-user buckets sorted by ``submit_seq``, and the fair-share order is
    produced by a lazy k-way merge over the buckets — one ``norm_usage``
    lookup per USER per walk instead of one priority-key construction per
    JOB per sort (the full-queue rescan that made the simulator quadratic
    at 10^6 events). The merge yields the exact order of the old
    ``sorted(key=(norm_usage, submit_seq))``: ``submit_seq`` ties (only
    possible across users, with equal usage) break on push order, which is
    what a stable sort did. A lazily-maintained ``min need`` bound lets
    ``pop_dispatchable`` answer "nothing can start" in O(1) — the common
    case on a saturated cluster, where most events free no nodes.
    """

    def __init__(self, accountant: Optional[FairShareAccountant] = None):
        self.accountant = accountant or FairShareAccountant()
        # user -> [(submit_seq, push_idx, job)] sorted ascending; push_idx
        # is the global arrival stamp that reproduces stable-sort ties
        self._by_user: Dict[str, List[Tuple[int, int, PendingJob]]] = {}
        self._count = 0
        self._push_idx = 0
        self._min_need: Optional[int] = None    # None = recompute on demand
        self._min_count = 0             # pending jobs AT the min need: the
                                        # bound survives a removal as long
                                        # as a sibling at the same width
                                        # remains (O(1) for the uniform-
                                        # width traces that dominate)
        self._seq = 0

    def __len__(self) -> int:
        return self._count

    def push(self, job: PendingJob):
        lst = self._by_user.setdefault(job.user, [])
        entry = (job.submit_seq, self._push_idx, job)
        self._push_idx += 1
        if lst and lst[-1][:2] > entry[:2]:
            bisect.insort(lst, entry)   # requeue with an out-of-order seq
        else:
            lst.append(entry)           # the common append-in-seq-order path
        self._count += 1
        if self._min_need is not None:
            need = _need_of(job)
            if need < self._min_need:
                self._min_need, self._min_count = need, 1
            elif need == self._min_need:
                self._min_count += 1

    def next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _min_need_bound(self) -> int:
        """Smallest width any pending job could start at (inf if empty)."""
        if self._min_need is None:
            best, count = 10**9, 1
            for lst in self._by_user.values():
                for e in lst:
                    need = _need_of(e[2])
                    if need < best:
                        best, count = need, 1
                    elif need == best:
                        count += 1
            self._min_need, self._min_count = best, count
        return self._min_need

    def _remove_many(self, jobs: Sequence[PendingJob]):
        """Drop ``jobs`` from their buckets (identity-based: PendingJob is
        a non-frozen dataclass, so value equality could alias two distinct
        queued jobs with identical fields)."""
        if not jobs:
            return
        for j in jobs:
            lst = self._by_user[j.user]
            # entries sort by (submit_seq, push_idx); a bare (seq,) probe
            # lands left of every entry with that seq, then identity scan
            i = bisect.bisect_left(lst, (j.submit_seq,))
            while lst[i][2] is not j:
                i += 1
            lst.pop(i)
            if not lst:
                del self._by_user[j.user]
        self._count -= len(jobs)
        if self._min_need is not None:
            for j in jobs:
                if _need_of(j) == self._min_need:
                    self._min_count -= 1
            if self._min_count <= 0:
                self._min_need = None   # last job at the bound left:
                                        # recompute lazily on next query

    def _merged(self) -> Iterator[PendingJob]:
        """Yield pending jobs in fair-share order, lazily.

        Callers that stop early (a saturated ``pop_dispatchable`` breaks
        after the first blocked head) pay O(consumed · log users), not
        O(queue). The queue must not be mutated while the generator is
        live — every consumer below materializes its removals after the
        walk."""
        acct = self.accountant
        heap = []
        for u, lst in self._by_user.items():
            if lst:
                seqi, idx, _ = lst[0]
                heap.append((acct.norm_usage(u), seqi, idx, u, 0))
        heapq.heapify(heap)
        while heap:
            norm, _, _, u, i = heapq.heappop(heap)
            lst = self._by_user[u]
            yield lst[i][2]
            i += 1
            if i < len(lst):
                seqi, idx, _ = lst[i]
                heapq.heappush(heap, (norm, seqi, idx, u, i))

    def ordered(self) -> List[PendingJob]:
        """Pending jobs in fair-share order (head of line first)."""
        return list(self._merged())

    def pop_dispatchable(self, free: int,
                         running: Union[Sequence[Tuple[int, float]],
                                        Callable[[],
                                                 Sequence[Tuple[int, float]]]],
                         held_by_user: Optional[Dict[str, int]] = None,
                         backfill: bool = True) -> List[PendingJob]:
        """Remove and return every job that may start NOW on ``free`` nodes.

        Dispatch loop: take jobs in fair-share order while they fit; once
        the head does not fit it reserves its shadow slot, and only safe
        backfill candidates (see shadow_analysis) may pass it. Per-tenant
        ``max_nodes`` caps are enforced against ``held_by_user``.

        ``running`` may be a ``[(nodes_held, remaining_time)]`` sequence or
        a zero-argument callable producing one: the running view feeds ONLY
        the head gang's shadow analysis, so a lazy provider lets the
        simulator skip the O(running jobs) materialization on every event
        where nothing blocks — the allocation-bookkeeping cost stays
        O(touched), not O(cluster). The analysis itself is also deferred
        until the first backfill candidate that could actually use it
        (``free`` and the running set cannot change between the head
        blocking and that candidate, so deferral is exact).

        Elastic width (``PendingJob.min_nodes > 0``): a job that does not
        fit at its full width but fits at ``min_nodes`` dispatches
        SHRUNKEN onto all remaining free nodes (``granted_nodes <
        n_nodes``) instead of blocking — this is how a preempted gang
        resumes the moment partial capacity frees. Every returned job has
        ``granted_nodes`` set (== ``n_nodes`` for rigid jobs). Elastic
        shrinking only applies ahead of a reservation; behind one, the
        EASY rule stays width-exact so the shadow analysis stays sound.
        """
        # O(1) fast path: every pending job needs at least _min_need nodes
        # to dispatch (and >= that many to backfill), so fewer free nodes
        # means the whole walk below would return empty without mutating
        # anything — the dominant case on a saturated cluster
        if self._count == 0 or free < self._min_need_bound():
            return []
        held = dict(held_by_user or {})
        dispatched: List[Tuple[int, float]] = []
        run: Optional[List[Tuple[int, float]]] = None
        out: List[PendingJob] = []
        blocked_head: Optional[PendingJob] = None
        shadow, spare = math.inf, 0
        for job in self._merged():
            cap = self.accountant.quota(job.user).max_nodes
            need = _need_of(job)
            if cap is not None and held.get(job.user, 0) + need > cap:
                continue                # over quota: skip, do not block queue
            if blocked_head is None:
                if need <= free:
                    granted = min(job.n_nodes, free)
                    if cap is not None:
                        granted = min(granted, cap - held.get(job.user, 0))
                    job.granted_nodes = granted
                    out.append(job)
                    free -= granted
                    held[job.user] = held.get(job.user, 0) + granted
                    est = self.scaled_est(job, granted * max(
                        1, job.n_slots // max(1, job.n_nodes))) \
                        if granted < job.n_nodes and job.n_slots else \
                        job.est_duration
                    dispatched.append((granted, est))
                    continue
                blocked_head = job
                if not backfill:
                    break
                continue
            # behind a reservation: EASY backfill rule only (width-exact)
            if free < 1:
                break                   # no width fits: the rest only scans
            if job.n_nodes > free:
                continue
            if run is None:             # first candidate that could use the
                if callable(running):   # reservation: NOW pay for the view
                    running = running()
                run = list(running) + dispatched
                shadow, spare = shadow_analysis(free, blocked_head.n_nodes,
                                                run)
            fits_spare = job.n_nodes <= spare
            ends_in_time = (job.est_duration > 0
                            and job.est_duration <= shadow)
            if fits_spare or ends_in_time:
                job.granted_nodes = job.n_nodes
                out.append(job)
                free -= job.n_nodes
                spare -= min(spare, job.n_nodes) if fits_spare else 0
                held[job.user] = held.get(job.user, 0) + job.n_nodes
        self._remove_many(out)
        return out

    @staticmethod
    def scaled_est(job: PendingJob, granted: int) -> float:
        """``est_duration`` rescaled from the requested width to ``granted``
        lanes (exact when ``n_tasks`` is known: duration ∝ wave count)."""
        if granted >= job.n_slots:
            return job.est_duration
        if job.n_tasks > 0:
            full_waves = math.ceil(job.n_tasks / job.n_slots)
            return job.est_duration * (math.ceil(job.n_tasks / granted)
                                       / max(1, full_waves))
        return job.est_duration * (job.n_slots / granted)

    def pop_lane_backfill(self, lane_view: Dict[str,
                                                List[Tuple[int, int, float]]],
                          admit=None) -> List[Tuple[PendingJob, int, int]]:
        """Remove and return jobs that may start on FREE LANES of a gang
        their own user is already running (lane-level backfill).

        ``lane_view`` maps user -> [(run_id, free_lane_count,
        host_remaining)] for active gangs. A queued job claims ``granted =
        min(free, n_slots)`` lanes (narrower than requested is allowed:
        continuous refill takes the lanes that exist) PROVIDED its
        width-rescaled duration fits inside the host's remaining time — so
        adoption can never extend the allocation, never delay the host
        gang (whose own tasks keep their slots), and never move anyone's
        EASY reservation: it consumes zero nodes and zero extra
        node-time. The whole-node single-owner invariant is preserved by
        construction: lanes are only adopted from gangs of the SAME user.
        Jobs with unknown duration (``est_duration <= 0``) never adopt —
        the no-extension guarantee could not be checked. ``admit(job,
        run_id) -> bool`` lets the caller veto on memory footprint. The
        gang with the most free lanes is preferred.

        Returns ``[(job, run_id, granted_lanes)]`` in fair-share order.
        """
        if self._count == 0 or not lane_view:
            return []
        avail = {u: [list(rv) for rv in runs]
                 for u, runs in lane_view.items()}
        out: List[Tuple[PendingJob, int, int]] = []
        for job in self._merged():
            if job.n_slots <= 0 or job.est_duration <= 0:
                continue
            for rv in sorted(avail.get(job.user, ()),
                             key=lambda rv: -rv[1]):
                run_id, free_slots, remaining = rv
                if free_slots < 1:
                    continue
                granted = min(free_slots, job.n_slots)
                if self.scaled_est(job, granted) > remaining:
                    continue            # would outlive the host allocation
                if admit is not None and not admit(job, run_id):
                    continue
                rv[1] -= granted
                out.append((job, run_id, granted))
                break
        self._remove_many([job for job, _, _ in out])
        return out

    def take(self, job_ids: Sequence[int]) -> List[PendingJob]:
        """Remove and return the pending jobs with these ids (order of
        ``job_ids``). The spatial dispatch phase (DESIGN.md §10) claims
        the jobs its mode planner placed on slices — they leave the
        queue exactly like a ``pop_dispatchable`` grant, just through
        the planner's door."""
        by_id = {e[2].id: e[2] for lst in self._by_user.values()
                 for e in lst}
        out = [by_id[i] for i in job_ids if i in by_id]
        self._remove_many(out)
        return out
