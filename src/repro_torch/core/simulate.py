"""Deterministic event-driven multi-tenant cluster simulation (a copy of
``repro.core.simulate``; ``mean_wait`` sums with ``left_fold_sum``).

Replays a mixed workload (parametric sweeps + gang training + batch
serving) against the whole-node cluster under two policies and makes the
paper's "sharing vs exclusive" claim benchmarkable under contention:

  * ``exclusive`` — the LLSC default the paper starts from: one task per
    chip (NPPN clamped to chips/NTPP), FIFO dispatch, no backfill;
  * ``shared``    — triples-mode packing (pack_factor > 1 lanes per chip)
    with fair-share ordering, EASY backfill and memory-aware admission
    from core/tenancy.py — the same policy objects the live scheduler
    consumes, so simulation and dispatch cannot drift apart.

Time is virtual seconds driven by an event heap (submit/finish); nothing
here reads a clock or RNG, so a replay is bit-identical. Reported metrics
(DESIGN.md §4.5):

  * per-user mean/max wait (dispatch − submit);
  * allocation utilization — busy node-seconds over nodes × makespan;
  * effective utilization — useful chip-seconds demanded by the tasks
    over chip capacity (the paper's "GPU load" framing: exclusive mode
    leaves chips idle inside an allocation, packing fills them);
  * throughput (tasks/second) and total makespan.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core import spatial as sp
from repro_torch.core import tenancy as ten
from repro_torch.core import triples as T

if False:                               # type-only; repack pulls in torch
    from repro_torch.core.repack import RepackPolicy  # via monitor — keep
                                        # the simulator import-light and pure


def left_fold_sum(xs) -> float:
    """``sum(xs)`` as a plain left-to-right fold."""
    # Python 3.12's built-in sum() of floats is compensated (rounds once);
    # the committed traces and BENCH_HISTORY.json were written with this fold.
    total = 0
    for x in xs:
        total += x
    return total


@dataclasses.dataclass(frozen=True, slots=True)
class SimJob:
    """One job of the replayed workload. ``slots``: a 10^6-event trace
    holds ~500k of these live at once (DESIGN.md §11)."""
    id: int
    user: str
    submit_t: float
    kind: str                           # sweep|train|serve
    n_tasks: int
    task_s: float                       # occupancy seconds per task
    trip: T.Triples
    bytes_per_lane: float = 0.0
    load_frac: float = 1.0              # chip load one task achieves (paper
                                        # Fig 2: a lone small task ~25%)
    interference: float = 0.0           # interference intensity in [0, 1]:
                                        # extra per-co-resident slowdown a
                                        # memory-bound lane inflicts when
                                        # packed (DESIGN.md §10); 0 keeps
                                        # the flat pack_slowdown model


@dataclasses.dataclass(frozen=True, slots=True)
class SimJobStats:
    job: SimJob
    start_t: float                      # FIRST dispatch (wait ends here)
    end_t: float                        # final completion
    pack_factor: int
    eff_trip: T.Triples                 # width of the LAST segment (a
                                        # resumed gang may run narrower)
    adopted: bool = False               # started on another gang's free
                                        # lanes (lane-level refill)
    preemptions: int = 0                # times checkpointed off its nodes
    spatial: bool = False               # ran inside spatial slices of a
                                        # partitioned node (DESIGN.md §10)

    @property
    def wait_s(self) -> float:
        return self.start_t - self.job.submit_t

    @property
    def span_s(self) -> float:
        """Submit-to-completion span — the makespan-overhead metric for
        preempted jobs (includes requeue time and resume overhead)."""
        return self.end_t - self.job.submit_t


@dataclasses.dataclass
class SimReport:
    mode: str
    n_nodes: int
    makespan: float
    stats: List[SimJobStats]
    rejected: List[Tuple[SimJob, str]]
    node_util: float                    # busy node-s / (nodes × makespan)
    effective_util: float               # useful chip-s / (chips × makespan)
    throughput: float                   # completed tasks / makespan
    lane_backfills: int = 0             # jobs started on free lanes
    preemptions: int = 0                # gang checkpoint evictions
    repacks: int = 0                    # modeled online capacity changes
    spatial_placements: int = 0         # jobs run inside spatial slices
    reconfigs: int = 0                  # node partition reconfigurations
    events: int = 0                     # heap events processed (the trace-
                                        # replay bench's events/s denominator)

    def mean_wait(self, user: Optional[str] = None) -> float:
        ws = [s.wait_s for s in self.stats
              if user is None or s.job.user == user]
        return left_fold_sum(ws) / len(ws) if ws else 0.0

    def max_wait(self, user: Optional[str] = None) -> float:
        ws = [s.wait_s for s in self.stats
              if user is None or s.job.user == user]
        return max(ws) if ws else 0.0

    def p50_wait(self, user: Optional[str] = None) -> float:
        ws = sorted(s.wait_s for s in self.stats
                    if user is None or s.job.user == user)
        return ws[len(ws) // 2] if ws else 0.0

    def wait_quantile(self, q: float, user: Optional[str] = None) -> float:
        """Nearest-rank wait quantile (q in [0, 1]) — the scheduler-quality
        trajectory tracks p50/p99 per mode (DESIGN.md §11)."""
        if not 0 <= q <= 1:
            raise ValueError(f"q must be in [0, 1], got {q}")
        ws = sorted(s.wait_s for s in self.stats
                    if user is None or s.job.user == user)
        if not ws:
            return 0.0
        return ws[min(len(ws) - 1, max(0, math.ceil(q * len(ws)) - 1))]

    def p99_wait(self, user: Optional[str] = None) -> float:
        return self.wait_quantile(0.99, user)

    def job_span(self, job_id: int) -> float:
        """Submit-to-completion span of one job (preemption overhead)."""
        for s in self.stats:
            if s.job.id == job_id:
                return s.span_s
        raise KeyError(job_id)

    def users(self) -> List[str]:
        return sorted({s.job.user for s in self.stats})


def effective_triples(trip: T.Triples, node_spec: T.NodeSpec, mode: str,
                      admission: Optional[ten.MemoryAdmission],
                      bytes_per_lane: float) -> T.Triples:
    """What actually runs. Exclusive mode clamps to one lane per chip;
    shared mode keeps the request but the admission cap (from the per-lane
    footprint) may shrink NPPN before dispatch."""
    if mode == "exclusive":
        nppn = max(1, node_spec.chips_per_node // trip.ntpp)
        return T.Triples(trip.nnode, min(trip.nppn, nppn), trip.ntpp)
    if admission is not None and bytes_per_lane > 0:
        return admission.clamp(trip, bytes_per_lane)
    return trip


def job_duration(job: SimJob, eff: T.Triples, node_spec: T.NodeSpec,
                 pack_slowdown: float) -> float:
    """Virtual runtime: waves of slots, each wave slowed by co-residency.

    pack lanes share a chip's MXU/HBM bandwidth, so a wave of packed lanes
    runs at ``1 + (pack_slowdown + interference) × (pack − 1)`` of the
    exclusive wave time — sublinear for polite lanes, which is exactly why
    packing wins throughput (paper Fig. 7: packed lanes hide each other's
    dispatch gaps). ``SimJob.interference`` adds the memory-bound thrash
    term the spatial mode exists to remove (DESIGN.md §10); at 0 this is
    the original flat model."""
    waves = math.ceil(job.n_tasks / eff.total_slots)
    pack = eff.pack_factor(node_spec)
    return waves * job.task_s * (
        1.0 + (pack_slowdown + job.interference) * (pack - 1))


def repack_duration(job: SimJob, eff: T.Triples, node_spec: T.NodeSpec,
                    pack_slowdown: float, policy) -> Tuple[float, int]:
    """Virtual runtime under ONLINE adaptive repacking (core/repack.py):
    the job starts at the conservative ``policy.start_capacity`` lanes
    per chip, runs one wave per rung, pays ``policy.repack_latency_s``
    per resize (drain + recompile + refill) and climbs by
    ``policy.grow_factor`` until it reaches the pack the static path
    would have been granted immediately. Returns (duration, n_repacks) —
    this is how ``compare_modes`` PRICES the policy: shared+repack trades
    a convergence ramp for never trusting an ahead-of-time probe."""
    target = eff.pack_factor(node_spec)
    pack = max(1, min(int(policy.start_capacity), target))
    remaining = job.n_tasks
    t = 0.0
    repacks = 0
    while remaining > 0:
        # slots scale linearly with the pack factor at fixed chips
        slots = max(1, (eff.total_slots * pack) // max(1, target))
        wave_t = job.task_s * (1.0 + pack_slowdown * (pack - 1))
        if pack < target:
            remaining -= min(remaining, slots)   # one wave, then grow
            t += wave_t
            if remaining > 0:           # a job that finished during the
                t += float(policy.repack_latency_s)   # ramp never pays
                pack = min(target,      # for a resize it never performed
                           int(math.ceil(pack * policy.grow_factor)))
                repacks += 1
        else:
            t += math.ceil(remaining / slots) * wave_t
            remaining = 0
    return t, repacks


@dataclasses.dataclass(slots=True)
class _Alloc:
    """One whole-node allocation — possibly hosting several jobs under
    lane-level refill. Nodes free when the LAST hosted job finishes."""
    nodes: int
    start: float
    user: str
    host_trip: T.Triples
    bytes_per_lane: float
    outstanding: int = 1
    spare: int = 0                      # free lanes during the tail wave
    spare_from: float = math.inf        # when the tail wave starts
    host_end: float = 0.0               # host segment's finish time: the
                                        # no-extension adoption rule keeps
                                        # every hosted job's end <= this, so
                                        # it doubles as the allocation's
                                        # remaining-time anchor without an
                                        # O(running) rebuild per event
    duration: float = 0.0               # host segment length (preemption
                                        # computes remaining work from it)
    # jid -> (pack_factor, bytes_per_lane) of still-running adopted jobs;
    # the admission veto counts every co-resident, not just the host
    adopted_pack: Dict[int, Tuple[int, float]] = dataclasses.field(
        default_factory=dict)
    spatial: bool = False               # a partitioned node hosting one
                                        # job per slice (DESIGN.md §10)
    job_frac: Dict[int, Tuple[str, float]] = dataclasses.field(
        default_factory=dict)           # jid -> (user, chip_frac) of each
                                        # slice-hosted job, for fractional
                                        # fair-share charging
    last_end: float = 0.0               # latest hosted finish (node busy
                                        # until the last slice drains)


def simulate(jobs: List[SimJob], n_nodes: int,
             node_spec: Optional[T.NodeSpec] = None, *,
             mode: str = "shared",
             quotas: Optional[Dict[str, ten.TenantQuota]] = None,
             admission: Optional[ten.MemoryAdmission] = None,
             backfill: bool = True,
             lane_refill: bool = False,
             preemption: Optional[ten.PreemptionPolicy] = None,
             repack: Optional["RepackPolicy"] = None,
             spatial: Optional[sp.ModePlanner] = None,
             pack_slowdown: float = 0.15,
             half_life: Optional[float] = None,
             recorder: Optional[Callable[[dict], None]] = None) -> SimReport:
    """Event-driven replay of ``jobs`` on ``n_nodes`` whole nodes.

    With ``lane_refill`` (shared mode only), a queued job of a user that
    already has a running gang with free tail-wave lanes starts on those
    lanes instead of waiting for whole nodes (the simulator model of the
    live scheduler's lane-level backfill): the allocation's nodes stay
    held until every hosted job finishes, and the adopted job consumes
    zero fresh nodes. Mirrors core/lanepool.py's continuous refill at
    job granularity.

    With ``preemption`` (shared mode only), the simulator models the
    live scheduler's checkpoint-based gang preemption: a job still
    queued ``wait_threshold`` seconds after submit may evict an
    over-share victim gang (ten.PreemptionPolicy.choose_victim, counting
    in-flight node-seconds as accrued usage). The victim is charged for
    the segment it ran, re-enters the queue with its REMAINING duration
    plus ``resume_overhead`` (the checkpoint/restore cost) and an
    elastic ``min_nodes``, so it resumes — possibly narrower, at the
    width-rescaled duration — the moment partial capacity frees.
    Deterministic like everything else here: no clocks, no RNG, stale
    finish events are invalidated by a per-job generation counter.

    With ``repack`` (shared mode only; a core.repack.RepackPolicy or any
    object with start_capacity/grow_factor/repack_latency_s), packing
    jobs run the ONLINE convergence ramp instead of trusting the static
    grant: start conservative, one wave per rung, a priced latency per
    resize (see repack_duration). ``SimReport.repacks`` counts the
    modeled capacity changes.

    With ``spatial`` (shared mode only; a core.spatial.ModePlanner), the
    simulator models the live scheduler's spatial dispatch phase
    (DESIGN.md §10): when queued single-node jobs outnumber the free
    nodes, the planner may partition one node into isolated slices and
    run several jobs on it CONCURRENTLY — each paying only intra-slice
    slowdown (isolation strips the interference term) plus the priced
    ``reconfig_latency_s``, and charged the chip FRACTION it held.
    ``SimReport.spatial_placements``/``reconfigs`` count the modeled
    placements and partition events.

    With ``recorder`` (any callable taking a dict), every job-level
    decision is emitted as a normalized ``eventlog.DECISION_SCHEMA`` row
    — the SAME schema the live control plane's event stream reduces to
    via ``eventlog.decision_view`` — so a live log and a sim log of one
    workload diff field-by-field (``eventlog.diff_decision_logs``,
    DESIGN.md §15). Recording is decision-neutral: nothing here reads
    the recorder back.
    """
    if mode not in ("shared", "exclusive"):
        raise ValueError(f"mode must be shared|exclusive, got {mode!r}")
    node_spec = node_spec or T.NodeSpec()
    if mode == "exclusive":             # the baseline has no fair-share,
        quotas, admission = None, None            # admission, refill or
        backfill, lane_refill = False, False      # preemption layer
        preemption = None
        repack = None
        spatial = None
    acct = ten.FairShareAccountant(quotas, half_life=half_life)
    queue = ten.JobQueue(acct)

    def rec(kind: str, **fields):
        if recorder is not None:
            recorder({"kind": kind, **fields})
    pending_payload: Dict[int, Tuple[SimJob, T.Triples, float]] = {}
    rejected: List[Tuple[SimJob, str]] = []

    # event heap: (t, seq, kind, payload). Built in one pass + heapify
    # (a seq-stamped sorted list is already heap-ordered) instead of n
    # O(log n) pushes; pop order is identical either way — (t, seq) is a
    # total order, so the heap's internal layout cannot change results.
    seq = 0
    heap: List[Tuple[float, int, str, object]] = []
    for job in sorted(jobs, key=lambda j: (j.submit_t, j.id)):
        heap.append((job.submit_t, seq, "submit", job))
        seq += 1
    heapq.heapify(heap)

    free = n_nodes
    allocs: Dict[int, _Alloc] = {}      # alloc id (host jid) -> state
    running: Dict[int, Tuple[int, float, int]] = {}  # jid -> (aid, end, gen)
    gen_of: Dict[int, int] = {}         # jid -> current generation
    held: Dict[str, int] = {}
    stats_by_job: Dict[int, SimJobStats] = {}
    preempt_checks: Dict[int, int] = {}  # jid -> rechecks scheduled
    spare_aids: Dict[int, None] = {}    # allocs with free tail-wave lanes,
                                        # in dispatch order (matching the
                                        # old full-alloc scan's tie-break):
                                        # the lane-refill phase scans THIS,
                                        # not every live allocation
    n_events = 0
    busy_node_s = 0.0
    useful_chip_s = 0.0
    completed_tasks = 0
    makespan = 0.0
    lane_backfills = 0
    n_preemptions = 0
    n_repacks = 0
    n_spatial = 0
    n_reconfigs = 0
    MAX_RECHECKS = 64                   # termination bound for jobs that
                                        # can never find a victim

    def admit_on_lanes(pj: ten.PendingJob, aid: int) -> bool:
        """Combined host+adopted per-chip footprint must stay admissible
        (conservative: both at the larger per-lane footprint)."""
        if admission is None:
            return True
        al = allocs[aid]
        job, eff, _ = pending_payload[pj.id]
        co = [(al.host_trip.pack_factor(node_spec), al.bytes_per_lane),
              *al.adopted_pack.values(),
              (eff.pack_factor(node_spec), float(pj.bytes_per_lane))]
        return admission.admit_colocated([p for p, _ in co],
                                         [b for _, b in co])

    def record(job: SimJob, now: float, end: float, eff: T.Triples,
               adopted: bool = False, spatial_placed: bool = False):
        """Create/extend the job's stats row. A resumed job keeps its
        FIRST start (wait ends at first dispatch) and preemption count."""
        prev = stats_by_job.get(job.id)
        if prev is None:
            stats_by_job[job.id] = SimJobStats(
                job=job, start_t=now, end_t=end,
                pack_factor=eff.pack_factor(node_spec), eff_trip=eff,
                adopted=adopted, spatial=spatial_placed)
        else:
            stats_by_job[job.id] = dataclasses.replace(
                prev, end_t=end, eff_trip=eff,
                pack_factor=eff.pack_factor(node_spec),
                spatial=prev.spatial or spatial_placed)

    def spatial_dispatch(now: float):
        """The live scheduler's spatial phase on virtual time: under
        contention (queued single-node jobs outnumber free nodes) the
        mode planner may partition ONE node and run several queued jobs
        concurrently in isolated slices — each priced at intra-slice
        slowdown only, plus the partition-reconfigure latency, and
        charged the chip fraction it holds (DESIGN.md §10)."""
        nonlocal free, seq, n_spatial, n_reconfigs
        if spatial is None or free < 1 or not len(queue):
            return                      # a partition needs a free node and
                                        # queued jobs — exact early-out
        max_group = spatial.max_group
        skipped: set = set()
        while True:
            group, _ = sp.select_spatial_group(
                queue.ordered(), free, held,
                lambda u: acct.quota(u).max_nodes, max_group, skipped,
                eligible_fn=lambda pj: pj.id in pending_payload)
            if not group:
                return
            k = len(group)
            profiles = []
            for pj in group:
                job, eff, _ = pending_payload[pj.id]
                profiles.append(sp.JobProfile(
                    job_id=job.id, user=job.user,
                    n_tasks=pj.n_tasks or job.n_tasks,  # REMAINING work:
                    # a preempted job resuming on slices must not be
                    # re-priced at its full original task count
                    bytes_per_lane=float(pj.bytes_per_lane),
                    intensity=min(1.0, max(0.0, job.interference)),
                    task_s=job.task_s, want_lanes=eff.total_slots,
                    kind=job.kind))
            prof_by_id = {p.job_id: p for p in profiles}
            plan = spatial.plan_node(profiles)
            if plan.mode != "spatial":
                if k == 1:              # this job prefers temporal: let it
                    skipped.add(group[0].id)    # dispatch, try the next
                else:                   # group vetoed (e.g. min_grant_frac)
                    max_group = 1       # — still try single-job isolation
                continue
            free -= 1
            n_reconfigs += 1
            aid = group[0].id
            al = _Alloc(nodes=1, start=now, user="",
                        host_trip=T.Triples(1, 1, 1), bytes_per_lane=0.0,
                        outstanding=0, spatial=True)
            allocs[aid] = al
            for pj in queue.take([p.id for p in group]):
                job, eff, _ = pending_payload.pop(pj.id)
                lanes = max(1, plan.lanes_of(job.id))
                mine = [p for p in plan.placements if p.job_id == job.id]
                # price with the planner's EFFECTIVE intensity (the same
                # number plan_node costed with): identical to the raw
                # declared interference when no interference source is
                # wired, roofline-measured when one is
                eff_int = spatial._intensity(prof_by_id[job.id])
                slow = max(spatial.slice_slowdown(p, eff_int) for p in mine)
                waves = math.ceil((pj.n_tasks or job.n_tasks) / lanes)
                duration = waves * job.task_s * slow + plan.reconfig_s
                end = now + duration
                al.outstanding += 1
                # quota: a partitioned node counts as ONE held node per
                # user holding any slice on it (same rule as the live
                # ClusterState.held_counts — max_nodes is a hard cap,
                # and same-user co-residents share the one node)
                if not any(u == job.user
                           for u, _ in al.job_frac.values()):
                    held[job.user] = held.get(job.user, 0) + 1
                al.job_frac[job.id] = (job.user, plan.chip_frac_of(job.id))
                al.last_end = max(al.last_end, end)
                gen = gen_of.get(job.id, 0) + 1
                gen_of[job.id] = gen
                running[job.id] = (aid, end, gen)
                n_spatial += 1
                record(job, now, end, T.Triples(1, lanes, eff.ntpp),
                       spatial_placed=True)
                rec("spatial_dispatch", job=job.id, user=job.user,
                    lanes=lanes)
                heapq.heappush(heap, (end, seq, "finish", (job, gen)))
                seq += 1

    def running_view(now: float) -> List[Tuple[float, float]]:
        """[(nodes, remaining)] for the EASY shadow analysis. Only built
        when a blocked head actually needs a reservation — the lazy
        provider keeps the per-event dispatch cost O(touched allocations)
        instead of O(every running job on the cluster)."""
        alloc_end: Dict[int, float] = {}
        for aid, end, _ in running.values():
            if end > alloc_end.get(aid, 0.0):
                alloc_end[aid] = end
        return [(allocs[aid].nodes, alloc_end[aid] - now)
                for aid in alloc_end]

    def dispatch(now: float):
        nonlocal free, seq, lane_backfills
        spatial_dispatch(now)
        for pj in queue.pop_dispatchable(free,
                                         lambda: running_view(now),
                                         held_by_user=held,
                                         backfill=backfill):
            job, eff, duration = pending_payload.pop(pj.id)
            granted = pj.granted_nodes or eff.nnode
            if granted < eff.nnode:     # elastic resume on partial capacity
                duration = ten.JobQueue.scaled_est(pj, granted * eff.nppn)
                eff = T.Triples(granted, eff.nppn, eff.ntpp)
            free -= eff.nnode
            held[job.user] = held.get(job.user, 0) + eff.nnode
            end = now + duration
            waves = max(1, math.ceil(pj.n_tasks / eff.total_slots)) \
                if pj.n_tasks else 1
            tail_occ = pj.n_tasks - (waves - 1) * eff.total_slots \
                if pj.n_tasks else eff.total_slots
            al = _Alloc(nodes=eff.nnode, start=now, user=job.user,
                        host_trip=eff, bytes_per_lane=float(job.bytes_per_lane),
                        spare=eff.total_slots - tail_occ,
                        spare_from=now + (waves - 1) * (duration / waves),
                        duration=duration, host_end=end)
            allocs[job.id] = al
            gen = gen_of.get(job.id, 0) + 1
            gen_of[job.id] = gen
            running[job.id] = (job.id, end, gen)
            record(job, now, end, eff)
            rec("dispatch_gang", job=job.id, user=job.user, width=eff.nnode)
            heapq.heappush(heap, (end, seq, "finish", (job, gen)))
            seq += 1
            if lane_refill and al.spare > 0:
                spare_aids[job.id] = None
                heapq.heappush(heap, (al.spare_from, seq, "spare", job))
                seq += 1
        if not lane_refill or not spare_aids or not len(queue):
            return
        # lane-level refill: queued jobs onto free tail-wave lanes of a
        # same-user gang (zero fresh nodes; nodes stay held until every
        # hosted job finishes). Only the indexed spare allocations are
        # visited; the host's own finish time is the allocation's end
        # (adoption never extends it — pop_lane_backfill's fit rule)
        lane_view: Dict[str, List[Tuple[int, int, float]]] = {}
        for aid in list(spare_aids):
            al = allocs.get(aid)
            if al is None or al.spare <= 0 or not al.outstanding:
                del spare_aids[aid]
                continue
            if al.spare_from <= now:
                lane_view.setdefault(al.user, []).append(
                    (aid, al.spare, al.host_end - now))
        if not lane_view:
            return
        for pj, aid, granted in queue.pop_lane_backfill(lane_view,
                                                        admit_on_lanes):
            job, eff, _ = pending_payload.pop(pj.id)
            al = allocs[aid]
            al.spare -= granted
            if al.spare <= 0:
                spare_aids.pop(aid, None)
            al.outstanding += 1
            al.adopted_pack[pj.id] = (eff.pack_factor(node_spec),
                                      float(job.bytes_per_lane))
            # narrower than requested: more waves at the granted width
            duration = ten.JobQueue.scaled_est(pj, granted)
            end = now + duration
            gen = gen_of.get(job.id, 0) + 1
            gen_of[job.id] = gen
            running[job.id] = (aid, end, gen)
            lane_backfills += 1
            record(job, now, end, eff, adopted=True)
            rec("lane_backfill", job=job.id, user=job.user, lanes=granted)
            heapq.heappush(heap, (end, seq, "finish", (job, gen)))
            seq += 1

    def try_preempt(now: float, waiter: SimJob) -> bool:
        """A starved waiter evicts the cheapest over-share victim gang."""
        nonlocal free, seq, busy_node_s, n_preemptions
        pol = preemption
        # victims: allocs hosting ONLY their own job (checkpointing a gang
        # out from under lane-backfilled co-residents would strand them)
        candidates = []
        for aid, al in allocs.items():
            if al.spatial or al.outstanding != 1 or al.adopted_pack \
                    or aid not in running:
                continue                # not running pure-host (or a
                                        # partitioned node): skip
            _, end, _ = running[aid]
            remaining = max(0.0, end - now)
            candidates.append((aid, al.user, al.nodes * remaining,
                               stats_by_job[aid].preemptions))
        if not candidates:
            return False
        accrued: Dict[str, float] = {}
        for al in allocs.values():
            accrued[al.user] = accrued.get(al.user, 0.0) \
                + al.nodes * (now - al.start)
        victim = pol.choose_victim(acct, waiter.user, candidates,
                                   accrued=accrued)
        if victim is None:
            return False
        al = allocs.pop(victim)
        _, end, _ = running.pop(victim)
        vstat = stats_by_job[victim]
        vjob = vstat.job
        elapsed = now - al.start
        busy_node_s += al.nodes * elapsed
        acct.charge(al.user, al.nodes * elapsed)
        free += al.nodes
        held[al.user] = held.get(al.user, 0) - al.nodes
        remaining = max(0.0, end - now)
        frac_left = remaining / al.duration if al.duration > 0 else 0.0
        n_left = max(1, int(math.ceil(vjob.n_tasks * frac_left)))
        # requeue at FULL width with an elastic floor: the checkpoint is
        # width-agnostic, so the gang resumes on whatever frees first
        queue.push(ten.PendingJob(
            id=vjob.id, user=vjob.user, n_nodes=al.host_trip.nnode,
            submit_seq=queue.next_seq(), submit_t=vjob.submit_t,
            est_duration=remaining + pol.resume_overhead,
            bytes_per_lane=vjob.bytes_per_lane,
            n_slots=al.host_trip.total_slots, n_tasks=n_left,
            min_nodes=pol.min_nodes(al.host_trip.nnode)))
        pending_payload[vjob.id] = (vjob, al.host_trip,
                                    remaining + pol.resume_overhead)
        stats_by_job[victim] = dataclasses.replace(
            vstat, preemptions=vstat.preemptions + 1)
        n_preemptions += 1
        rec("preempt", job=vjob.id, user=vjob.user)
        return True

    def schedule_preempt_check(job: SimJob, now: float):
        nonlocal seq
        if preemption is None or job.id not in pending_payload:
            return
        if preempt_checks.get(job.id, 0) >= MAX_RECHECKS:
            return
        preempt_checks[job.id] = preempt_checks.get(job.id, 0) + 1
        heapq.heappush(heap, (now + preemption.wait_threshold, seq,
                              "preempt_check", job))
        seq += 1

    while heap:
        # drain EVERY event at this instant before dispatching: four small
        # jobs finishing at the same t must free all their nodes at once,
        # or an elastic resume would grab the first sliver and stretch
        t = heap[0][0]
        batch = []
        while heap and heap[0][0] == t:
            batch.append(heapq.heappop(heap))
        n_events += len(batch)
        acct.decay_to(t)
        for _, _, kind, payload in batch:
            if kind == "submit":
                job: SimJob = payload
                try:
                    eff = effective_triples(job.trip, node_spec, mode,
                                            admission, job.bytes_per_lane)
                except MemoryError as e:
                    rejected.append((job, str(e)))
                    rec("reject", job=job.id, user=job.user, reason=str(e))
                    continue
                if eff.nnode > n_nodes:
                    reason = f"needs {eff.nnode} > {n_nodes} nodes"
                    rejected.append((job, reason))
                    rec("reject", job=job.id, user=job.user, reason=reason)
                    continue
                if repack is not None and eff.pack_factor(node_spec) > 1:
                    duration, nrep = repack_duration(
                        job, eff, node_spec, pack_slowdown, repack)
                    n_repacks += nrep
                else:
                    duration = job_duration(job, eff, node_spec,
                                            pack_slowdown)
                pending_payload[job.id] = (job, eff, duration)
                queue.push(ten.PendingJob(
                    id=job.id, user=job.user, n_nodes=eff.nnode,
                    submit_seq=queue.next_seq(), submit_t=job.submit_t,
                    est_duration=duration,
                    bytes_per_lane=job.bytes_per_lane,
                    n_slots=eff.total_slots, n_tasks=job.n_tasks))
                rec("submit", job=job.id, user=job.user, nodes=eff.nnode)
            elif kind == "finish":
                job, gen = payload
                cur = running.get(job.id)
                if cur is None or cur[2] != gen:
                    continue            # stale: the job was preempted and
                                        # resumed under a newer generation
                aid, end, _ = running.pop(job.id)
                rec("complete", job=job.id, user=job.user)
                al = allocs[aid]
                al.outstanding -= 1
                al.adopted_pack.pop(job.id, None)
                makespan = max(makespan, end)
                if al.spatial:          # fractional per-slice charging;
                    user, frac = al.job_frac.pop(job.id, ("", 0.0))
                    acct.charge(user, frac * (end - al.start))
                    if not any(u == user
                               for u, _ in al.job_frac.values()):
                        held[user] = held.get(user, 0) - 1
                    if al.outstanding == 0:  # node busy until last slice
                        free += al.nodes
                        busy_node_s += al.nodes * (al.last_end - al.start)
                        del allocs[aid]
                elif al.outstanding == 0:  # last hosted job out: nodes free
                    free += al.nodes
                    held[al.user] = held.get(al.user, 0) - al.nodes
                    acct.charge(al.user, al.nodes * (end - al.start))
                    busy_node_s += al.nodes * (end - al.start)
                    del allocs[aid]
            elif kind == "preempt_check":
                job = payload
                if job.id in pending_payload:   # still starved: evict
                    try_preempt(t, job)  # dispatch below places the waiter
        # "spare" events carry no state change — they just give dispatch()
        # a chance to place lane backfills the moment a tail wave opens
        dispatch(t)
        if preemption is not None:
            for _, _, kind, payload in batch:
                if kind in ("submit", "preempt_check") \
                        and payload.id in pending_payload:
                    schedule_preempt_check(payload, t)  # still queued: re-arm

    for pj in queue.ordered():          # drained heap, still queued: these
        job, _, _ = pending_payload.pop(pj.id)   # can never dispatch
        rejected.append((job, "never dispatched (quota or capacity)"))
        rec("reject", job=job.id, user=job.user,
            reason="never dispatched (quota or capacity)")

    stats = sorted(stats_by_job.values(),
                   key=lambda s: (s.start_t, s.job.id))
    for s in stats:                     # account completed work
        useful_chip_s += (s.job.n_tasks * s.job.task_s * s.job.trip.ntpp
                          * s.job.load_frac)
        completed_tasks += s.job.n_tasks

    chips = n_nodes * node_spec.chips_per_node
    return SimReport(
        mode=mode, n_nodes=n_nodes, makespan=makespan, stats=stats,
        rejected=rejected,
        node_util=busy_node_s / (n_nodes * makespan) if makespan else 0.0,
        effective_util=useful_chip_s / (chips * makespan) if makespan else 0.0,
        throughput=completed_tasks / makespan if makespan else 0.0,
        lane_backfills=lane_backfills, preemptions=n_preemptions,
        repacks=n_repacks, spatial_placements=n_spatial,
        reconfigs=n_reconfigs, events=n_events)


# ---------------------------------------------------------------------------
# workload builders (deterministic — no RNG)
# ---------------------------------------------------------------------------

def mixed_workload(node_spec: Optional[T.NodeSpec] = None, *,
                   n_sweep_jobs: int = 6, sweep_tasks: int = 64,
                   n_train_jobs: int = 2, train_nodes: int = 4,
                   n_serve_jobs: int = 4, n_eval_jobs: int = 0,
                   inter_arrival_s: float = 20.0) -> List[SimJob]:
    """The paper's facility mix, three tenants:

      * alice — parametric sweeps: many tiny tasks, heavy over-allocation
        (NPPN = 4 × chips), small per-lane footprint. The triples headline.
      * bob   — gang training: whole nodes, NTPP = chips (one big task per
        node), long-running. Creates the contention sweeps backfill around.
      * carol — batch serving: short medium jobs, modest packing.

    ``n_eval_jobs`` adds short alice eval bursts (few tasks, sub-second):
    the jobs lane-level refill (DESIGN.md §7) exists for — small enough to
    drain inside a sweep's tail wave on its free lanes.
    """
    node_spec = node_spec or T.NodeSpec()
    cpn = node_spec.chips_per_node
    jobs: List[SimJob] = []
    jid = 0

    def add(user, kind, submit_t, n_tasks, task_s, trip, bpl, load):
        nonlocal jid
        jobs.append(SimJob(id=jid, user=user, submit_t=submit_t, kind=kind,
                           n_tasks=n_tasks, task_s=task_s, trip=trip,
                           bytes_per_lane=bpl, load_frac=load))
        jid += 1

    for i in range(n_sweep_jobs):
        add("alice", "sweep", i * inter_arrival_s, sweep_tasks, 2.0,
            T.Triples(nnode=1, nppn=4 * cpn, ntpp=1),
            bpl=1.5e9, load=0.25)       # small model: 10 lanes fit a chip,
                                        # one lane leaves the chip 75% idle
    for i in range(n_train_jobs):
        add("bob", "train", 10.0 + i * 3 * inter_arrival_s, train_nodes, 60.0,
            T.Triples(nnode=train_nodes, nppn=1, ntpp=cpn),
            bpl=0.0, load=1.0)          # whole-node job, no packing
    for i in range(n_serve_jobs):
        add("carol", "serve", 5.0 + i * 1.5 * inter_arrival_s, 2 * cpn, 4.0,
            T.Triples(nnode=1, nppn=2 * cpn, ntpp=1),
            bpl=4e9, load=0.4)          # pack 2 fits, pack 4 would not
    for i in range(n_eval_jobs):
        add("alice", "sweep", 2.0 + i * 0.5 * inter_arrival_s, cpn, 0.5,
            T.Triples(nnode=1, nppn=cpn, ntpp=1),
            bpl=1.5e9, load=0.25)       # short eval burst: fits a tail wave
    return jobs


def compare_modes(jobs: List[SimJob], n_nodes: int,
                  node_spec: Optional[T.NodeSpec] = None,
                  lane_refill: bool = False,
                  preemption: Optional[ten.PreemptionPolicy] = None,
                  repack: Optional["RepackPolicy"] = None,
                  spatial: Optional[sp.ModePlanner] = None,
                  **kw) -> Dict[str, SimReport]:
    """Run the same workload under both policies. With ``lane_refill`` a
    third report, ``shared+refill``, adds lane-level backfill on top of
    the shared policy so the refill gain is isolated; ``preemption``
    likewise adds a ``shared+preempt`` report (checkpoint-based gang
    preemption on top of the shared policy), ``repack`` a
    ``shared+repack`` report (online adaptive packing with its priced
    convergence ramp, repack_duration), and ``spatial`` a
    ``shared+spatial`` report (the interference-aware mode planner
    partitioning contended nodes into isolated slices, pricing the
    partition-reconfigure latency — DESIGN.md §10) so every policy layer
    replays deterministically from one workload."""
    node_spec = node_spec or T.NodeSpec()
    admission = kw.pop("admission", ten.MemoryAdmission(node_spec))
    out = {
        "exclusive": simulate(jobs, n_nodes, node_spec, mode="exclusive",
                              **kw),
        "shared": simulate(jobs, n_nodes, node_spec, mode="shared",
                           admission=admission, **kw),
    }
    if lane_refill:
        out["shared+refill"] = simulate(jobs, n_nodes, node_spec,
                                        mode="shared", admission=admission,
                                        lane_refill=True, **kw)
    if preemption is not None:
        out["shared+preempt"] = simulate(jobs, n_nodes, node_spec,
                                         mode="shared", admission=admission,
                                         preemption=preemption, **kw)
    if repack is not None:
        out["shared+repack"] = simulate(jobs, n_nodes, node_spec,
                                        mode="shared", admission=admission,
                                        repack=repack, **kw)
    if spatial is not None:
        out["shared+spatial"] = simulate(jobs, n_nodes, node_spec,
                                         mode="shared", admission=admission,
                                         spatial=spatial, **kw)
    n_layers = (int(lane_refill) + (preemption is not None)
                + (repack is not None) + (spatial is not None))
    if n_layers >= 2:
        # every requested layer at once — the configuration an operator
        # would actually deploy; the pairwise reports above isolate each
        # layer's marginal gain, this one prices their interaction
        out["shared+full"] = simulate(jobs, n_nodes, node_spec,
                                      mode="shared", admission=admission,
                                      lane_refill=lane_refill,
                                      preemption=preemption, repack=repack,
                                      spatial=spatial, **kw)
    return out


def comparison_table(reports: Dict[str, SimReport]) -> str:
    """Render the sharing-vs-exclusive table (docs/BENCHMARKS.md)."""
    users = sorted({u for r in reports.values() for u in r.users()})
    lines = [f"{'MODE':>10s} {'NODE-UTIL':>10s} {'EFF-UTIL':>9s} "
             f"{'TASKS/S':>8s} {'MAKESPAN':>9s} {'MEAN-WAIT':>10s} "
             + " ".join(f"{('wait:' + u):>12s}" for u in users)]
    for name, r in reports.items():
        lines.append(
            f"{name:>10s} {r.node_util:>9.1%} {r.effective_util:>8.1%} "
            f"{r.throughput:>8.2f} {r.makespan:>8.0f}s {r.mean_wait():>9.0f}s "
            + " ".join(f"{r.mean_wait(u):>11.0f}s" for u in users))
    return "\n".join(lines)
