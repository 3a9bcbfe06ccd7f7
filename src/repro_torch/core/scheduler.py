"""Node-based gang scheduler with the LLSC whole-node policy [paper §I-II]
(a copy of ``repro.core.scheduler``, which is plain Python; its gang
checkpoints go through the port's ``Checkpointer``).

Semantics reproduced from the paper:
  * whole-node allocation — a node serves at most one job (user) at a time;
  * triples job = ONE scheduler allocation for NNODE nodes carrying
    NNODE×NPPN child process slots (vs. a job array's per-task allocation
    cycle — both modes exist here so the overhead claim is benchmarkable);
  * tasks dispatch to slots round-robin via core.triples.plan;
  * failures: per-task retry, OOM packing backoff, node loss re-planning,
    speculative re-execution of stragglers.

Multi-tenancy (DESIGN.md §4): when constructed with a ``Tenancy`` bundle,
``submit`` + ``run_queued`` route every allocation through the fair-share
pending queue (FIFO + EASY backfill) with memory-aware admission, and
gangs from different users execute concurrently on disjoint nodes —
interleaved round-robin at task granularity, deterministically.

Execution on this container is cooperative (slots interleave at task
granularity, deterministic); the placement/accounting layer is exactly what
a multi-host launcher would consume.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import spatial
from repro_torch.core import triples as T
from repro_torch.core import tenancy as ten
from repro_torch.core.faults import (FaultPolicy, NodeDown, TaskCrash,
                                     TaskError, TaskOOM, TaskWedged)

if False:                               # type-only; monitor imports torch
    from repro_torch.core.monitor import TenantGauges


@dataclasses.dataclass
class Task:
    id: int
    fn: Callable[["TaskCtx"], Any]
    name: str = ""
    retries: int = 0
    state: str = "pending"             # pending|running|done|failed
    result: Any = None
    error: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class TaskCtx:
    """What the execution script exports to each child task (paper: the
    generated script sets CUDA_VISIBLE_DEVICES + OMP_NUM_THREADS)."""
    task_id: int
    node: int
    slot: int
    chips: Tuple[int, ...]             # CUDA_VISIBLE_DEVICES analogue
    pack_lane: int                     # unique per (node, chip) within a
                                       # gang; across co-resident slice
                                       # gangs the (chips, slice) pair is
                                       # the physical address
    ntpp: int                          # OMP_NUM_THREADS analogue
    slice: Optional[int] = None        # spatial slice hosting this slot
                                       # (MIG instance handle analogue;
                                       # None = whole-node modes)
    incarnation: int = 0               # gang restart count (preempt/resume
                                       # cycles) at dispatch time — a
                                       # watchdog-restarted task can tell
                                       # it was relaunched (DESIGN.md §15)


@dataclasses.dataclass
class Event:
    t: float
    kind: str                          # alloc|dispatch|done|fail|retry|...
    detail: dict


@dataclasses.dataclass
class JobResult:
    results: Dict[int, Any]
    failed: Dict[int, str]
    events: List[Event]
    alloc_cycles: int                  # scheduler allocations performed
    wall_s: float
    wait_rounds: int = 0               # rounds spent queued (tenancy path)
    preemptions: int = 0               # times this gang was checkpointed
                                       # off its nodes mid-run


class ClusterState:
    """Nodes + whole-node ownership (+ optional spatial partitions).

    A node is in exactly one of three states: free, whole-node owned
    (the LLSC policy — ``owner[node]`` is the user), or PARTITIONED
    (``partitions[node]`` is a ``spatial.SliceConfig`` and each slice
    has its own owner in ``slice_owner`` — the one sanctioned exception
    to single-ownership, because slices are hardware-isolated,
    DESIGN.md §10). A partitioned node is invisible to whole-node
    allocation and reverts to free when its last slice releases."""

    def __init__(self, n_nodes: int, node_spec: Optional[T.NodeSpec] = None):
        self.n_nodes = n_nodes
        self.node_spec = node_spec or T.NodeSpec()
        self.owner: Dict[int, Optional[str]] = {i: None for i in range(n_nodes)}
        self.down: set = set()
        self.partitions: Dict[int, object] = {}       # node -> SliceConfig
        self.slice_owner: Dict[Tuple[int, int], str] = {}

    def alive(self) -> List[int]:
        return [i for i in range(self.n_nodes) if i not in self.down]

    def free_count(self) -> int:
        return sum(1 for i in self.alive()
                   if self.owner[i] is None and i not in self.partitions)

    # ------------------------------------------------- spatial partitions
    def free_nodes(self) -> List[int]:
        """Nodes available to either whole-node allocation or a fresh
        spatial partition."""
        return [i for i in self.alive()
                if self.owner[i] is None and i not in self.partitions]

    def partition_node(self, node: int, config):
        """Partition a FREE node under ``config`` (spatial.SliceConfig)."""
        if node in self.down or self.owner[node] is not None \
                or node in self.partitions:
            raise RuntimeError(f"node {node} is not free to partition")
        self.partitions[node] = config

    def allocate_slice(self, user: str, node: int, index: int):
        if node not in self.partitions:
            raise RuntimeError(f"node {node} is not partitioned")
        if (node, index) in self.slice_owner:
            raise RuntimeError(f"slice ({node}, {index}) already owned")
        self.slice_owner[(node, index)] = user

    def release_slice(self, node: int, index: int):
        """Free one slice; the partition dissolves with its last slice."""
        self.slice_owner.pop((node, index), None)
        if node in self.partitions and not any(
                n == node for n, _ in self.slice_owner):
            del self.partitions[node]

    def held_counts(self) -> Dict[str, int]:
        """Nodes currently held, per user (tenancy quota enforcement).
        A partitioned node counts as held — one whole node per user per
        node they own ANY slice on (conservative: ``max_nodes`` is a
        hard cap, and a fractional holding must not become a quota
        bypass)."""
        held: Dict[str, int] = {}
        for i in self.alive():
            u = self.owner[i]
            if u is not None:
                held[u] = held.get(u, 0) + 1
        seen = set()
        for (node, _), u in self.slice_owner.items():
            if node not in self.down and (node, u) not in seen:
                seen.add((node, u))
                held[u] = held.get(u, 0) + 1
        return held

    def allocate(self, user: str, n: int,
                 fresh: bool = False) -> Optional[List[int]]:
        """Whole-node allocation. By default nodes already owned by this
        user are reusable (the seed single-job semantics); ``fresh=True``
        demands strictly unowned nodes — required when one user runs
        several concurrent gangs (tenancy path) so they never share."""
        free = [i for i in self.alive() if i not in self.partitions
                and (self.owner[i] is None
                     or (not fresh and self.owner[i] == user))]
        if len(free) < n:
            return None
        got = free[:n]
        for i in got:
            self.owner[i] = user
        return got

    def release(self, nodes: Sequence[int]):
        for i in nodes:
            self.owner[i] = None

    def fail_node(self, node: int):
        self.down.add(node)
        self.owner[node] = None
        self.partitions.pop(node, None)
        for key in [k for k in self.slice_owner if k[0] == node]:
            del self.slice_owner[key]


# ---------------------------------------------------------------------------
# per-gang runtime — shared by the blocking and the multi-tenant path
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GangCheckpoint:
    """Everything a preempted gang needs to resume — at ANY width.

    Results/failed are the completed tasks' outcomes; ``remaining`` the
    task-id cursors still to run (including tasks mid-retry). The resumed
    gang replans ``remaining`` over whatever nodes it is granted
    (``min_nodes`` elastic resize), so the checkpoint is width-agnostic —
    exactly like a PoolSnapshot is capacity-agnostic at the lane level.
    """
    job_id: int
    user: str
    results: Dict[int, Any]
    failed: Dict[int, str]
    remaining: List[int]
    retries: Dict[int, int]
    nnode: int                          # width held at preemption

    def cursor_extra(self) -> dict:
        """JSON-safe cursor view for the persisted artifact (values of
        arbitrary Python results stay in memory; the artifact records
        which tasks are done so operators can audit progress)."""
        return {"gang_checkpoint": True, "job": self.job_id,
                "user": self.user, "nnode": self.nnode,
                "completed": sorted(self.results),
                "failed": {str(k): v for k, v in self.failed.items()},
                "remaining": list(self.remaining),
                "retries": {str(k): v for k, v in self.retries.items()}}


@dataclasses.dataclass
class GangJob:
    """One submitted triples job under tenancy."""
    id: int
    user: str
    tasks: List[Task]
    trip: T.Triples
    bytes_per_lane: float = 0.0
    interference: float = 0.0          # declared interference intensity in
                                       # [0, 1] for the spatial mode planner
                                       # (0 = compute-bound; telemetry may
                                       # raise the effective score)
    kind: str = ""                     # job family ("train"/"serve"/...):
                                       # measured intensity is shared across
                                       # one family via key "kind:<kind>"
    intensity_profile: Optional[Any] = None
                                       # roofline.IntensityProfile of the
                                       # job's compiled step; recorded into
                                       # admission at FIRST dispatch
    state: str = "queued"              # queued|running|done|rejected
    reject_reason: str = ""
    result: Optional[JobResult] = None
    checkpoint: Optional[GangCheckpoint] = None   # set while preempted
    preemptions: int = 0


class _GangRun:
    """Runtime state of one dispatched gang: plan, slot queues, retries.

    ``step_round`` executes at most one task per slot, so several gangs
    interleave deterministically when stepped in turn by ``run_queued``.

    A gang may carry MORE than one job: lane-level backfill (``adopt``)
    places an admitted small job of the same user onto the gang's free
    slots instead of waiting for whole nodes. Tasks are therefore keyed
    ``(jobk, task_id)`` internally — jobk 0 is the job the gang was
    allocated for, adopted jobs get fresh jobk values — and results are
    split back per job on completion.
    """

    def __init__(self, sched: "TriplesScheduler", user: str,
                 tasks: List[Task], trip: T.Triples, nodes: List[int],
                 checkpoint: Optional[GangCheckpoint] = None,
                 slices: Optional[Tuple[object, Tuple[int, ...]]] = None,
                 incarnation: int = 0):
        self.sched = sched
        self.user = user
        self.trip = trip
        self.nodes = nodes
        # per-jobk gang restart count (exported as TaskCtx.incarnation);
        # jobk 0 is the hosted job, adopt() records the adopted jobs'
        self.incarnations: Dict[int, int] = {0: incarnation}
        # (jobk, task_id) keys whose task raised TaskWedged: the hung
        # process still occupies its slot, so the key stays at the head
        # of its queue and step_round skips it — only a gang restart
        # (watchdog preempt -> elastic resume) clears it (DESIGN.md §15).
        # Membership-only set; sorted() wherever it is emitted.
        self.wedged: set = set()
        self.slices = slices            # (SliceConfig, owned indices) when
                                        # this gang runs INSIDE spatial
                                        # slices of its node (DESIGN.md §10)
        self.t_start = time.perf_counter()  # lint: disable=DET001(telemetry anchor for reported wall_s; never read by a dispatch decision)
        self.t_starts: Dict[int, float] = {0: self.t_start}
        self.results: Dict[Tuple[int, int], Any] = {}
        self.failed: Dict[Tuple[int, int], str] = {}
        self.by_key: Dict[Tuple[int, int], Task] = {
            (0, t.id): t for t in tasks}
        self._next_jobk = 1
        # jobk -> (pack_factor, bytes_per_lane) of jobs adopted onto this
        # gang and still running — the admission veto must count them all
        self.adopted_pack: Dict[int, Tuple[int, float]] = {}
        plan = T.plan(len(tasks), trip, sched.cluster.node_spec,
                      alive_nodes=nodes, slices=slices)
        ids = [t.id for t in tasks]
        self.queues: Dict[T.SlotAssignment, List[Tuple[int, int]]] = {
            s: [(0, ids[i]) for i in s.task_ids] for s in plan.slots}
        self.pending_retry: List[Tuple[int, int]] = []
        if checkpoint is not None:      # resume: pre-seed completed work
            for tid, v in checkpoint.results.items():
                self.results[(0, tid)] = v
            for tid, err in checkpoint.failed.items():
                self.failed[(0, tid)] = err

    @property
    def finished(self) -> bool:
        return not any(self.queues.values()) and not self.pending_retry

    def job_finished(self, jobk: int) -> bool:
        """True when no task of ``jobk`` is queued or awaiting retry."""
        if any(k[0] == jobk for k in self.pending_retry):
            return False
        return not any(k[0] == jobk for q in self.queues.values() for k in q)

    def remaining_rounds(self) -> int:
        """Upper bound on rounds to completion (longest slot queue)."""
        longest = max((len(q) for q in self.queues.values()), default=0)
        return longest + (1 if self.pending_retry else 0)

    def node_weight(self) -> float:
        """Node-equivalents this gang occupies per round — what fair-share
        charging bills. Whole-node gangs pay ``nnode``; a slice-hosted
        gang pays only the chip fraction of the slices it holds (the
        index tuple repeats an index per lane — count each slice once)."""
        if self.slices is None:
            return float(self.trip.nnode)
        config, indices = self.slices
        return float(sum(config.slices[i].chip_frac
                         for i in dict.fromkeys(indices)))

    # ------------------------------------------------- lane-level backfill
    def free_slot_count(self) -> int:
        """Slots on alive nodes whose queues have drained — the lanes a
        backfilled job may claim."""
        return sum(1 for s, q in self.queues.items()
                   if not q and s.node not in self.sched.cluster.down)

    def lane_counts(self) -> Tuple[int, int]:
        """(busy_slots, total_alive_slots) — the occupancy sample."""
        alive = [(s, q) for s, q in self.queues.items()
                 if s.node not in self.sched.cluster.down]
        busy = sum(1 for _, q in alive if q)
        return busy, len(alive)

    def adopt(self, tasks: List[Task], lanes: Optional[int] = None,
              incarnation: int = 0) -> int:
        """Attach another job's tasks round-robin onto (at most ``lanes``
        of) the free slots. Returns the jobk the tasks are keyed under.
        ``lanes`` must honour the grant from pop_lane_backfill — several
        jobs may be granted disjoint lane shares of one gang in a round."""
        jobk = self._next_jobk
        self._next_jobk += 1
        self.incarnations[jobk] = incarnation
        self.t_starts[jobk] = time.perf_counter()  # lint: disable=DET001(telemetry anchor for per-job wall_s; never read by a dispatch decision)
        free = [s for s, q in self.queues.items()
                if not q and s.node not in self.sched.cluster.down]
        if lanes is not None:
            free = free[:lanes]
        if not free:
            raise RuntimeError("lane backfill onto a gang with no free slot")
        for i, t in enumerate(tasks):
            self.by_key[(jobk, t.id)] = t
            self.queues[free[i % len(free)]].append((jobk, t.id))
        return jobk

    # -------------------------------------------------------------- rounds
    def step_round(self) -> bool:
        """One cooperative round: ≤1 task per slot, then retry handling.
        Returns False when no progress is possible (deadlock guard)."""
        cluster = self.sched.cluster
        progressed = False
        for slot, q in self.queues.items():
            if slot.node in cluster.down:
                orphans = [k for k in q if k not in self.results]
                q.clear()
                self.pending_retry.extend(orphans)
                continue
            if not q:
                continue
            if q[0] in self.wedged:
                continue            # hung task pins this slot; only the
                                    # watchdog restart path unblocks it
            key = q.pop(0)
            progressed = True
            self.sched._run_one(self, key, self.by_key[key], slot)
        if self.pending_retry:
            self._replan()
            return True
        return progressed

    def _replan(self):
        """Node-loss / retry re-planning over this gang's alive nodes."""
        cluster = self.sched.cluster
        alive = [n for n in self.nodes if n not in cluster.down]
        if not alive:
            for key in self.pending_retry:
                self.failed[key] = "no alive nodes"
            self.pending_retry.clear()
            for q in self.queues.values():
                for key in q:
                    self.failed[key] = "no alive nodes"
            self.queues = {}
            return
        # drain EVERY outstanding queue too — the fresh plan covers
        # all remaining work, not just the retried tasks
        outstanding = list(self.pending_retry)
        for q in self.queues.values():
            outstanding.extend(q)
        replanned = T.plan(len(outstanding), self.trip,
                           cluster.node_spec, alive_nodes=alive,
                           slices=self.slices)
        self.sched._log("replan", tasks=list(outstanding), nodes=alive)
        remap = {i: key for i, key in enumerate(outstanding)}
        self.pending_retry = []
        self.queues = {s: [remap[i] for i in s.task_ids]
                       for s in replanned.slots}

    # ---------------------------------------------------------- preemption
    def checkpoint(self, job_id: int) -> GangCheckpoint:
        """Snapshot job 0's progress cursors for preemption. Adopted jobs
        must have drained first (victim selection guarantees it)."""
        remaining = sorted(
            {k[1] for q in self.queues.values() for k in q if k[0] == 0}
            | {k[1] for k in self.pending_retry if k[0] == 0})
        return GangCheckpoint(
            job_id=job_id, user=self.user,
            results={k[1]: v for k, v in self.results.items()
                     if k[0] == 0},
            failed={k[1]: v for k, v in self.failed.items() if k[0] == 0},
            remaining=remaining,
            retries={tid: self.by_key[(0, tid)].retries
                     for tid in remaining},
            nnode=len(self.nodes))

    # ------------------------------------------------------------- results
    def job_result(self, jobk: int, alloc_cycles: int,
                   wait_rounds: int = 0) -> JobResult:
        """Split this job's share of the gang's results out by task id."""
        return JobResult(
            results={k[1]: v for k, v in self.results.items()
                     if k[0] == jobk},
            failed={k[1]: v for k, v in self.failed.items() if k[0] == jobk},
            events=self.sched.events, alloc_cycles=alloc_cycles,
            wall_s=time.perf_counter()  # lint: disable=DET001(reported wall_s is telemetry; decisions use round counts)
            - self.t_starts.get(jobk, self.t_start),
            wait_rounds=wait_rounds)

    def release(self):
        cluster = self.sched.cluster
        if self.slices is not None:     # slice-hosted: free our slices only
            _, raw = self.slices
            indices = tuple(dict.fromkeys(raw))   # de-weight repeats
            node = self.nodes[0]
            tn = self.sched.tenancy
            for i in indices:
                if node not in cluster.down:
                    cluster.release_slice(node, i)
                if tn is not None and tn.gauges is not None:
                    tn.gauges.on_slice_release(node, i)
            self.sched._log("release_slices", node=node,
                            slices=list(indices))
            return
        cluster.release([n for n in self.nodes if n not in cluster.down])
        self.sched._log("release", nodes=self.nodes)

    def finish(self, alloc_cycles: int, wait_rounds: int = 0) -> JobResult:
        """Single-job path: release the gang and return job 0's result."""
        self.release()
        return self.job_result(0, alloc_cycles, wait_rounds)


# ---------------------------------------------------------------------------
# tenancy bundle
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Tenancy:
    """Fair-share queue + admission control wired into the scheduler."""
    queue: ten.JobQueue
    admission: Optional[ten.MemoryAdmission] = None
    gauges: Optional["TenantGauges"] = None    # core.monitor.TenantGauges
    preemption: Optional[ten.PreemptionPolicy] = None
    planner: Optional[spatial.ModePlanner] = None   # spatial mode planner
                                                    # (DESIGN.md §10)

    @classmethod
    def create(cls, quotas: Optional[Dict[str, ten.TenantQuota]] = None,
               node_spec: Optional[T.NodeSpec] = None,
               admission_headroom: float = 0.9,
               half_life: Optional[float] = None,
               gauges: Optional["TenantGauges"] = None,
               preemption: Optional[ten.PreemptionPolicy] = None,
               planner: Optional[spatial.ModePlanner] = None
               ) -> "Tenancy":
        acct = ten.FairShareAccountant(quotas, half_life=half_life)
        adm = ten.MemoryAdmission(node_spec, headroom=admission_headroom) \
            if node_spec is not None else ten.MemoryAdmission(
                headroom=admission_headroom)
        if planner is not None and planner.admission is not adm:
            # one admission object end-to-end: the planner's slice caps
            # and submit's pack caps must read the same measured
            # footprints, or the two frontiers drift apart
            planner = spatial.ModePlanner(
                adm.node_spec, adm,
                base_slowdown=planner.base_slowdown,
                reconfig_latency_s=planner.reconfig_latency_s,
                max_pack_per_chip=planner.max_pack_per_chip,
                min_grant_frac=planner.min_grant_frac,
                configs=planner.configs,
                interference=planner.interference)
        return cls(queue=ten.JobQueue(acct), admission=adm, gauges=gauges,
                   preemption=preemption, planner=planner)

    @property
    def accountant(self) -> ten.FairShareAccountant:
        return self.queue.accountant


@dataclasses.dataclass
class _RQState:
    """Live state of one ``run_queued`` drain — the explicit contract
    between the round loop and ``preempt()``/``_maybe_preempt()``."""
    runs: Dict[int, "_GangRun"] = dataclasses.field(default_factory=dict)
    hosts: Dict[int, GangJob] = dataclasses.field(default_factory=dict)
    placed: Dict[int, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)              # job id -> (run id, jobk)
    active_jobs: Dict[int, GangJob] = dataclasses.field(
        default_factory=dict)
    dispatch_round: Dict[int, int] = dataclasses.field(
        default_factory=dict)              # latest (re)dispatch: charging
    first_dispatch: Dict[int, int] = dataclasses.field(
        default_factory=dict)              # first dispatch: wait anchor
                                           # (matches the simulator's
                                           # SimJobStats.start_t)
    submit_round: Dict[int, int] = dataclasses.field(
        default_factory=dict)              # original submission round
    queued_since: Dict[int, int] = dataclasses.field(
        default_factory=dict)              # starvation clock — reset when
                                           # a preempted job requeues so a
                                           # fresh victim can't look
                                           # instantly starved itself
    charged_rounds: Dict[int, int] = dataclasses.field(
        default_factory=dict)              # run id -> rounds charged
    granted_lanes: Dict[int, int] = dataclasses.field(
        default_factory=dict)              # job id -> lanes gauged
    last_progress: Dict[int, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)              # run id -> (tasks settled,
                                           # round of last growth) — the
                                           # watchdog's heartbeat state
    rnd: int = 0
    in_execution: bool = False             # inside the step_round phase —
                                           # preempt() must refuse (it
                                           # mutates runs mid-iteration)


class TriplesScheduler:
    def __init__(self, cluster: ClusterState,
                 policy: Optional[FaultPolicy] = None,
                 tenancy: Optional[Tenancy] = None,
                 checkpoint_dir: Optional[str] = None,
                 event_sink: Optional[Callable[[str, dict], None]] = None,
                 task_executor: Optional[Callable[[Task, TaskCtx], Any]]
                 = None):
        self.cluster = cluster
        self.policy = policy or FaultPolicy()
        self.tenancy = tenancy
        self.checkpoint_dir = checkpoint_dir
        # control-plane seams (core/controlplane.py, DESIGN.md §15):
        # ``event_sink(kind, detail)`` mirrors every _log call into the
        # durable event log; ``task_executor(task, ctx)`` interposes task
        # execution so recovery can replay recorded outcomes. Both are
        # pure pass-throughs when None — the scheduler never branches on
        # them, which is what keeps logging decision-neutral.
        self.event_sink = event_sink
        self.task_executor = task_executor
        self.events: List[Event] = []
        self._alloc_cycles = 0
        self._jobs: Dict[int, GangJob] = {}
        self._next_job_id = 0
        self._rq: Optional[_RQState] = None      # live run_queued state
        self._gang_cks: Dict[int, Any] = {}      # job id -> Checkpointer

    # ------------------------------------------------------------------ util
    def _log(self, kind: str, **detail):
        self.events.append(Event(time.perf_counter(), kind, detail))  # lint: disable=DET001(event-log timestamps are observability only; replay orders by append sequence)
        if self.event_sink is not None:
            # the durable record carries NO timestamp — replay equality
            # is over (seq, kind, detail) only (core/eventlog.py)
            self.event_sink(kind, detail)

    def _persist_gang(self, job_id: int, ckpt: GangCheckpoint, rnd: int):
        """Write the gang's progress cursors through the Checkpointer —
        FaultPolicy.checkpoint_every honored on the scheduler path, the
        same atomic step layout the sweep's per-task checkpoints use."""
        if self.checkpoint_dir is None:
            return
        from repro_torch.checkpoint import Checkpointer
        if job_id not in self._gang_cks:
            self._gang_cks[job_id] = Checkpointer(
                f"{self.checkpoint_dir}/gang_{job_id}")
        self._gang_cks[job_id].save({}, rnd, extra=ckpt.cursor_extra())

    # ------------------------------------------------------- triples submit
    def run_triples_job(self, user: str, tasks: List[Task],
                        trip: T.Triples,
                        bytes_per_lane: float = 0.0) -> JobResult:
        """ONE allocation for the gang; child tasks run from the generated
        plan. Returns when every task is done/failed-permanently. Under
        tenancy, this routes through submit + run_queued (the allocation
        passes the fair-share queue and admission control)."""
        if self.tenancy is not None:
            job = self.submit(user, tasks, trip, bytes_per_lane)
            if job.state == "rejected":
                if job.reject_reason.startswith("gang needs"):
                    raise RuntimeError(job.reject_reason)
                raise MemoryError(job.reject_reason)
            self.run_queued()
            if job.result is None:      # queue stalled: gang never dispatched
                raise RuntimeError("insufficient free nodes for gang")
            return job.result
        nodes = self.cluster.allocate(user, trip.nnode)
        if nodes is None:
            raise RuntimeError("insufficient free nodes for gang")
        self._alloc_cycles += 1
        self._log("alloc", user=user, nodes=nodes,
                  triples=dataclasses.astuple(trip))
        run = _GangRun(self, user, tasks, trip, nodes)
        while not run.finished:
            if not run.step_round():
                break
        return run.finish(self._alloc_cycles)

    # ----------------------------------------------------- multi-tenant path
    def submit(self, user: str, tasks: List[Task], trip: T.Triples,
               bytes_per_lane: float = 0.0,
               interference: float = 0.0, kind: str = "",
               intensity_profile: Optional[Any] = None) -> GangJob:
        """Enqueue a gang job for the fair-share queue (requires tenancy).

        Memory-aware admission runs HERE — an over-footprint pack_factor is
        rejected before it ever holds a node (vs. the paper's 21/48 tasks
        dead on CUDA OOM after dispatch). When a repack event has reported
        a MEASURED per-lane footprint for this user
        (MemoryAdmission.record_measured — core/repack.py closes the
        loop), admission consumes ``effective_bytes``: the measurement
        TIGHTENS the decision when the live footprint grew past the
        compile-time profile and fills in an unknown profile, but never
        relaxes a pessimistic static profile (the measurement is keyed
        per tenant and may come from a different job of theirs).

        ``intensity_profile`` (roofline.IntensityProfile of the job's
        compiled step, e.g. ``IntensityProfile.from_compiled``) closes
        the same loop for the PLANNER: its memory-bound fraction is
        recorded into admission at the job's first dispatch
        (``record_intensity``) so later mode decisions for this tenant —
        and for the whole ``kind`` family when one is named — price
        interference from what the program measurably does on the chip
        instead of the occupancy proxy."""
        if self.tenancy is None:
            raise RuntimeError("submit() requires a Tenancy; use "
                               "run_triples_job for the single-user path")
        adm = self.tenancy.admission
        if adm is not None:
            bytes_per_lane = adm.effective_bytes(user, bytes_per_lane)
        job = GangJob(id=self._next_job_id, user=user, tasks=tasks,
                      trip=trip, bytes_per_lane=bytes_per_lane,
                      interference=interference, kind=kind,
                      intensity_profile=intensity_profile)
        self._next_job_id += 1
        self._jobs[job.id] = job
        if trip.nnode > self.cluster.n_nodes:
            job.state = "rejected"
            job.reject_reason = (f"gang needs {trip.nnode} nodes, cluster "
                                 f"has {self.cluster.n_nodes}")
            self._log("reject", job=job.id, user=user,
                      reason=job.reject_reason)
            return job
        if adm is not None and bytes_per_lane > 0:
            decision = adm.admit(trip, bytes_per_lane)
            if not decision.admitted:
                job.state = "rejected"
                job.reject_reason = decision.reason
                self._log("reject", job=job.id, user=user,
                          reason=decision.reason)
                if self.tenancy.gauges is not None:
                    self.tenancy.gauges.on_reject(user)
                return job
        est = math.ceil(len(tasks) / trip.total_slots) if tasks else 0
        self.tenancy.queue.push(ten.PendingJob(
            id=job.id, user=user, n_nodes=trip.nnode,
            submit_seq=self.tenancy.queue.next_seq(),
            est_duration=float(est), bytes_per_lane=bytes_per_lane,
            n_slots=trip.total_slots, n_tasks=len(tasks), payload=job))
        self._log("submit", job=job.id, user=user, nodes=trip.nnode)
        return job

    def _record_intensity(self, job: GangJob):
        """First-dispatch hook: flow the job's roofline IntensityProfile
        into admission (keyed by owner, and by ``kind:<kind>`` when the
        job names a family) — the planner-side mirror of repack's
        ``record_measured``. Idempotent; later dispatches of the same
        profile just rewrite the same number."""
        adm = self.tenancy.admission if self.tenancy else None
        prof = job.intensity_profile
        if adm is None or prof is None:
            return
        frac = float(prof.interference)
        adm.record_intensity(job.user, frac)
        if job.kind:
            adm.record_intensity(f"kind:{job.kind}", frac)

    def _lane_backfill_admit(self, runs: Dict[int, "_GangRun"],
                             hosts: Dict[int, GangJob]):
        """Predicate for JobQueue.pop_lane_backfill: the combined per-chip
        footprint of host + adopted lanes must fit the admission budget
        (conservative: both at the larger per-lane footprint)."""
        adm = self.tenancy.admission if self.tenancy else None

        def admit(pj: ten.PendingJob, run_id: int) -> bool:
            if adm is None:
                return True
            host = hosts[run_id]
            run = runs[run_id]
            job: GangJob = pj.payload
            spec = adm.node_spec
            co = [(host.trip.pack_factor(spec), float(host.bytes_per_lane)),
                  *run.adopted_pack.values(),
                  (job.trip.pack_factor(spec), float(pj.bytes_per_lane))]
            return adm.admit_colocated([p for p, _ in co],
                                       [b for _, b in co])

        return admit

    # ------------------------------------------------------ spatial phase
    def _spatial_dispatch(self, st: _RQState):
        """Mode-planned spatial dispatch (DESIGN.md §10): consult the
        mode planner for queued single-node jobs; if isolation wins,
        partition a free node into slices — single-job isolation on a
        quiet cluster (a memory-bound job's OWN lanes stop thrashing
        each other), co-tenant grouping only under contention, and
        never past an EASY head reservation or a tenant's ``max_nodes``
        (the selection policy is ``spatial.select_spatial_group``,
        shared with the simulator). Runs before the whole-node phase
        each round.

        A job carrying a GangCheckpoint rehydrates on its slices exactly
        as it would on whole-node lanes — the checkpoint is
        placement-agnostic (results + remaining cursors), which is what
        makes the lanes↔slices round trip bit-identical."""
        tn = self.tenancy
        planner = tn.planner
        if planner is None or not len(tn.queue):
            return
        max_group = planner.max_group
        skipped: set = set()
        while True:
            free = self.cluster.free_nodes()
            group, avail = spatial.select_spatial_group(
                tn.queue.ordered(), len(free), self.cluster.held_counts(),
                lambda u: tn.accountant.quota(u).max_nodes,
                max_group, skipped,
                eligible_fn=lambda pj: isinstance(pj.payload, GangJob))
            if not group:
                return
            k = len(group)
            profiles = []
            adm = tn.admission
            for pj in group:
                job: GangJob = pj.payload
                intensity = job.interference
                # a roofline-MEASURED memory-bound fraction (recorded at
                # first dispatch) replaces the occupancy proxy; the EWMA
                # only speaks for jobs nothing has measured yet
                measured = None
                if adm is not None:
                    if job.kind:
                        measured = adm.measured_intensity(f"kind:{job.kind}")
                    if measured is None:
                        measured = adm.measured_intensity(job.user)
                if measured is not None:
                    intensity = max(intensity, measured)
                elif tn.gauges is not None:
                    intensity = max(intensity,
                                    tn.gauges.user_occupancy(job.user))
                profiles.append(spatial.JobProfile(
                    job_id=job.id, user=job.user,
                    n_tasks=pj.n_tasks or len(job.tasks) or 1,
                    bytes_per_lane=pj.bytes_per_lane,
                    intensity=min(1.0, intensity),
                    want_lanes=pj.n_slots or len(job.tasks) or 1,
                    kind=job.kind))
            decision = planner.plan_node(profiles)
            if decision.mode != "spatial":
                if k == 1:              # this job prefers temporal: let it
                    skipped.add(group[0].id)    # dispatch, try the next
                else:                   # group vetoed (e.g. min_grant_frac)
                    max_group = 1       # — still try single-job isolation
                continue
            node = free[0]
            self.cluster.partition_node(node, decision.config)
            self._alloc_cycles += 1
            self._log("partition", node=node, config=decision.config.name,
                      jobs=[pj.id for pj in group])
            for pj in tn.queue.take([p.id for p in group]):
                job = pj.payload
                # expand per-slice lane counts into one index entry per
                # lane, so the plan puts EXACTLY the admitted number of
                # slots on each slice (an admission-capped small slice
                # must never receive extra round-robin spill)
                indices = tuple(
                    p.slice_index
                    for p in decision.placements if p.job_id == job.id
                    for _ in range(p.lanes))
                lanes = max(1, len(indices))
                for i in decision.slices_of(job.id):
                    self.cluster.allocate_slice(job.user, node, i)
                trip_eff = T.Triples(1, lanes, 1)
                ckpt = job.checkpoint
                if ckpt is not None:    # rehydrate lanes -> slices
                    rem = {t.id for t in job.tasks} & set(ckpt.remaining)
                    tasks = [t for t in job.tasks if t.id in rem]
                    job.checkpoint = None
                    if tn.gauges is not None:
                        tn.gauges.on_resume(job.user)
                else:
                    tasks = job.tasks
                run = _GangRun(self, job.user, tasks, trip_eff, [node],
                               checkpoint=ckpt,
                               slices=(decision.config, indices),
                               incarnation=job.preemptions)
                job.state = "running"
                st.runs[job.id] = run
                st.hosts[job.id] = job
                st.placed[job.id] = (job.id, 0)
                st.active_jobs[job.id] = job
                st.dispatch_round[job.id] = st.rnd
                st.granted_lanes[job.id] = lanes
                first = job.id not in st.first_dispatch
                st.first_dispatch.setdefault(job.id, st.rnd)
                if first:
                    self._record_intensity(job)
                self._log("spatial_dispatch", job=job.id, user=job.user,
                          node=node, slices=list(indices), lanes=lanes,
                          resumed=ckpt is not None)
                if tn.gauges is not None:
                    for p in decision.placements:
                        if p.job_id == job.id:
                            tn.gauges.on_slice_alloc(
                                job.user, node, p.slice_index,
                                p.chip_frac, p.hbm_frac, p.lanes)
                    tn.gauges.on_dispatch(
                        job.user, nodes=0, lanes=lanes,
                        resident_bytes=int(job.bytes_per_lane * lanes),
                        wait=float(st.rnd - st.submit_round.get(job.id, 0))
                        if first else None)

    # ----------------------------------------------------------- preemption
    def preempt(self, run_id: int) -> GangCheckpoint:
        """Checkpoint a running gang off its nodes and requeue it.

        The gang's progress (results + remaining-task cursors) becomes a
        GangCheckpoint on its GangJob; its whole-node allocation is
        released immediately, the owner is charged for the rounds it
        held, and the job re-enters the fair-share queue with an ELASTIC
        width (``PreemptionPolicy.min_nodes``) so it can resume the
        moment partial capacity frees — replanning the remaining tasks
        over however many nodes it is granted. Only callable BETWEEN
        phases of a ``run_queued`` round (the preemption policy drives
        it) — never from inside a task closure, whose gang is mid
        ``step_round`` over the very registry this mutates. A gang
        currently hosting lane-backfilled jobs of other submissions
        cannot be preempted — victim selection filters those out.
        """
        st = self._rq
        if st is None or run_id not in st.runs:
            raise RuntimeError(f"no active gang run {run_id} to preempt")
        if st.in_execution:
            raise RuntimeError(
                "preempt() called from inside the execution phase (a task "
                "closure?); preemption happens between rounds")
        if any(st.placed[jid][0] == run_id and st.placed[jid][1] != 0
               for jid in st.active_jobs):
            raise RuntimeError(
                f"gang {run_id} hosts lane-backfilled jobs; not preemptible")
        tn = self.tenancy
        run: _GangRun = st.runs.pop(run_id)
        job: GangJob = st.hosts.pop(run_id)
        rnd = st.rnd
        ckpt = run.checkpoint(job.id)
        job.checkpoint = ckpt
        job.preemptions += 1
        job.state = "queued"
        # charge the victim for the rounds it actually EXECUTED —
        # preemption runs before this round's execution phase, so round
        # ``rnd`` never happens for this gang (the completion path's
        # ``rnd + 1`` is right only because a finishing gang did step)
        rounds_held = max(0, rnd - st.dispatch_round[job.id])
        node_time = float(run.node_weight() * rounds_held)
        tn.accountant.charge(job.user, node_time)
        st.charged_rounds.pop(run_id, None)
        st.last_progress.pop(run_id, None)   # heartbeat state dies with
                                             # the run (a resume must not
                                             # inherit stale silence)
        lanes_held = st.granted_lanes.get(
            job.id, run.trip.nnode * job.trip.nppn) \
            if run.slices is not None else run.trip.nnode * job.trip.nppn
        if tn.gauges is not None:
            tn.gauges.on_preempt(
                job.user,
                nodes=run.trip.nnode if run.slices is None else 0,
                node_time=node_time, lanes=lanes_held,
                resident_bytes=int(job.bytes_per_lane * lanes_held))
            tn.gauges.on_gang_done(f"gang:{run_id}")
        self._persist_gang(job.id, ckpt, rnd)
        run.release()
        st.active_jobs.pop(job.id, None)
        st.placed.pop(job.id, None)
        pol = tn.preemption or ten.PreemptionPolicy()
        est = math.ceil(len(ckpt.remaining) / job.trip.total_slots) \
            if ckpt.remaining else 0
        tn.queue.push(ten.PendingJob(
            id=job.id, user=job.user, n_nodes=job.trip.nnode,
            submit_seq=tn.queue.next_seq(), est_duration=float(est),
            bytes_per_lane=job.bytes_per_lane, n_slots=job.trip.total_slots,
            n_tasks=len(ckpt.remaining),
            min_nodes=pol.min_nodes(job.trip.nnode), payload=job))
        st.queued_since[job.id] = rnd
        self._log("preempt", job=job.id, user=job.user,
                  remaining=len(ckpt.remaining), done=len(ckpt.results),
                  rounds_held=rounds_held)
        return ckpt

    def _maybe_preempt(self) -> bool:
        """One preemption per round, driven by the fair-share policy: the
        longest-waiting starved tenant may evict the cheapest over-share
        victim (lowest remaining-work / over-share)."""
        tn = self.tenancy
        st = self._rq
        pol = tn.preemption
        if pol is None or not len(tn.queue):
            return False
        rnd = st.rnd
        candidates = []
        for rid, run in st.runs.items():
            if rid not in st.active_jobs:
                continue                # host done; gang drains adopted work
            if any(st.placed[jid][0] == rid and st.placed[jid][1] != 0
                   for jid in st.active_jobs):
                continue                # hosting backfilled jobs: skip
            candidates.append((rid, run.user,
                               float(run.node_weight()
                                     * run.remaining_rounds()),
                               st.hosts[rid].preemptions))
        if not candidates:
            return False
        # in-flight consumption: node-rounds held by each user's running
        # gangs but not yet charged (the accountant bills at release)
        accrued: Dict[str, float] = {}
        for rid, run in st.runs.items():
            held = run.node_weight() * max(
                1, rnd + 1 - st.dispatch_round.get(rid, rnd))
            accrued[run.user] = accrued.get(run.user, 0.0) + float(held)
        for pj in tn.queue.ordered():
            waited = rnd - st.queued_since.get(
                pj.id, st.submit_round.get(pj.id, 0))
            if waited < pol.wait_threshold:
                continue
            victim = pol.choose_victim(tn.accountant, pj.user, candidates,
                                       accrued=accrued)
            if victim is not None:
                self.preempt(victim)
                return True
        return False

    def _watchdog(self) -> bool:
        """Health watchdog (DESIGN.md §15): a gang that has completed no
        task for ``FaultPolicy.wedge_timeout_rounds`` consecutive rounds
        is treated as wedged — its heartbeat (monitor.on_heartbeat) went
        silent — and is force-restarted through preempt + elastic
        resume, which bumps the gang incarnation and so relaunches any
        hung task. This is fault recovery, not fairness pressure: it
        bypasses PreemptionPolicy.max_preemptions and runs even with no
        waiter starving. Returns True when any gang was restarted."""
        timeout = self.policy.wedge_timeout_rounds
        if not timeout:
            return False
        st = self._rq
        tn = self.tenancy
        restarted = False
        for rid in list(st.runs):
            if rid not in st.active_jobs or rid not in st.last_progress:
                continue                # resumed this round / host done
            silent = st.rnd - st.last_progress[rid][1]
            if silent < timeout:
                continue
            if any(st.placed[jid][0] == rid and st.placed[jid][1] != 0
                   for jid in st.active_jobs):
                continue                # hosting backfilled jobs: cannot
                                        # preempt; the livelock guard in
                                        # run_queued backstops this case
            run = st.runs[rid]
            self._log("wedge_timeout", job=rid, user=run.user,
                      silent_rounds=silent,
                      wedged=sorted(list(k) for k in run.wedged))
            if tn.gauges is not None:
                tn.gauges.on_watchdog_restart(run.user)
            self.preempt(rid)
            restarted = True
        return restarted

    def run_queued(self) -> Dict[int, JobResult]:
        """Drain the pending queue, executing admitted gangs CONCURRENTLY.

        Each cooperative round: (1) dispatch every job the fair-share +
        backfill policy allows onto strictly-disjoint fresh nodes, (2)
        lane-backfill queued jobs onto free lanes of gangs their user
        already runs (zero extra nodes — see JobQueue.pop_lane_backfill),
        (3) step every active gang one task-round. Completed gangs release
        nodes and charge node-rounds to their tenant's fair-share usage;
        a lane-backfilled job charges nothing extra, because its user is
        already paying for the host gang's nodes. Deterministic — no
        threads, no clocks in the policy path."""
        tn = self.tenancy
        if tn is None:
            raise RuntimeError("run_queued() requires a Tenancy")
        st = self._rq = _RQState(
            submit_round={j.id: 0 for j in tn.queue.ordered()})
        runs = st.runs                          # run id -> gang runtime
        hosts = st.hosts                        # run id -> job 0
        placed = st.placed                      # job id -> (run id, jobk)
        active_jobs = st.active_jobs
        granted_lanes = st.granted_lanes        # job id -> lanes gauged
        charged_rounds = st.charged_rounds      # run id -> rounds charged
        dispatch_round = st.dispatch_round
        submit_round = st.submit_round
        done: Dict[int, JobResult] = {}
        rnd = 0
        idle_rounds = 0
        while len(tn.queue) or active_jobs:
            st.rnd = rnd
            events_before = len(self.events)
            # spatial phase: under contention the mode planner may
            # partition a free node and start several queued jobs in
            # isolated slices (DESIGN.md §10) before whole-node dispatch
            self._spatial_dispatch(st)
            # dispatch phase: whole-node allocations. Slice-hosted gangs
            # report their chip FRACTION to the shadow analysis — a
            # whole-node-each view would overestimate the nodes freeing
            # and let backfill delay the reserved head gang
            running_view = [(run.node_weight(),
                             float(run.remaining_rounds()))
                            for run in runs.values()]
            for pj in tn.queue.pop_dispatchable(
                    self.cluster.free_count(), running_view,
                    held_by_user=self.cluster.held_counts()):
                job: GangJob = pj.payload
                granted = pj.granted_nodes or job.trip.nnode
                nodes = self.cluster.allocate(job.user, granted, fresh=True)
                if nodes is None:       # race with node failure: requeue
                    tn.queue.push(pj)
                    continue
                self._alloc_cycles += 1
                job.state = "running"
                if job.checkpoint is not None:  # resume, possibly narrower
                    ckpt = job.checkpoint
                    trip_eff = dataclasses.replace(job.trip, nnode=granted)
                    rem = {t.id for t in job.tasks} & set(ckpt.remaining)
                    tasks = [t for t in job.tasks if t.id in rem]
                    run = _GangRun(self, job.user, tasks, trip_eff, nodes,
                                   checkpoint=ckpt,
                                   incarnation=job.preemptions)
                    job.checkpoint = None
                    self._log("resume", user=job.user, nodes=nodes,
                              job=job.id, width=granted,
                              full_width=job.trip.nnode,
                              remaining=len(tasks))
                    if tn.gauges is not None:
                        tn.gauges.on_resume(job.user)
                else:
                    self._log("alloc", user=job.user, nodes=nodes,
                              job=job.id,
                              triples=dataclasses.astuple(job.trip))
                    run = _GangRun(self, job.user, job.tasks, job.trip,
                                   nodes, incarnation=job.preemptions)
                runs[job.id] = run
                hosts[job.id] = job
                placed[job.id] = (job.id, 0)
                active_jobs[job.id] = job
                dispatch_round[job.id] = rnd
                # a job that previously ran on slices (spatial -> preempt
                # -> whole-node resume) must not release with its stale
                # slice-lane count: the completion path falls back to the
                # run's own width once this entry is gone
                granted_lanes.pop(job.id, None)
                first = job.id not in st.first_dispatch
                st.first_dispatch.setdefault(job.id, rnd)
                if first:
                    self._record_intensity(job)
                if tn.gauges is not None:
                    # the wait distribution samples FIRST dispatch only —
                    # a resume is the same job coming back, not a new wait
                    tn.gauges.on_dispatch(
                        job.user, nodes=granted,
                        lanes=granted * job.trip.nppn,
                        resident_bytes=int(job.bytes_per_lane
                                           * granted * job.trip.nppn),
                        wait=float(rnd - submit_round.get(job.id, 0))
                        if first else None)
            # lane-backfill phase: free lanes on same-user gangs.
            # Slice-hosted gangs are excluded: the admission predicate
            # prices co-residents against the WHOLE-chip budget, but a
            # slice's budget is its HBM fraction — adopting into a slice
            # could oversubscribe exactly what admit_slice vetoed
            lane_view: Dict[str, List[Tuple[int, int, float]]] = {}
            for rid, run in runs.items():
                if run.slices is not None:
                    continue
                free = run.free_slot_count()
                if free > 0:
                    lane_view.setdefault(run.user, []).append(
                        (rid, free, float(run.remaining_rounds())))
            if lane_view:
                for pj, rid, granted in tn.queue.pop_lane_backfill(
                        lane_view, self._lane_backfill_admit(runs, hosts)):
                    job = pj.payload
                    run = runs[rid]
                    if job.checkpoint is not None:
                        # preempted job adopted onto free lanes: only the
                        # REMAINING tasks run (pj.n_tasks, which sized the
                        # no-extension check, counts exactly these), and
                        # the checkpoint's completed results pre-seed the
                        # adopted jobk so nothing re-executes
                        ckpt = job.checkpoint
                        rem = set(ckpt.remaining)
                        tasks = [t for t in job.tasks if t.id in rem]
                        jobk = run.adopt(tasks, lanes=granted,
                                         incarnation=job.preemptions)
                        for tid, v in ckpt.results.items():
                            run.results[(jobk, tid)] = v
                        for tid, err in ckpt.failed.items():
                            run.failed[(jobk, tid)] = err
                        job.checkpoint = None
                        if tn.gauges is not None:
                            tn.gauges.on_resume(job.user)
                    else:
                        jobk = run.adopt(job.tasks, lanes=granted,
                                         incarnation=job.preemptions)
                    run.adopted_pack[jobk] = (
                        job.trip.pack_factor(self.cluster.node_spec),
                        float(job.bytes_per_lane))
                    self._log("lane_backfill", job=job.id, user=job.user,
                              host=rid, lanes=granted)
                    job.state = "running"
                    placed[job.id] = (rid, jobk)
                    active_jobs[job.id] = job
                    granted_lanes[job.id] = granted
                    dispatch_round[job.id] = rnd
                    first = job.id not in st.first_dispatch
                    st.first_dispatch.setdefault(job.id, rnd)
                    if first:
                        self._record_intensity(job)
                    if tn.gauges is not None:
                        tn.gauges.on_dispatch(
                            job.user, nodes=0, lanes=granted,
                            resident_bytes=int(job.bytes_per_lane
                                               * granted),
                            wait=float(rnd - submit_round.get(job.id, 0))
                            if first else None)
            # preemption phase: starved waiters may evict over-share gangs
            preempted = self._maybe_preempt()
            # watchdog phase: force-restart gangs whose heartbeat went
            # silent for wedge_timeout_rounds (preempt -> elastic resume)
            preempted = self._watchdog() or preempted
            if not active_jobs:
                if preempted:           # victim's nodes free next round
                    idle_rounds = 0
                    rnd += 1
                    continue
                if len(tn.queue):       # nothing dispatchable and nothing
                    self._log("stalled",  # running: cluster cannot serve
                              queued=[j.id for j in tn.queue.ordered()])
                    break
                continue
            # execution phase: one task-round per active gang
            st.in_execution = True
            for run in list(runs.values()):
                if not run.finished:
                    run.step_round()
            st.in_execution = False
            # periodic gang checkpoints (FaultPolicy.checkpoint_every on
            # the scheduler path: crash/preempt recovery cursors)
            if (self.policy.checkpoint_every and self.checkpoint_dir
                    and (rnd + 1) % self.policy.checkpoint_every == 0):
                for rid, run in runs.items():
                    self._persist_gang(rid, run.checkpoint(rid), rnd)
            if tn.gauges is not None:   # per-gang lane-occupancy samples
                for rid, run in runs.items():
                    busy, total = run.lane_counts()
                    tn.gauges.on_lane_sample(run.user, f"gang:{rid}",
                                             busy, total)
            # heartbeat phase: a gang's heartbeat is task settlement —
            # the round its results+failed count last grew. The watchdog
            # reads the silence (rounds since) at the TOP of a later
            # round; the gauges keep it visible in the gang table.
            for rid, run in runs.items():
                settled = len(run.results) + len(run.failed)
                prev = st.last_progress.get(rid)
                if prev is None or settled > prev[0]:
                    st.last_progress[rid] = (settled, rnd)
                if tn.gauges is not None:
                    tn.gauges.on_heartbeat(
                        run.user, f"gang:{rid}",
                        rnd - st.last_progress[rid][1])
            # completion phase: jobs first, then their gangs
            for jid in list(active_jobs):
                job = active_jobs[jid]
                rid, jobk = placed[jid]
                run = runs[rid]
                if not run.job_finished(jobk):
                    continue
                # wait anchors at FIRST dispatch (the simulator's
                # SimJobStats.start_t convention): a preempted job's
                # requeue time is overhead on its span, not queue wait
                wait = st.first_dispatch.get(
                    jid, dispatch_round[jid]) - submit_round.get(jid, 0)
                job.result = run.job_result(jobk, self._alloc_cycles,
                                            wait_rounds=wait)
                job.result.preemptions = job.preemptions
                run.adopted_pack.pop(jobk, None)
                job.state = "done"
                rounds_held = max(1, rnd + 1 - dispatch_round[jid])
                is_host = jobk == 0
                # a lane-backfilled job ran on nodes its user already pays
                # for via the host gang — no extra node-time is charged.
                # run.node_weight(), not job.trip: a resumed gang may hold
                # FEWER nodes than requested (elastic resize), and a
                # slice-hosted gang holds only a chip FRACTION — both pay
                # for what they hold
                node_time = run.node_weight() * rounds_held if is_host \
                    else 0.0
                if is_host:
                    charged_rounds[rid] = rounds_held
                tn.accountant.charge(job.user, node_time)
                lanes = granted_lanes.get(
                    jid, run.trip.total_slots if is_host
                    else job.trip.total_slots)
                if tn.gauges is not None:
                    tn.gauges.on_release(
                        job.user,
                        nodes=run.trip.nnode
                        if is_host and run.slices is None else 0,
                        node_time=float(node_time),
                        lanes=lanes,
                        resident_bytes=int(job.bytes_per_lane * lanes))
                done[jid] = job.result
                self._log("complete", job=jid, user=job.user)
                del active_jobs[jid]
            for rid in list(runs):      # release fully-drained gangs
                run = runs[rid]
                if run.finished and not any(
                        placed[jid][0] == rid for jid in active_jobs):
                    # an adopted job that outlived the host (retries,
                    # replans) kept the nodes held past the host's own
                    # completion: charge the gang's user for those rounds
                    total_rounds = max(1, rnd + 1 - dispatch_round[rid])
                    extra = total_rounds - charged_rounds.pop(
                        rid, total_rounds)
                    if extra > 0:
                        tail_time = float(run.node_weight() * extra)
                        tn.accountant.charge(run.user, tail_time)
                        if tn.gauges is not None:
                            tn.gauges.gauge(run.user).node_time += tail_time
                    run.release()
                    if tn.gauges is not None:
                        tn.gauges.on_gang_done(f"gang:{rid}")
                    del runs[rid]
                    del hosts[rid]
            # livelock guard: the loop is deterministic, so a round that
            # emitted NO event will repeat identically forever (every
            # head task wedged with the watchdog off, or a wedged gang
            # the watchdog cannot preempt). Raise instead of spinning.
            if len(self.events) == events_before:
                idle_rounds += 1
                if idle_rounds >= max(2,
                                      self.policy.wedge_timeout_rounds + 2):
                    raise RuntimeError(
                        f"run_queued livelocked: {idle_rounds} identical "
                        f"no-progress rounds — wedged tasks with no "
                        f"watchdog? set FaultPolicy.wedge_timeout_rounds")
            else:
                idle_rounds = 0
            rnd += 1
        self._rq = None
        return done

    def _run_one(self, run: _GangRun, key: Tuple[int, int], task: Task,
                 slot: T.SlotAssignment):
        ctx = TaskCtx(task_id=task.id, node=slot.node, slot=slot.slot,
                      chips=slot.chips, pack_lane=slot.pack_lane,
                      ntpp=run.trip.ntpp, slice=slot.slice,
                      incarnation=run.incarnations.get(key[0], 0))
        self._log("dispatch", task=task.id, node=slot.node, slot=slot.slot,
                  chips=slot.chips)
        try:
            task.state = "running"
            # the control plane interposes here for recovery: a recorded
            # outcome replays instead of re-executing (DESIGN.md §15)
            if self.task_executor is not None:
                task.result = self.task_executor(task, ctx)
            else:
                task.result = task.fn(ctx)
            task.state = "done"
            run.results[key] = task.result
            self._log("done", task=task.id, result=task.result)
        except NodeDown as nd:
            self.cluster.fail_node(nd.node)
            self._log("node_down", node=nd.node, task=task.id)
            run.pending_retry.append(key)
        except TaskWedged:
            # the task hung: it has NOT failed and has NOT freed its
            # slot, so the key goes back to the head of the queue and
            # step_round pins the slot until the watchdog restarts the
            # gang (preempt -> elastic resume bumps the incarnation)
            run.wedged.add(key)
            run.queues[slot].insert(0, key)
            self._log("wedge", task=task.id, node=slot.node,
                      slot=slot.slot)
        except TaskOOM as e:
            task.state = "failed"
            self._log("oom", task=task.id, err=str(e))
            run.failed[key] = f"oom: {e}"
        except TaskError as e:
            task.retries += 1
            if task.retries <= self.policy.max_retries:
                self._log("retry", task=task.id, attempt=task.retries)
                run.pending_retry.append(key)
            else:
                task.state = "failed"
                run.failed[key] = str(e)
                self._log("fail", task=task.id, err=str(e))

    # ------------------------------------------------- job-array comparison
    def run_job_array(self, user: str, tasks: List[Task],
                      per_alloc_overhead_s: float = 0.0) -> JobResult:
        """Per-task allocation cycle (the scheduling pattern the paper's
        triples mode replaces). Optional synthetic per-allocation latency
        models the scheduler round-trip of a busy Slurm controller."""
        t_start = time.perf_counter()  # lint: disable=DET001(telemetry anchor for reported wall_s; never read by a dispatch decision)
        results: Dict[int, Any] = {}
        failed: Dict[int, str] = {}
        for task in tasks:
            nodes = self.cluster.allocate(user, 1)
            if nodes is None:
                failed[task.id] = "no nodes"
                continue
            self._alloc_cycles += 1
            if per_alloc_overhead_s:
                time.sleep(per_alloc_overhead_s)
            self._log("alloc", user=user, nodes=nodes, mode="array")
            ctx = TaskCtx(task_id=task.id, node=nodes[0], slot=0,
                          chips=(0,), pack_lane=0, ntpp=1)
            try:
                results[task.id] = task.fn(ctx)
            except TaskError as e:
                failed[task.id] = str(e)
            self.cluster.release(nodes)
        return JobResult(results=results, failed=failed, events=self.events,
                         alloc_cycles=self._alloc_cycles,
                         wall_s=time.perf_counter() - t_start)  # lint: disable=DET001(reported wall_s is telemetry; decisions use round counts)
