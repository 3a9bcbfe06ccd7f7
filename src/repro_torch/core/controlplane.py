"""Durable control plane: TriplesScheduler fronted by an event log (a
copy of ``repro.core.controlplane``, with the port's own ``TASK_REGISTRY``).

Everything PRs 1–9 built lives and dies with one ``run_queued`` call.
This module turns the scheduler into a long-running daemon (DESIGN.md
§15): every state transition — submit, admit, dispatch, preempt,
repack, slice-alloc, complete, fault — is appended to a
``core/eventlog.py`` log BEFORE the caller observes it, and
``ControlPlane(...).start()`` IS recovery: it claims a fresh epoch
(fencing any zombie predecessor), loads the newest snapshot, then
deterministically re-executes the remaining logged commands, verifying
that every event the scheduler regenerates byte-matches the logged
record at the same position (ReplayDivergence otherwise). Queue,
fair-share accounting, admission measurements and gang state are
therefore rebuilt bit-identically from the log — the existing
``GangCheckpoint`` seam already made gang *array* state durable; this
makes the *queue and accounting* durable too.

Determinism contract (what makes verified re-execution possible):

  * task functions are registered by NAME (``register_task``) and must
    be deterministic functions of (ctx, payload) returning
    canonical-JSON-stable values — the log stores outcomes, so a
    recovered run replays recorded results instead of re-executing
    (``task_executor`` seam), and only the single task in flight at the
    crash boundary ever re-executes (at-least-once there, exactly-once
    everywhere else);
  * submissions carry a caller-chosen ``job_key`` idempotency key:
    re-driving the same workload after a crash dedupes against the
    rebuilt ``_by_key`` index, so the crash-injection harness just runs
    its driver again and the queue converges to the uncrashed state;
  * the scheduler itself is a pure function of the submitted work (the
    repo-wide DET lint invariant), so its regenerated event stream can
    be VERIFIED against the log rather than trusted.

The health watchdog rides the same machinery: the scheduler's
heartbeat phase (task settlements per round) feeds
``FaultPolicy.wedge_timeout_rounds``; a silent gang is force-restarted
through preempt + elastic resume, and every step of that is in the log
like any other transition.
"""
from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core import tenancy as ten
from repro_torch.core import triples as T
from repro_torch.core.eventlog import EventLog, ReplayDivergence, canonical
from repro_torch.core.faults import (CrashHook, FaultPolicy, NodeDown,
                                     TaskCrash, TaskOOM, TaskWedged)
from repro_torch.core.scheduler import (ClusterState, GangCheckpoint,
                                        GangJob, JobResult, Task, TaskCtx,
                                        Tenancy, TriplesScheduler)

#: name -> fn(ctx, payload). Durable submissions reference tasks by
#: registry name so a restarted process can rebuild the callables the
#: log cannot store.
TASK_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register_task(name: str, fn: Optional[Callable] = None):
    """Register ``fn(ctx, payload)`` under ``name`` (decorator or
    direct). Registered functions must be deterministic and return
    canonical-JSON-stable values (module docstring)."""
    def deco(f):
        TASK_REGISTRY[name] = f
        return f
    return deco(fn) if fn is not None else deco


def _bind(fn: Callable, payload) -> Callable:
    return lambda ctx: fn(ctx, payload)


def _jsonable(detail: dict) -> dict:
    """Normalize a detail dict to its post-JSON form (tuples -> lists,
    int keys -> strings) so live emission and replayed records compare
    under one canonical form."""
    return json.loads(canonical(detail))


class ControlPlane:
    """Scheduler + event log with recovery-by-verified-re-execution.

    ``start()`` on an empty log directory is a fresh boot; on a
    non-empty one it is crash recovery — the two are the same code
    path, which is what the crash-at-every-boundary harness pins.

    ``crash_hook`` (faults.CrashHook) fires before each LIVE append —
    the durability tests' kill switch. It never fires during replay
    verification, so a recovered plane recovers.
    """

    def __init__(self, log_dir: str, *, n_nodes: int,
                 node_spec: Optional[T.NodeSpec] = None,
                 quotas: Optional[Dict[str, ten.TenantQuota]] = None,
                 policy: Optional[FaultPolicy] = None,
                 preemption: Optional[ten.PreemptionPolicy] = None,
                 half_life: Optional[float] = None,
                 admission_headroom: float = 0.9,
                 gauges: bool = False,
                 fsync: bool = True,
                 crash_hook: Optional[CrashHook] = None):
        self.log = EventLog(log_dir, fsync=fsync)
        self.n_nodes = n_nodes
        self.node_spec = node_spec or T.NodeSpec()
        self.quotas = quotas
        self.policy = policy
        self.preemption = preemption
        self.half_life = half_life
        self.admission_headroom = admission_headroom
        self.with_gauges = gauges
        self.crash_hook = crash_hook
        self.epoch: Optional[int] = None
        self._by_key: Dict[str, int] = {}       # job_key -> job id
        self._specs: Dict[int, dict] = {}       # job id -> durable spec
        self._runs = 0                          # run() invocations
        self._cursor = []                       # records left to verify
        self._cursor_pos = 0
        self.sched: Optional[TriplesScheduler] = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ControlPlane":
        """Claim the log (fencing any zombie), rebuild state from the
        newest snapshot + the records after it, and stand ready for
        live traffic. Recovery == boot."""
        self.epoch = self.log.claim()
        # claim() already parsed and chain-validated the whole log to
        # size its seq counter; reuse that replay instead of paying for
        # a second full parse on every boot
        records = self.log.recovered
        self._build_scheduler()
        snap = self.log.latest_snapshot()
        if snap is not None:
            upto, state = snap
            records = [r for r in records if r.seq > upto]
            self._load_snapshot(state)
        self._cursor = records
        self._cursor_pos = 0
        self._drive_from_log()
        return self

    def close(self):
        self.log.close()

    def _build_scheduler(self):
        cluster = ClusterState(self.n_nodes, node_spec=self.node_spec)
        gauges = None
        if self.with_gauges:
            from repro_torch.core.monitor import TenantGauges
            gauges = TenantGauges()
        tenancy = Tenancy.create(
            quotas=self.quotas, node_spec=self.node_spec,
            admission_headroom=self.admission_headroom,
            half_life=self.half_life, gauges=gauges,
            preemption=self.preemption)
        self.sched = TriplesScheduler(
            cluster, policy=self.policy, tenancy=tenancy,
            event_sink=self._emit, task_executor=self._execute_task)

    # ----------------------------------------------------- the emit seam
    def _emit(self, kind: str, detail: dict):
        """Every scheduler event lands here (scheduler.event_sink).

        Replay mode (cursor not exhausted): VERIFY the regenerated
        event against the logged record at the cursor — same kind, same
        canonical payload — and advance. Divergence means the scheduler
        is not the deterministic function of the log it must be.

        Live mode (cursor exhausted): durably append. The crash hook
        fires BEFORE the write, so an injected crash cuts the log
        exactly at a record boundary."""
        payload = _jsonable(detail)
        if self._cursor_pos < len(self._cursor):
            rec = self._cursor[self._cursor_pos]
            if rec.kind != kind or canonical(rec.payload) != \
                    canonical(payload):
                raise ReplayDivergence(
                    f"replay diverged at seq {rec.seq}: log has "
                    f"{rec.kind}:{canonical(rec.payload)}, scheduler "
                    f"regenerated {kind}:{canonical(payload)}")
            self._cursor_pos += 1
            return
        if self.crash_hook is not None:
            self.crash_hook.on_append()
        self.log.append(kind, payload)

    def _execute_task(self, task: Task, ctx: TaskCtx):
        """Task-execution interposer (scheduler.task_executor): during
        replay, the record AFTER this task's verified "dispatch" is its
        recorded outcome — return/raise it instead of re-executing, so
        side-effectful work runs exactly once. Past the cursor, execute
        live; only the single task in flight at the crash boundary can
        re-execute (and being deterministic, reproduces its result)."""
        if self._cursor_pos < len(self._cursor):
            rec = self._cursor[self._cursor_pos]
            # the cursor is NOT advanced here: the scheduler's own
            # outcome event (_log -> _emit) verifies and consumes it
            if rec.kind == "done" and rec.payload.get("task") == task.id:
                return rec.payload.get("result")
            if rec.kind == "oom" and rec.payload.get("task") == task.id:
                raise TaskOOM(rec.payload["err"])
            if rec.kind == "node_down" \
                    and rec.payload.get("task") == task.id:
                raise NodeDown(rec.payload["node"])
            if rec.kind == "retry" and rec.payload.get("task") == task.id:
                raise TaskCrash("replayed retry")
            if rec.kind == "fail" and rec.payload.get("task") == task.id:
                raise TaskCrash(rec.payload["err"])
            if rec.kind == "wedge" and rec.payload.get("task") == task.id:
                raise TaskWedged("replayed wedge")
        return task.fn(ctx)

    # ------------------------------------------------------- command loop
    def _drive_from_log(self):
        """Recovery driver: the log's top-level COMMAND records
        (job_spec / run_start / measured) are re-driven through the
        same code paths live traffic uses; everything the scheduler
        emits along the way is verified by ``_emit``. When the cursor
        exhausts mid-run, execution continues LIVE to quiescence — an
        interrupted drain finishes under the new epoch."""
        while self._cursor_pos < len(self._cursor):
            rec = self._cursor[self._cursor_pos]
            if rec.kind == "job_spec":
                self._cursor_pos += 1
                self._apply_spec(rec.payload)
            elif rec.kind == "run_start":
                self.run()              # re-emits run_start -> verified
            elif rec.kind == "measured":
                self._cursor_pos += 1
                self._apply_measured(rec.payload)
            else:
                raise ReplayDivergence(
                    f"unexpected top-level record at seq {rec.seq}: "
                    f"{rec.kind} (not a command)")

    # ------------------------------------------------------------- traffic
    def submit(self, user: str, task_kind: str, *, job_key: str,
               trip: T.Triples, n_tasks: Optional[int] = None,
               payloads: Optional[List] = None,
               bytes_per_lane: float = 0.0, interference: float = 0.0,
               kind: str = "") -> GangJob:
        """Durably enqueue a gang job. ``job_key`` is the idempotency
        key: a key the log already knows returns the existing job and
        appends NOTHING, so crash-retried drivers converge instead of
        double-submitting."""
        if job_key in self._by_key:
            return self.sched._jobs[self._by_key[job_key]]
        if task_kind not in TASK_REGISTRY:
            raise KeyError(f"task kind {task_kind!r} not registered")
        spec = {"job_key": job_key, "user": user, "task_kind": task_kind,
                "trip": [trip.nnode, trip.nppn, trip.ntpp],
                "n_tasks": int(n_tasks if n_tasks is not None
                               else len(payloads or [])),
                "payloads": payloads,
                "bytes_per_lane": float(bytes_per_lane),
                "interference": float(interference), "kind": kind}
        self._emit("job_spec", spec)
        return self._apply_spec(spec)

    def _make_tasks(self, spec: dict) -> List[Task]:
        fn = TASK_REGISTRY[spec["task_kind"]]
        payloads = spec.get("payloads")
        return [Task(id=i, fn=_bind(fn, payloads[i] if payloads else None))
                for i in range(spec["n_tasks"])]

    def _apply_spec(self, spec: dict) -> GangJob:
        job = self.sched.submit(
            spec["user"], self._make_tasks(spec),
            T.Triples(*spec["trip"]),
            bytes_per_lane=spec["bytes_per_lane"],
            interference=spec["interference"], kind=spec["kind"])
        self._by_key[spec["job_key"]] = job.id
        self._specs[job.id] = spec
        return job

    def run(self) -> Dict[int, JobResult]:
        """Drain the queue (scheduler.run_queued) with every transition
        logged. The run itself is bracketed by run_start/run_end
        records so recovery knows a drain was in flight.

        A live run() on an empty queue is a NO-OP (nothing to drain,
        nothing logged) — so a crash-retried driver that re-drives an
        already-drained workload leaves the log byte-identical to the
        uncrashed run's. During replay the bracket is always emitted:
        it must consume the logged run_start at the cursor."""
        queued = [pj.id for pj in self.sched.tenancy.queue.ordered()]
        if not queued and self._cursor_pos >= len(self._cursor):
            return {}
        run_idx = self._runs
        self._emit("run_start", {"run": run_idx, "queued": queued})
        self._runs += 1
        done = self.sched.run_queued()
        self._emit("run_end", {"run": run_idx, "done": sorted(done)})
        return done

    def record_measured(self, key: str, bytes_per_lane: float):
        """Durable mirror of MemoryAdmission.record_measured (the
        repack loop's live-footprint feedback) — logged as a command so
        recovery re-applies the measurement before later admissions."""
        self._emit("measured", {"key": key,
                                "bytes_per_lane": float(bytes_per_lane)})
        self._apply_measured({"key": key,
                              "bytes_per_lane": float(bytes_per_lane)})

    def _apply_measured(self, payload: dict):
        adm = self.sched.tenancy.admission
        if adm is not None:
            adm.record_measured(payload["key"], payload["bytes_per_lane"])

    # ------------------------------------------------ snapshot / compaction
    def snapshot(self) -> str:
        """Persist the full control-plane state as a sidecar snapshot
        (NOT a log record — the event stream stays pure), enabling
        ``compact()``. Only legal at quiescence: between run() calls
        there are no live gang runs, so the queue + accounting + job
        table IS the whole state."""
        if self.sched._rq is not None:
            raise RuntimeError("snapshot() only at quiescence "
                               "(between run() calls)")
        return self.log.write_snapshot(self.state_dict(),
                                       upto=self.log.last_seq)

    def compact(self) -> List[str]:
        """Drop log segments wholly covered by the newest snapshot.
        Metamorphic invariant (tests/test_durability.py): recovery from
        snapshot + truncated tail == replay-from-the-beginning."""
        return self.log.compact()

    def state_dict(self) -> dict:
        """JSON-safe full state for snapshots."""
        sched = self.sched
        q = self.sched.tenancy.queue
        acct = self.sched.tenancy.accountant
        adm = self.sched.tenancy.admission
        pending = []
        for user in sorted(q._by_user):
            for sseq, pidx, pj in q._by_user[user]:
                pending.append({
                    "submit_seq": sseq, "push_idx": pidx,
                    "id": pj.id, "user": pj.user, "n_nodes": pj.n_nodes,
                    "submit_t": pj.submit_t,
                    "est_duration": pj.est_duration,
                    "bytes_per_lane": pj.bytes_per_lane,
                    "n_slots": pj.n_slots, "n_tasks": pj.n_tasks,
                    "min_nodes": pj.min_nodes,
                    "granted_nodes": pj.granted_nodes})
        pending.sort(key=lambda e: e["push_idx"])
        jobs = []
        for jid in sorted(sched._jobs):
            job = sched._jobs[jid]
            row = {"id": jid, "spec": self._specs.get(jid),
                   "state": job.state, "reject_reason": job.reject_reason,
                   "preemptions": job.preemptions,
                   "result": None, "checkpoint": None}
            if job.result is not None:
                r = job.result
                row["result"] = {
                    "results": {str(k): v for k, v in r.results.items()},
                    "failed": {str(k): v for k, v in r.failed.items()},
                    "alloc_cycles": r.alloc_cycles,
                    "wait_rounds": r.wait_rounds}
            if job.checkpoint is not None:
                c = job.checkpoint
                row["checkpoint"] = {
                    "job_id": c.job_id, "user": c.user,
                    "results": {str(k): v for k, v in c.results.items()},
                    "failed": {str(k): v for k, v in c.failed.items()},
                    "remaining": list(c.remaining),
                    "retries": {str(k): v for k, v in c.retries.items()},
                    "nnode": c.nnode}
            jobs.append(row)
        gauges = self.sched.tenancy.gauges
        return _jsonable({
            "next_job_id": sched._next_job_id,
            "alloc_cycles": sched._alloc_cycles,
            "runs": self._runs,
            "by_key": dict(self._by_key),
            "accountant": acct.state_dict(),
            "admission": adm.state_dict() if adm is not None else None,
            "queue": {"seq": q._seq, "push_idx": q._push_idx,
                      "pending": pending},
            "jobs": jobs,
            "gauges": gauges.state_dict() if gauges is not None else None,
        })

    def _load_snapshot(self, state: dict):
        sched = self.sched
        sched._next_job_id = state["next_job_id"]
        sched._alloc_cycles = state["alloc_cycles"]
        self._runs = state["runs"]
        self._by_key = dict(state["by_key"])
        sched.tenancy.accountant.load_state(state["accountant"])
        adm = sched.tenancy.admission
        if adm is not None and state.get("admission") is not None:
            adm.load_state(state["admission"])
        for row in state["jobs"]:
            spec = row["spec"]
            job = GangJob(
                id=row["id"], user=spec["user"],
                tasks=self._make_tasks(spec),
                trip=T.Triples(*spec["trip"]),
                bytes_per_lane=spec["bytes_per_lane"],
                interference=spec["interference"], kind=spec["kind"],
                state=row["state"], reject_reason=row["reject_reason"],
                preemptions=row["preemptions"])
            if row["result"] is not None:
                r = row["result"]
                job.result = JobResult(
                    results={int(k): v for k, v in r["results"].items()},
                    failed={int(k): v for k, v in r["failed"].items()},
                    events=sched.events, alloc_cycles=r["alloc_cycles"],
                    wall_s=0.0, wait_rounds=r["wait_rounds"],
                    preemptions=row["preemptions"])
            if row["checkpoint"] is not None:
                c = row["checkpoint"]
                job.checkpoint = GangCheckpoint(
                    job_id=c["job_id"], user=c["user"],
                    results={int(k): v for k, v in c["results"].items()},
                    failed={int(k): v for k, v in c["failed"].items()},
                    remaining=list(c["remaining"]),
                    retries={int(k): v for k, v in c["retries"].items()},
                    nnode=c["nnode"])
                for tid, n in job.checkpoint.retries.items():
                    job.tasks[tid].retries = n
            sched._jobs[job.id] = job
            self._specs[job.id] = spec
        q = sched.tenancy.queue
        q._seq = state["queue"]["seq"]
        q._push_idx = state["queue"]["push_idx"]
        by_user: Dict[str, list] = {}
        count = 0
        for e in state["queue"]["pending"]:
            pj = ten.PendingJob(
                id=e["id"], user=e["user"], n_nodes=e["n_nodes"],
                submit_seq=e["submit_seq"], submit_t=e["submit_t"],
                est_duration=e["est_duration"],
                bytes_per_lane=e["bytes_per_lane"], n_slots=e["n_slots"],
                n_tasks=e["n_tasks"], min_nodes=e["min_nodes"],
                granted_nodes=e["granted_nodes"],
                payload=sched._jobs[e["id"]])
            by_user.setdefault(pj.user, []).append(
                (e["submit_seq"], e["push_idx"], pj))
            count += 1
        for lst in by_user.values():
            lst.sort(key=lambda t: (t[0], t[1]))
        q._by_user = by_user
        q._count = count
        q._min_need = None
        q._min_count = 0
        gauges = sched.tenancy.gauges
        if gauges is not None and state.get("gauges") is not None:
            gauges.load_state(state["gauges"])

    # ----------------------------------------------------------- inspection
    def state_digest(self) -> dict:
        """The bit-identity comparison object the durability tests pin:
        final accounting, queue order, admission measurements and
        per-job outcome counters — everything except telemetry
        (wall-clock fields are excluded by design)."""
        sched = self.sched
        q = sched.tenancy.queue
        acct = sched.tenancy.accountant
        adm = sched.tenancy.admission
        jobs = {}
        for jid in sorted(sched._jobs):
            job = sched._jobs[jid]
            jobs[str(jid)] = {
                "state": job.state, "user": job.user,
                "reject_reason": job.reject_reason,
                "preemptions": job.preemptions,
                "results": {str(k): v for k, v
                            in job.result.results.items()}
                if job.result is not None else None,
                "failed": {str(k): v for k, v in job.result.failed.items()}
                if job.result is not None else None,
                "wait_rounds": job.result.wait_rounds
                if job.result is not None else None,
            }
        return _jsonable({
            "next_job_id": sched._next_job_id,
            "alloc_cycles": sched._alloc_cycles,
            "runs": self._runs,
            "by_key": dict(self._by_key),
            "usage": dict(acct._usage),
            "last_decay": acct._last_decay,
            "measured": dict(adm.measured) if adm is not None else None,
            "intensity": dict(adm.intensity) if adm is not None else None,
            "queue": [pj.id for pj in q.ordered()],
            "queue_seq": q._seq,
            "jobs": jobs,
        })
