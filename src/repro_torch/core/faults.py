"""Failure taxonomy + policies for triples jobs (a copy of
``repro.core.faults``, which is plain Python).

Mirrors the paper's observed failure mode (CUDA OOM killing 21/48 packed
tasks) plus the failure modes that matter at 1000+ nodes: task crashes,
node loss, stragglers. Policies are pure data; the scheduler applies them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional


class TaskError(RuntimeError):
    """Base class for task-level failures."""


class TaskOOM(TaskError):
    """Accelerator memory exhausted (paper: CUDA out-of-memory)."""


class TaskCrash(TaskError):
    """Generic task failure (bad node, segfault, assertion)."""


class TaskWedged(RuntimeError):
    """Task hung without progress — the live analogue is a child process
    stuck on a dead collective or a full pipe. NOT a TaskError: a wedged
    process cannot be retried in place (it still occupies its slot); the
    gang-level watchdog must preempt the gang and restart it through the
    elastic-resume path (DESIGN.md §15)."""


class NodeDown(RuntimeError):
    """Whole-node loss; all tasks resident on it must be re-planned."""

    def __init__(self, node: int, msg: str = ""):
        super().__init__(msg or f"node {node} down")
        self.node = node


class CrashInjected(RuntimeError):
    """Control-plane crash injected by a durability-test hook: raised
    BEFORE an event-log append becomes durable, so the log ends exactly
    at a record boundary (core/eventlog.py fsyncs every append)."""


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    max_retries: int = 2                # per task, for TaskCrash
    oom_backoff: bool = True            # halve packing factor on TaskOOM
    min_pack_factor: int = 1
    speculative_stragglers: bool = True # duplicate a straggling lane onto a
                                        # free pool slot, first-result-wins
                                        # (lanepool.RefillExecutor)
    straggler_ratio: float = 1.5        # EWMA step time vs median (monitor)
    checkpoint_every: int = 0           # steps (sweep per-task saves) and
                                        # rounds (scheduler gang cursors);
                                        # 0 = only on completion/preempt
    wedge_timeout_rounds: int = 0       # gang watchdog: preempt + elastic-
                                        # resume a gang after this many
                                        # rounds without a task completion
                                        # (0 = watchdog off, DESIGN.md §15)


@dataclasses.dataclass
class CrashHook:
    """Durability-test crash injector for the control plane's event log.

    ``after=k`` lets the first k appends become durable and raises
    CrashInjected in place of append k+1, so the log is cut exactly at
    the k-th record boundary — looping k over every boundary is the
    crash-at-every-event-boundary sweep (tests/test_durability.py).
    ``after=-1`` never fires."""
    after: int = -1
    appends: int = 0

    def on_append(self):
        self.appends += 1
        if self.after >= 0 and self.appends > self.after:
            raise CrashInjected(
                f"injected crash at event boundary {self.after}")


def inject_failures(fn: Callable, *, fail_on_calls=(), oom_on_calls=(),
                    counter=None) -> Callable:
    """Test helper: wrap a task fn to raise on the n-th invocation."""
    state = counter if counter is not None else {"n": 0}

    def wrapped(*a, **kw):
        state["n"] += 1
        n = state["n"]
        if n in oom_on_calls:
            raise TaskOOM(f"injected OOM on call {n}")
        if n in fail_on_calls:
            raise TaskCrash(f"injected crash on call {n}")
        return fn(*a, **kw)

    return wrapped


def inject_wedge(fn: Callable, *, wedge_tasks=(),
                 until_incarnation: int = 1) -> Callable:
    """Test helper: wrap a TASK fn (ctx-taking) so the listed task ids
    hang (raise TaskWedged) until the gang has been restarted
    ``until_incarnation`` times — ``TaskCtx.incarnation`` counts the
    gang's preempt/resume cycles, so a watchdog restart clears the wedge
    exactly like killing and relaunching a hung process would."""

    def wrapped(ctx, *a, **kw):
        if ctx.task_id in wedge_tasks \
                and ctx.incarnation < until_incarnation:
            raise TaskWedged(
                f"task {ctx.task_id} wedged (incarnation "
                f"{ctx.incarnation})")
        return fn(ctx, *a, **kw)

    return wrapped
