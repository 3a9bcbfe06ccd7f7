"""The port's policy and durability layer held against the reference
directly: the same submission scripts through both schedulers, both
simulators over the committed traces, both control planes on the tiny
trace, and the port alone against ``BENCH_HISTORY.json``.

The reference rounds four float sums with Python's built-in ``sum``,
which Python 3.12 made compensated; the committed traces and history were
written with a plain left-to-right fold, which the port uses
(``simulate.left_fold_sum``). Where the reference is compared with the
port, its ``sum`` is rebound to that fold in ``repro.core.simulate`` and
``repro.core.traces`` through ``monkeypatch``; nothing in the reference
changes.
"""
from __future__ import annotations

import dataclasses
import filecmp
import json
import os
import sys
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACES_DIR = os.path.join(ROOT, "benchmarks", "traces")
HISTORY = os.path.join(ROOT, "BENCH_HISTORY.json")
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the replay the card runs too)
from repro.core import controlplane as ref_cp  # noqa: E402
from repro.core import eventlog as ref_ev  # noqa: E402
from repro.core import faults as ref_faults  # noqa: E402
from repro.core import monitor as ref_monitor  # noqa: E402
from repro.core import scheduler as ref_sched  # noqa: E402
from repro.core import simulate as ref_S  # noqa: E402
from repro.core import spatial as ref_sp  # noqa: E402
from repro.core import tenancy as ref_ten  # noqa: E402
from repro.core import traces as ref_TR  # noqa: E402
from repro.core import triples as ref_T  # noqa: E402
from repro_torch.core import controlplane as port_cp  # noqa: E402
from repro_torch.core import eventlog as port_ev  # noqa: E402
from repro_torch.core import faults as port_faults  # noqa: E402
from repro_torch.core import monitor as port_monitor  # noqa: E402
from repro_torch.core import scheduler as port_sched  # noqa: E402
from repro_torch.core import simulate as port_S  # noqa: E402
from repro_torch.core import spatial as port_sp  # noqa: E402
from repro_torch.core import tenancy as port_ten  # noqa: E402
from repro_torch.core import traces as port_TR  # noqa: E402
from repro_torch.core import triples as port_T  # noqa: E402

REF = types.SimpleNamespace(T=ref_T, ten=ref_ten, sched=ref_sched,
                            sp=ref_sp, faults=ref_faults, mon=ref_monitor,
                            S=ref_S, TR=ref_TR, ev=ref_ev, cp=ref_cp)
PORT = types.SimpleNamespace(T=port_T, ten=port_ten, sched=port_sched,
                             sp=port_sp, faults=port_faults,
                             mon=port_monitor, S=port_S, TR=port_TR,
                             ev=port_ev, cp=port_cp)


def _left_fold(xs, start=0):
    total = start
    for x in xs:
        total += x
    return total


@pytest.fixture
def ref_left_fold(monkeypatch):
    """The reference with ``sum`` rebound to a left fold in the two
    modules whose float sums the committed files were written with."""
    monkeypatch.setattr(ref_S, "sum", _left_fold, raising=False)
    monkeypatch.setattr(ref_TR, "sum", _left_fold, raising=False)


def test_left_fold_sum_is_the_plain_fold():
    """On floats whose compensated sum rounds otherwise, the helper gives
    the left fold's bits, not the built-in's."""
    xs = [0.1] * 10
    assert port_S.left_fold_sum(xs) == _left_fold(xs) == 0.9999999999999999
    assert port_S.left_fold_sum([]) == 0
    assert port_S.left_fold_sum(iter([1, 2, 3])) == 6


# ---------------------------------------------------------------------------
# the same submission scripts through both schedulers
# ---------------------------------------------------------------------------

def _tiny_jobs(pk):
    _, jobs = pk.TR.load_jsonl(pk.TR.trace_path(TRACES_DIR, "tiny"))
    return [dataclasses.replace(j, submit_t=0.0) for j in jobs]


def _script_tiny(pk, tmp):
    cl = pk.sched.ClusterState(4)
    s = pk.sched.TriplesScheduler(
        cl, tenancy=pk.sched.Tenancy.create(node_spec=cl.node_spec))
    for j in _tiny_jobs(pk):
        tasks = [pk.sched.Task(id=i, fn=lambda ctx, i=i: i)
                 for i in range(j.n_tasks)]
        s.submit(j.user, tasks, j.trip, bytes_per_lane=j.bytes_per_lane,
                 interference=j.interference)
    s.run_queued()
    return s


def _script_preempt(pk, tmp):
    """Preempt, checkpoint the gang's cursors, resume narrower."""
    cl = pk.sched.ClusterState(4)
    s = pk.sched.TriplesScheduler(
        cl, policy=pk.faults.FaultPolicy(checkpoint_every=2),
        tenancy=pk.sched.Tenancy.create(
            node_spec=cl.node_spec, gauges=pk.mon.TenantGauges(),
            preemption=pk.ten.PreemptionPolicy(wait_threshold=2,
                                               elastic_min_frac=0.5)),
        checkpoint_dir=str(tmp))
    mk = lambda n, tag: [pk.sched.Task(id=i, fn=lambda ctx, i=i: [tag, i])
                         for i in range(n)]
    s.submit("hog", mk(64, "hog"), pk.T.Triples(4, 2, 1))
    s.submit("iris", mk(4, "iris"), pk.T.Triples(1, 2, 1))
    s.submit("hog", mk(12, "hog2"), pk.T.Triples(2, 2, 1))
    s.run_queued()
    return s


def _script_spatial(pk, tmp):
    """Co-tenants of interference 0.8 partitioned into slices of one
    node, plus an over-footprint gang that admission rejects."""
    spec = pk.T.NodeSpec()
    cl = pk.sched.ClusterState(1, spec)
    s = pk.sched.TriplesScheduler(cl, tenancy=pk.sched.Tenancy.create(
        node_spec=spec, planner=pk.sp.ModePlanner(spec),
        gauges=pk.mon.TenantGauges()))
    for u, n in (("a", 6), ("b", 5), ("c", 7)):
        tasks = [pk.sched.Task(id=i, fn=lambda ctx, i=i: [i, ctx.slice])
                 for i in range(n)]
        s.submit(u, tasks, pk.T.Triples(1, 2, 1), bytes_per_lane=2e9,
                 interference=0.8)
    s.submit("d", [pk.sched.Task(id=0, fn=lambda ctx: 0)],
             pk.T.Triples(1, 1, 1), bytes_per_lane=1e12)
    s.run_queued()
    return s


def _script_faults(pk, tmp):
    """Retries, a terminal OOM and a lost node in one gang."""
    cl = pk.sched.ClusterState(3)
    s = pk.sched.TriplesScheduler(
        cl, pk.faults.FaultPolicy(max_retries=2),
        tenancy=pk.sched.Tenancy.create(node_spec=cl.node_spec))
    killed = {"done": False}

    def task(ctx):
        if ctx.task_id == 3:
            raise pk.faults.TaskOOM("simulated OOM")
        if ctx.node == 1 and not killed["done"]:
            killed["done"] = True
            raise pk.faults.NodeDown(1)
        return ctx.task_id

    flaky = pk.faults.inject_failures(lambda ctx: "ok", fail_on_calls=(1,))
    tasks = [pk.sched.Task(id=i, fn=task) for i in range(12)]
    tasks.append(pk.sched.Task(id=12, fn=flaky))
    s.run_triples_job("u", tasks, pk.T.Triples(3, 2, 1))
    return s


def _script_quota_backfill(pk, tmp):
    """A same-user job riding a gang's free lanes, a foreign user beside
    it, and a max-nodes quota that holds one gang back."""
    cl = pk.sched.ClusterState(2)
    s = pk.sched.TriplesScheduler(cl, tenancy=pk.sched.Tenancy.create(
        node_spec=cl.node_spec, gauges=pk.mon.TenantGauges(),
        quotas={"capped": pk.ten.TenantQuota(max_nodes=1)}))
    mk = lambda n, tag: [pk.sched.Task(id=i, fn=lambda ctx, i=i: [tag, i])
                         for i in range(n)]
    s.submit("alice", mk(6, "big"), pk.T.Triples(2, 2, 1))
    s.submit("alice", mk(2, "small"), pk.T.Triples(1, 2, 1))
    s.submit("bob", mk(2, "bob"), pk.T.Triples(1, 2, 1))
    s.submit("capped", mk(1, "wide"), pk.T.Triples(2, 1, 1))
    s.submit("capped", mk(1, "narrow"), pk.T.Triples(1, 1, 1))
    s.run_queued()
    return s


SCRIPTS = {"tiny": _script_tiny, "preempt": _script_preempt,
           "spatial": _script_spatial, "faults": _script_faults,
           "quota_backfill": _script_quota_backfill}


def _run_script(pk, name, tmp):
    s = SCRIPTS[name](pk, tmp / name)
    raw = [(e.kind, pk.ev.canonical(e.detail)) for e in s.events]
    return pk.ev.decision_view((e.kind, e.detail) for e in s.events), raw


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_submission_scripts_decide_alike(name, tmp_path):
    """Equal ``decision_view`` rows, and the whole event streams equal
    field for field."""
    ref_rows, ref_raw = _run_script(REF, name, tmp_path / "ref")
    port_rows, port_raw = _run_script(PORT, name, tmp_path / "port")
    assert ref_rows and len(ref_raw) > len(ref_rows)
    assert port_ev.diff_decision_logs(ref_rows, port_rows) == []
    assert port_rows == ref_rows
    assert port_raw == ref_raw


def test_scripts_reach_the_decisions_they_name(tmp_path):
    """Each script drives the branch it is there for (on the port)."""
    kinds = {n: {k for k, _ in _run_script(PORT, n, tmp_path)[1]}
             for n in SCRIPTS}
    assert {"preempt", "resume"} <= kinds["preempt"]
    assert {"spatial_dispatch", "reject"} <= kinds["spatial"]
    assert {"retry", "oom", "node_down", "replan"} <= kinds["faults"]
    assert "lane_backfill" in kinds["quota_backfill"]


# ---------------------------------------------------------------------------
# the simulator over the committed traces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trace", sorted(port_TR.CANONICAL))
def test_compare_modes_equals_reference_with_left_fold(trace, ref_left_fold):
    """Every field of every mode's report, port against reference."""
    want = chip_smoke.replay_quality(ref_S, ref_TR, TRACES_DIR, [trace])
    got = chip_smoke.replay_quality(port_S, port_TR, TRACES_DIR, [trace])
    assert chip_smoke.diff_quality(want, got) == []
    assert got == want and len(got[trace]) == 7


def test_port_replays_bench_history_exactly():
    """The port alone, with no patch, equals the history's last entry in
    every field of every mode of every trace: 0 drift rows."""
    with open(HISTORY) as f:
        committed = json.load(f)["entries"][-1]["quality"]
    got = chip_smoke.replay_quality(port_S, port_TR, TRACES_DIR)
    assert chip_smoke.diff_quality(committed, got) == []
    assert sorted(got) == sorted(port_TR.CANONICAL)


def test_reference_replay_drifts_without_the_fold():
    """What the port repairs: the reference's own replay under the
    built-in ``sum`` parts from the history (last-ulp ``mean_wait``)."""
    if sys.version_info < (3, 12):
        pytest.skip("the built-in sum is a left fold before Python 3.12")
    with open(HISTORY) as f:
        committed = json.load(f)["entries"][-1]["quality"]
    drift = chip_smoke.diff_quality(
        committed, chip_smoke.replay_quality(ref_S, ref_TR, TRACES_DIR))
    assert drift and all(row.split(":")[0].endswith("/mean_wait")
                         for row in drift)


def test_port_regenerates_the_committed_suite(tmp_path):
    fresh = port_TR.write_canonical_suite(str(tmp_path))
    assert len(fresh) == len(port_TR.CANONICAL) == 6
    for path in fresh:
        name = os.path.basename(path)
        assert filecmp.cmp(path, os.path.join(TRACES_DIR, name),
                           shallow=False), name


# ---------------------------------------------------------------------------
# the two control planes on the tiny trace
# ---------------------------------------------------------------------------

def _noop(ctx, payload):
    return None


def _plane_log(pk, d, crash_after=None):
    """Drive the tiny trace through a control plane in ``d`` (after a
    crash at ``crash_after``, recover and drive again); return its
    durable records and state digest."""
    pk.cp.register_task("parity_noop", _noop)

    def drive(cp):
        for j in _tiny_jobs(pk):
            cp.submit(j.user, "parity_noop", job_key=f"trace-{j.id}",
                      trip=j.trip, n_tasks=j.n_tasks,
                      bytes_per_lane=j.bytes_per_lane,
                      interference=j.interference)
        cp.run()
    if crash_after is not None:
        cp = pk.cp.ControlPlane(str(d), n_nodes=4, fsync=False,
                                crash_hook=pk.faults.CrashHook(
                                    after=crash_after))
        with pytest.raises(pk.faults.CrashInjected):
            cp.start()
            drive(cp)
        cp.close()
    cp = pk.cp.ControlPlane(str(d), n_nodes=4, fsync=False).start()
    drive(cp)
    digest = cp.state_digest()
    cp.close()
    return pk.ev.EventLog(str(d), fsync=False).replay(), digest


@pytest.mark.parametrize("crash_after", [None, 17])
def test_control_planes_log_the_same_decisions(tmp_path, crash_after):
    ref_recs, ref_digest = _plane_log(REF, tmp_path / "ref", crash_after)
    port_recs, port_digest = _plane_log(PORT, tmp_path / "port",
                                        crash_after)
    assert port_ev.diff_decision_logs(ref_ev.decision_view(ref_recs),
                                      port_ev.decision_view(port_recs)) == []
    assert ([(r.kind, ref_ev.canonical(r.payload)) for r in ref_recs]
            == [(r.kind, port_ev.canonical(r.payload)) for r in port_recs])
    assert port_digest == ref_digest
    assert len(port_recs) > 17
