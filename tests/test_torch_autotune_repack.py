"""The port's policy layer against the reference's on the CPU: the
packing-factor search (``auto_nppn`` with ``measure_packed`` replaced by
the same fake in both packages, as tests/test_monitor_autotune.py does),
``RepackPolicy`` and ``RepackController`` decisions, ``MemoryAdmission``,
the fault policies and the LLload gauge tables. These modules are plain
Python in both packages, so every decision and table must be equal.

The port runs a probe on the device (PyTorch has no ahead-of-time memory
analysis), so ``auto_nppn`` runs a factor only when the prediction from the
factors it measured fits the budget; the search and its decisions are the
reference's wherever the footprint is proportional to the factor, and the
port never stops later than the reference."""
import numpy as np
import pytest
import torch

from repro.core import autotune as jautotune
from repro.core import faults as jfaults
from repro.core import monitor as jmonitor
from repro.core import repack as jrepack
from repro.core import tenancy as jtenancy
from repro.core import triples as jtriples
from repro_torch.core import autotune, faults, monitor, repack, tenancy
from repro_torch.core import triples
from tests.prop import given_cases


def _fake(mod, per_lane: float, base: float = 0.0):
    """A probe whose k-lane footprint is base + k·per_lane bytes, counting
    calls (the reference's tests/test_monitor_autotune.py::_fake_measure,
    with a fixed part)."""
    calls = []

    def measure(make_packed, k, example_args_fn):
        calls.append(k)
        return mod.StaticProfile(argument_bytes=int(base + per_lane * k),
                                 temp_bytes=0, output_bytes=0, flops=0,
                                 bytes_accessed=0)
    return measure, calls


def _search(monkeypatch, per_lane, budget, max_factor, base=0.0):
    out = []
    for auto, mon in ((jautotune, jmonitor), (autotune, monitor)):
        measure, calls = _fake(mon, per_lane, base)
        monkeypatch.setattr(auto, "measure_packed", measure)
        d = auto.auto_nppn(None, None, budget, max_factor=max_factor,
                           headroom=1.0)
        out.append((d, calls))
    return out


@pytest.mark.parametrize("max_factor", [3, 5, 6, 7, 12])
@pytest.mark.parametrize("frontier", [2, 3, 5, 6, 9, 100])
def test_auto_nppn_matches_reference(monkeypatch, max_factor, frontier):
    """A footprint proportional to the factor: the same decision, the same
    search path (every factor the reference probes is measured or
    predicted by the port), and no factor run whose prediction was over
    the budget."""
    per_lane = 10 ** 6
    (jd, jcalls), (d, calls) = _search(monkeypatch, per_lane,
                                       per_lane * frontier, max_factor)
    assert (d.nppn_per_chip, d.rejected, d.reason) == (
        jd.nppn_per_chip, jd.rejected, jd.reason)
    assert d.profile.resident_bytes == jd.profile.resident_bytes
    assert d.profile_single.resident_bytes == per_lane
    assert list(d.measured) == calls
    assert sorted(set(d.measured) | set(d.predicted)) == sorted(set(jcalls))
    assert all(k * per_lane <= per_lane * frontier for k in d.measured)
    assert all(k * per_lane > per_lane * frontier for k in d.predicted)
    assert not d.profile.predicted


def test_auto_nppn_max_factor_6_selects_6(monkeypatch):
    (jd, jcalls), (d, calls) = _search(monkeypatch, 10 ** 6, 64e6, 6)
    assert d.nppn_per_chip == jd.nppn_per_chip == 6
    assert sorted(set(calls)) == sorted(set(jcalls)) == [1, 2, 4, 6]
    assert d.predicted == ()


def test_auto_nppn_with_a_fixed_part_never_overruns(monkeypatch):
    """A footprint base + k·per_lane: the port's k-lane prediction before
    k = 2 is measured (k·bytes(1)) overestimates, so it may stop earlier
    than the reference, never later; every factor it runs fits, and once
    k = 2 is measured the prediction is exact (40 seeded cases)."""
    for case in range(40):
        rng = np.random.default_rng(case)
        per_lane = int(rng.integers(1, 100)) * 10 ** 5
        base = int(rng.integers(0, 300)) * 10 ** 5
        budget = base + per_lane * int(rng.integers(1, 40))
        max_factor = int(rng.integers(1, 33))
        (jd, _), (d, calls) = _search(monkeypatch, per_lane, budget,
                                      max_factor, base)
        assert 1 <= d.nppn_per_chip <= jd.nppn_per_chip, case
        assert all(base + k * per_lane <= budget for k in calls), case
        if 2 in d.measured or max_factor == 1:
            assert d.nppn_per_chip == jd.nppn_per_chip, case


def test_auto_nppn_single_lane_over_budget_raises(monkeypatch):
    for auto, mon in ((jautotune, jmonitor), (autotune, monitor)):
        measure, _ = _fake(mon, 10 ** 9)
        monkeypatch.setattr(auto, "measure_packed", measure)
        with pytest.raises(MemoryError, match="increase NTPP"):
            auto.auto_nppn(None, None, 5e8)


def test_measure_packed_runs_the_step_and_predict_oom():
    def make_packed(k):
        return torch.func.vmap(lambda w, x: (w * x).sum())

    def args(k):
        return torch.ones(k, 1000), torch.ones(k, 1000)
    prof = autotune.measure_packed(make_packed, 4, args)
    assert prof.argument_bytes == 2 * 4 * 1000 * 4 and not prof.predicted
    assert prof.output_bytes == 4 * 4
    p = monitor.StaticProfile(argument_bytes=48 * 4 * 10 ** 9, temp_bytes=0,
                              output_bytes=0, flops=0, bytes_accessed=0)
    jp = jmonitor.StaticProfile(argument_bytes=48 * 4 * 10 ** 9,
                                temp_bytes=0, output_bytes=0, flops=0,
                                bytes_accessed=0)
    for budget in (64e9, 300e9):
        assert autotune.predict_oom(p, budget) == jautotune.predict_oom(
            jp, budget)


# ---------------------------------------------------------------------------
# RepackPolicy and RepackController
# ---------------------------------------------------------------------------

@given_cases(200, seed=3)
def test_repack_policy_propose_matches_reference(rng):
    kw = dict(grow_occupancy=float(rng.choice([0.85, 0.6, 1.0])),
              shrink_occupancy=float(rng.choice([0.0, 0.2, 0.45])),
              grow_factor=float(rng.choice([2.0, 1.5, 3.0])),
              min_capacity=int(rng.integers(1, 3)),
              max_capacity=int(rng.integers(3, 40)),
              headroom=float(rng.choice([0.9, 1.0, 0.5])))
    pol, jpol = repack.RepackPolicy(**kw), jrepack.RepackPolicy(**kw)
    cap = int(rng.integers(1, 40))
    args = dict(capacity=cap, occupancy=float(rng.random()),
                queued=int(rng.integers(0, 20)),
                active=int(rng.integers(0, cap + 1)),
                bytes_per_lane=float(rng.choice([0.0, 1e6, 3e7])),
                hbm_budget=rng.choice([None, 1e8, 1e9]))
    assert pol.propose(**args) == jpol.propose(**args)
    assert pol.frontier(args["bytes_per_lane"], args["hbm_budget"]) == \
        jpol.frontier(args["bytes_per_lane"], args["hbm_budget"])


@pytest.mark.parametrize("bad", [
    dict(shrink_occupancy=0.9, grow_occupancy=0.5), dict(grow_factor=1.0),
    dict(min_capacity=5, max_capacity=2), dict(headroom=0.0)])
def test_repack_policy_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError) as got:
        repack.RepackPolicy(**bad)
    with pytest.raises(ValueError) as want:
        jrepack.RepackPolicy(**bad)
    assert str(got.value) == str(want.value)


def _drive(mod, ten, script):
    """Run a RepackController through a scripted telemetry trajectory
    ((active, queued, footprint bytes) per step), resizing as it decides;
    returns its events, trace, the admission's measurements and gauges."""
    mem = {"bytes": 0.0}
    adm = ten.MemoryAdmission()
    ctl = mod.RepackController(
        mod.RepackPolicy(grow_occupancy=0.6, shrink_occupancy=0.3,
                         cooldown_steps=2, max_capacity=16),
        hbm_budget=8e8, tenant="alice", admission=adm,
        measure_bytes=lambda: mem["bytes"])
    cap, decided = 2, []
    for step, (active, queued, footprint) in enumerate(script):
        mem["bytes"] = footprint * cap
        ctl.observe(step, min(active, cap), cap, queued)
        new = ctl.decide(step, cap, queued, min(active, cap))
        decided.append(new)
        if new is not None:
            cap = new
    events = [tuple(vars(e).values()) for e in ctl.events]
    return (decided, events, ctl.capacity_trace(), dict(adm.measured),
            ctl.gauges.gang_table(), round(ctl.occupancy, 12))


def test_repack_controller_matches_reference():
    script = ([(8, 20, 1e7)] * 10 + [(3, 0, 1e7)] * 10 + [(2, 0, 2e8)] * 6
              + [(9, 12, 2e7)] * 10)
    assert _drive(repack, tenancy, script) == _drive(jrepack, jtenancy,
                                                      script)


def test_repack_controller_defaults_to_the_allocator_count():
    ctl = repack.RepackController()
    assert ctl.measure_bytes is monitor.live_device_bytes
    assert ctl.measure_every == 8
    ctl.observe(0, 1, 2, 0)         # no card here: 0 bytes, no estimate
    assert ctl.bytes_per_lane == 0.0


# ---------------------------------------------------------------------------
# tenancy, faults and gauges: plain Python copies
# ---------------------------------------------------------------------------

def test_memory_admission_matches_reference():
    out = []
    for ten, tr in ((tenancy, triples), (jtenancy, jtriples)):
        spec = tr.NodeSpec(chips_per_node=4, hbm_per_chip=16e9)
        adm = ten.MemoryAdmission(spec, headroom=0.8)
        rows = []
        for b in (1e9, 3e9, 7e9, 20e9):
            rows.append(adm.max_pack(b))
            for fn in (lambda: adm.require_fits(b),
                       lambda: vars(adm.admit(tr.Triples(1, 16, 1), b)),
                       lambda: vars(adm.clamp(tr.Triples(2, 32, 1), b))):
                try:
                    rows.append(fn())
                except MemoryError as e:
                    rows.append(str(e))
        adm.record_measured("alice", 4e9)
        adm.record_intensity("alice", 0.7)
        rows += [adm.effective_bytes("alice", 1e9),
                 adm.effective_bytes("alice", 0.0),
                 adm.effective_bytes("bob", 2e9), adm.state_dict()]
        out.append(rows)
    assert out[0] == out[1]


def test_fault_policy_and_injection_match_reference():
    assert vars(faults.FaultPolicy()) == vars(jfaults.FaultPolicy())
    for mod in (faults, jfaults):
        f = mod.inject_failures(lambda x: x + 1, fail_on_calls=(2,),
                                oom_on_calls=(3,))
        assert f(1) == 2
        with pytest.raises(mod.TaskCrash):
            f(1)
        with pytest.raises(mod.TaskOOM):
            f(1)
        assert f(2) == 3
        assert issubclass(mod.TaskOOM, mod.TaskError)
        hook = mod.CrashHook(after=1)
        hook.on_append()
        with pytest.raises(mod.CrashInjected):
            hook.on_append()


def _gauge_run(mon):
    g = mon.TenantGauges(occupancy_decay=0.6)
    g.on_dispatch("alice", nodes=2, lanes=8, resident_bytes=4e9, wait=3.0)
    g.on_dispatch("bob", nodes=1, lanes=2, resident_bytes=1e9, wait=0.5)
    for active in (8, 6, 3, 8):
        g.on_lane_sample("alice", "sweep:alice", active, 8)
    g.on_lane_sample("bob", "sweep:bob", 1, 2)
    g.on_heartbeat("bob", "sweep:bob", 0)
    g.on_heartbeat("bob", "sweep:bob", 3)
    g.on_slice_alloc("bob", 0, 1, 0.5, 0.25, lanes=2)
    g.on_preempt("alice", nodes=1, node_time=4.0, lanes=4,
                 resident_bytes=2e9)
    g.on_resume("alice")
    g.on_release("bob", nodes=1, node_time=2.5, lanes=2, resident_bytes=1e9)
    g.on_reject("carol")
    g.on_watchdog_restart("alice")
    tables = (g.table(), g.gang_table(), g.slice_table(),
              g.wait_histogram("alice"), g.wait_quantile("alice", 0.5),
              g.user_occupancy("alice"), g.state_dict())
    g.on_slice_release(0, 1)
    g.on_gang_done("sweep:bob")
    back = mon.TenantGauges()
    back.load_state(g.state_dict())
    return tables + (back.state_dict(), back.table())


def test_tenant_gauges_match_reference():
    assert _gauge_run(monitor) == _gauge_run(jmonitor)


def test_llload_table_matches_reference():
    rows = []
    for mon in (monitor, jmonitor):
        p = mon.StaticProfile(argument_bytes=3e9, temp_bytes=1e9,
                              output_bytes=2e9, flops=4e12,
                              bytes_accessed=5e9)
        rows.append(mon.llload_table("node0", {"job-a": p, "job-b": p},
                                     80e9, {"job-a": 0.5}, 989e12))
    assert rows[0] == rows[1]
    assert "nan" in rows[0]
    np.testing.assert_equal(len(rows[0].splitlines()), 3)
