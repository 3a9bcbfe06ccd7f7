"""The comparison that decides ``correct``, at a tiny size on the CPU:
the harness's whole run (set-up, window, comparison) with the look for a
card skipped. The port passes against the plain reference; the control
(the reference in fp8 put in the program's place) fails; and each fault a
cell can have, planted in the port, makes ``correct`` false."""
from __future__ import annotations

from perfbench import calibrate
from perfbench.common import check
from perfbench.drivers import serve, sweep
from perfbench.tests.helpers import (SEED, SERVE_S, SWEEP_S, run_tiny,
                                     tiny_cell)


def test_serve_port_passes_and_control_fails():
    cell = tiny_cell("serve")
    out = serve.run(cell, SEED, SERVE_S, False, "cpu")
    assert all(c["ok"] for c in out["checks"]), out["checks"]
    # the control over every request that was served two tokens or more
    out["compared"]["picked"] = [r for r in out["compared"]["served"]
                                 if len(r.out) > 1]
    control = calibrate.serve_control(out, "cpu")
    assert not check("logit_gap", control,
                           cell["limits"]["logit_gap"])["ok"]


def test_sweep_port_passes_and_control_fails():
    cell = tiny_cell("sweep")
    out = sweep.run(cell, SEED, SWEEP_S, False, "cpu")
    assert all(c["ok"] for c in out["checks"]), out["checks"]
    # the compared tasks are ones a refill attached inside the window
    first_pack = out["ctx"]["train"]["first_pack"]
    assert len(out["compared"]["prog"]) == cell["traffic"]["compare_tasks"]
    assert not set(out["compared"]["prog"]) & set(first_pack)
    control = calibrate.sweep_control(out, "cpu")
    assert any(not check(k, control[k], limit)["ok"]
               for k, limit in cell["limits"].items()), control


def test_serve_run_result_line():
    r = run_tiny("serve")
    assert r["correct"] is True
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"serve_tokens_per_s", "setup_s"}
    assert r["attempted"] > 0


def test_token_altered_where_produced_fails():
    """Every third decode step's logits negated: the tokens it serves are
    the worst ones."""
    def plant(model):
        step = model.decode_step
        calls = []

        def altered(*a, **kw):
            logits, cache = step(*a, **kw)
            calls.append(1)
            return (-logits if len(calls) % 3 == 0 else logits), cache
        model.decode_step = altered
    assert run_tiny("serve", plant=plant)["correct"] is False


def test_sweep_run_result_line():
    r = run_tiny("sweep", seconds=SWEEP_S)
    assert r["correct"] is True
    assert set(r["metrics"]) == {"train_tokens_per_s", "setup_s"}


def test_half_of_the_batch_left_out_fails():
    r = run_tiny("sweep", seconds=SWEEP_S, plant=calibrate.half_batch)
    assert r["correct"] is False
    assert r["checks"]["grad_gap"]["value"] > r["checks"]["grad_gap"]["limit"]


def test_step_that_returns_its_state_unchanged_fails():
    """The step computes the loss and hands back the state it was given."""
    def plant(model_cls):
        class Frozen(model_cls):
            def loss(self, params, batch):
                total, metrics = super().loss(params, batch)
                # the loss's value, and a zero gradient for every param
                return total * 0 + total.detach(), metrics
        return Frozen

    r = run_tiny("sweep", seconds=SWEEP_S, plant=plant)
    assert r["correct"] is False
    assert r["checks"]["update_gap"]["value"] >= 0.99


def test_refilled_lane_that_keeps_the_moments_fails():
    """A lane attached a second time keeps the AdamW moments of the task
    it held before."""
    with calibrate.stale_moments():
        r = run_tiny("sweep", seconds=SWEEP_S)
    assert r["correct"] is False
    assert r["checks"]["grad_gap"]["value"] > r["checks"]["grad_gap"]["limit"]


def test_decode_step_that_returns_its_state_unchanged_fails():
    """Every decode step hands back the cache it was given."""
    def plant(model):
        step = model.decode_step

        def stale(params, batch, cache, **kw):
            logits, _ = step(params, batch, tree_clone(cache), **kw)
            return logits, cache
        model.decode_step = stale
    assert run_tiny("serve", plant=plant)["correct"] is False


def tree_clone(tree):
    if isinstance(tree, dict):
        return {k: tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_clone(v) for v in tree)
    return tree.clone() if hasattr(tree, "clone") else tree
