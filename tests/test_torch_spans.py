"""The port's span recorder (``core.spans``): nothing is recorded and
nothing counted while no profiler records; nesting, parents, requests and
counters; one record per recording session, a span open at the stop
dropped; span times bracketing the profiler's own range; spans inside
``vmap(grad(...))``; each public op of ``kernels/ops.py`` a span with its
shapes and dtype; and the spans a tiny ``BatchServer.run`` and a tiny
``run_sweep`` open under the CPU profiler, with their tokens and losses
bit-identical to an untraced run."""
import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.core import spans
from repro_torch.data import SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch.serve import BatchServer, Request
from repro_torch.launch.sweep import SweepTask, run_sweep
from repro_torch.models.model import Model


def recording():
    return profile(activities=[ProfilerActivity.CPU])


def test_nothing_recorded_or_counted_without_a_profiler():
    with recording():
        with spans.span("kept"):
            pass
    before = spans.record()
    ctx = spans.span("off", req=1)
    assert ctx is spans.span("other")           # one shared no-op
    with ctx as c:
        c.set(late=1)
        spans.count("n", 3)
        with spans.span("inner"):
            spans.count("n", 4)
    assert spans.record() == before
    assert [s["name"] for s in before] == ["kept"]
    assert before[0]["counts"] == {}


def test_nesting_parents_requests_and_counts():
    with recording():
        with spans.span("outer", req=7, k=1) as o:
            spans.count("c", 2)
            with spans.span("inner", req=7):
                spans.count("c", 5)
                spans.count("c", 1)
                spans.count("d", 9)
            with spans.span("sibling"):
                pass
            o.set(late=3)
    rec = spans.record()
    assert [s["name"] for s in rec] == ["outer", "inner", "sibling"]
    outer, inner, sibling = rec
    assert outer["parent"] is None
    assert inner["parent"] == sibling["parent"] == outer["id"]
    assert (outer["req"], inner["req"], sibling["req"]) == (7, 7, None)
    assert outer["attrs"] == {"k": 1, "late": 3}
    assert outer["counts"] == {"c": 2}
    assert inner["counts"] == {"c": 6, "d": 9}
    assert sibling["counts"] == {}
    assert outer["t0_ns"] <= inner["t0_ns"] <= inner["t1_ns"] \
        <= sibling["t0_ns"] <= sibling["t1_ns"] <= outer["t1_ns"]
    for s in rec:
        assert s["host_ms"] == (s["t1_ns"] - s["t0_ns"]) / 1e6
        assert s["stream_ms"] is None           # no CUDA here


def test_one_record_per_session_and_a_span_open_at_stop_dropped():
    with recording():
        with spans.span("first"):
            pass
    with spans.span("between"):
        pass
    prof = recording()
    prof.start()
    with spans.span("kept"):
        pass
    with spans.span("open_at_stop"):
        with spans.span("closed_inside"):
            pass
        prof.stop()
        with spans.span("after_stop"):
            pass
    rec = spans.record()
    assert [s["name"] for s in rec] == ["kept", "closed_inside"]
    assert rec[1]["parent"] == rec[0]["id"] + 1    # the dropped span's id
    with recording():
        with spans.span("next"):
            pass
    assert [s["name"] for s in spans.record()] == ["next"]


def test_span_times_bracket_the_profilers_range():
    with recording() as prof:
        with spans.span("timed", shape=torch.Size([2, 3]),
                        dtype=torch.bfloat16):
            torch.ones(1000).sum()
    (s,) = spans.record()
    assert s["attrs"] == {"shape": [2, 3], "dtype": "bfloat16"}
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == spans.PREFIX + "timed"]
    start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    assert s["t0_ns"] <= start <= end <= s["t1_ns"]
    assert (start - s["t0_ns"]) + (s["t1_ns"] - end) < 5e6


def test_spans_inside_vmap_of_grad():
    def loss(w, x):
        with spans.span("loss"):
            spans.count("calls", 1)
            return ((x @ w) ** 2).sum()

    gen = torch.Generator().manual_seed(0)
    w = torch.randn(3, 4, 2, generator=gen)
    x = torch.randn(3, 5, 4, generator=gen)
    step = torch.func.vmap(torch.func.grad(loss))
    untraced = step(w, x)
    with recording():
        traced = step(w, x)
    assert torch.equal(untraced, traced)
    rec = spans.record()
    assert [s["name"] for s in rec] == ["loss"]
    assert rec[0]["counts"] == {"calls": 1}


def _op_args(name):
    g = torch.Generator().manual_seed(1)
    r = lambda *shape: torch.randn(*shape, generator=g)     # noqa: E731
    if name == "flash_attention":
        return (r(1, 8, 2, 16), r(1, 8, 2, 16), r(1, 8, 2, 16)), \
            {"q": [1, 8, 2, 16], "k": [1, 8, 2, 16]}
    if name == "ssd":
        x, B = r(1, 32, 2, 8), r(1, 32, 4)
        return (x, torch.rand(1, 32, 2, generator=g), -torch.rand(2), B,
                r(1, 32, 4)), {"x": [1, 32, 2, 8], "B": [1, 32, 4]}
    if name == "packed_matmul":
        return (r(2, 4, 8), r(2, 8, 3)), {"x": [2, 4, 8], "w": [2, 8, 3]}
    return (r(2, 4, 8), r(2, 8)), {"x": [2, 4, 8]}


@pytest.mark.parametrize("name", ["flash_attention", "ssd", "packed_matmul",
                                  "packed_norm"])
def test_each_public_op_is_a_span(name):
    args, shapes = _op_args(name)
    with recording():
        getattr(ops, name)(*args)
    (s,) = spans.record()
    assert s["name"] == "op." + name
    assert s["attrs"] == dict(shapes, dtype="float32")


def _bf16_model():
    """The reduced StableLM-2, f32 weights cast to bf16 at their use, as
    the full model is served."""
    cfg = dataclasses.replace(configs.get("stablelm-1.6b").reduced(),
                              compute_dtype="bfloat16")
    model = Model(cfg, device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def _requests():
    rng = np.random.default_rng(0)
    return [Request(id=i, prompt=rng.integers(1, 256, s).astype(np.int32),
                    max_new=m)
            for i, (s, m) in enumerate(zip([3, 9, 5, 7, 4], [6, 2, 9, 1, 4]))]


def _cast_weights_bytes(params) -> int:
    """The f32 bytes of every weight a decode step casts: each block's
    products and the unembedding (norms and the embedding's rows are not
    weights cast at their use)."""
    total = params["unembed"].numel() * params["unembed"].element_size()
    todo = [params["blocks"]]
    while todo:
        t = todo.pop()
        for k, v in t.items():
            if isinstance(v, dict):
                todo.append(v)
            elif k.startswith("w_"):
                total += v.numel() * v.element_size()
    return total


@pytest.mark.parametrize("lanes", [2, 3])
def test_batch_server_spans(lanes):
    model, params = _bf16_model()
    srv = BatchServer(model, params, batch_lanes=lanes, max_len=32)
    untraced = srv.run(_requests())
    with recording():
        traced = srv.run(_requests())
    assert traced == untraced
    rec = spans.record()
    names = collections.Counter(s["name"] for s in rec)
    st = srv.stats
    assert names["serve.decode_step"] == names["serve.read"] \
        == st.global_steps
    assert names["serve.iteration"] == st.global_steps + 1
    assert names["model.block"] == model.cfg.num_layers * (st.global_steps
                                                          + st.prefills)
    for name in ("serve.prefill", "serve.attach"):
        assert sorted(s["req"] for s in rec if s["name"] == name) \
            == list(range(5))
    by_id = {s["id"]: s for s in rec}
    for s in rec:
        if s["name"] in ("serve.read", "serve.emit"):
            assert by_id[s["parent"]]["name"] in ("serve.decode_step",
                                                  "serve.iteration")
    # one decode step's casts: every cast weight once, in f32 bytes
    from perfbench.metrics._spans import counted_under
    per_step = counted_under(rec, "serve.decode_step", "cast_bytes")
    assert per_step == [_cast_weights_bytes(params)] * st.global_steps


def test_run_sweep_spans():
    model = Model(configs.get("stablelm-1.6b").reduced(), device="cpu")
    tasks = lambda: [SweepTask(id=i, lr=1e-3, seed=i, steps=b)     # noqa: E731
                     for i, b in enumerate([2, 3, 1, 2])]

    def batch_fn(seed, step):
        return SyntheticLM(model.cfg.vocab_size, 8, 2, seed=seed).batch(step)

    untraced = run_sweep(model, tasks(), batch_fn=batch_fn, steps=1,
                         max_pack=2)
    with recording():
        traced = run_sweep(model, tasks(), batch_fn=batch_fn, steps=1,
                           max_pack=2)
    assert traced.losses == untraced.losses
    rec = spans.record()
    names = collections.Counter(s["name"] for s in rec)
    steps = traced.global_steps
    for name in ("pool.iteration", "pool.batch", "pool.step", "pool.retire",
                 "pool.select", "train.grad", "train.update"):
        assert names[name] == steps, name
    refills = [s for s in rec if s["name"] == "pool.refill"]
    assert sum(s["attrs"]["attached"] for s in refills) == traced.refills
    by_id = {s["id"]: s for s in rec}
    for s in rec:
        if s["name"] in ("train.grad", "train.update", "pool.select"):
            assert by_id[s["parent"]]["name"] == "pool.step"
        if s["name"].startswith("pool.") and s["name"] != "pool.iteration" \
                and s["name"] != "pool.select":
            assert by_id[s["parent"]]["name"] == "pool.iteration"
    its = [s for s in rec if s["name"] == "pool.iteration"]
    assert [s["attrs"]["step"] for s in its] == list(range(steps))
    assert all(s["attrs"]["capacity"] == 2 for s in its)
