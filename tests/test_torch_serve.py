"""The port's continuous-batching ``BatchServer``: greedy tokens equal to the
JAX ``BatchServer`` on the same parameters and requests, and the decode
accounting and lane-isolation invariants of tests/test_serve_continuous.py,
for the dense family (KV caches) and the ssm family (Mamba2 states)."""
import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.launch.serve import BatchServer as JServer, Request as JRequest
from repro.models import ParallelCtx as JCtx, build_model as jbuild
import torch

from repro_torch import configs
from repro_torch.core import packing
from repro_torch.launch.serve import BatchServer, Request
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model

ARCHS = ["stablelm-1.6b", "mamba2-130m"]


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    """(jax model, jax params, the same params for the port, arch)."""
    arch = request.param
    jm = jbuild(jconfigs.get(arch).reduced(), JCtx(moe_oracle=True))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                     "cpu"), arch


def _srv(ref, lanes, max_len=32, adaptive_lanes=False):
    model = Model(configs.get(ref[3]).reduced(), device="cpu")
    return BatchServer(model, ref[2], batch_lanes=lanes, max_len=max_len,
                       adaptive_lanes=adaptive_lanes)


def _mixed(cls):
    rng = np.random.default_rng(0)
    lens, news = [3, 9, 5, 7, 4], [6, 2, 9, 1, 4]
    return [cls(id=i, prompt=rng.integers(1, 256, s).astype(np.int32),
                max_new=m) for i, (s, m) in enumerate(zip(lens, news))]


@pytest.mark.parametrize("lanes,adaptive", [(2, False), (3, False),
                                            (4, True)])
def test_tokens_match_reference_server(ref, lanes, adaptive):
    jm, jp, _, _ = ref
    want = JServer(jm, jp, batch_lanes=lanes, max_len=32,
                   adaptive_lanes=adaptive).run(_mixed(JRequest))
    srv = _srv(ref, lanes, adaptive_lanes=adaptive)
    got = srv.run(_mixed(Request))
    assert got == want
    assert srv.stats.lane_steps == sum(r.max_new for r in _mixed(Request))


def _chunked(cls):
    """Prompts whose padded length, 64, is a multiple of the reduced SSD
    chunk (32), so a Mamba2 prefill scans two chunks."""
    rng = np.random.default_rng(1)
    lens, news = [20, 64, 33, 47, 9], [5, 3, 8, 2, 6]
    return [cls(id=i, prompt=rng.integers(1, 256, s).astype(np.int32),
                max_new=m) for i, (s, m) in enumerate(zip(lens, news))]


@pytest.mark.parametrize("lanes,adaptive", [(2, False), (4, True)])
def test_tokens_match_reference_server_over_chunks(ref, lanes, adaptive):
    jm, jp, _, _ = ref
    want = JServer(jm, jp, batch_lanes=lanes, max_len=80,
                   adaptive_lanes=adaptive).run(_chunked(JRequest))
    srv = _srv(ref, lanes, max_len=80, adaptive_lanes=adaptive)
    assert srv.run(_chunked(Request)) == want
    assert srv.stats.lane_steps == sum(r.max_new for r in _chunked(Request))
    assert srv.stats.prefills == 5


def test_decode_steps_equal_sum_max_new_not_batch_times_max(ref):
    srv = _srv(ref, lanes=2)
    max_news = [2, 8, 3, 5]
    reqs = [Request(id=i, prompt=np.arange(1, 5, dtype=np.int32),
                    max_new=m) for i, m in enumerate(max_news)]
    out = srv.run(reqs)
    assert srv.stats.lane_steps == sum(max_news)
    assert all(len(out[r.id]) == r.max_new for r in reqs)
    assert all(r.done for r in reqs)
    assert srv.stats.global_steps < sum(max_news)
    assert srv.stats.prefills == len(reqs)


def test_request_tokens_independent_of_coresidents(ref):
    prompt = np.arange(1, 5, dtype=np.int32)
    out = _srv(ref, lanes=2).run(
        [Request(id=0, prompt=prompt, max_new=2),
         Request(id=1, prompt=prompt, max_new=6),
         Request(id=2, prompt=np.arange(2, 6, dtype=np.int32), max_new=4)])
    solo = _srv(ref, lanes=1).run([Request(id=9, prompt=prompt, max_new=6)])
    assert out[1] == solo[9]
    # the mid-decode joiner's first (prefill) token is emitted before its
    # lane is ever stepped
    solo2 = _srv(ref, lanes=1).run(
        [Request(id=8, prompt=np.arange(2, 6, dtype=np.int32), max_new=4)])
    assert out[2] == solo2[8]


@pytest.mark.parametrize("max_new,steps", [(1, 0), (5, 4)])
def test_final_decode_step_not_wasted(ref, max_new, steps):
    """max_new=1 takes no decode step (prefill supplies the only token);
    m tokens take exactly m-1 steps."""
    srv = _srv(ref, lanes=1)
    out = srv.run([Request(id=0, prompt=np.arange(1, 5, dtype=np.int32),
                           max_new=max_new)])
    assert len(out[0]) == max_new
    assert srv.stats.global_steps == steps
    assert srv.stats.lane_steps == max_new


def test_enqueue_rejects_requests_past_kv_cache_length(ref):
    good = Request(id=0, prompt=np.arange(1, 5, dtype=np.int32), max_new=4)
    bad = Request(id=1, prompt=np.arange(1, 5, dtype=np.int32), max_new=9)
    with pytest.raises(ValueError, match="max_len"):
        _srv(ref, lanes=2, max_len=8).run([good, bad])
    # padding counts: a long co-resident prompt pushes S_pad over
    with pytest.raises(ValueError, match="max_len"):
        _srv(ref, lanes=2, max_len=8).run(
            [Request(id=2, prompt=np.arange(1, 8, dtype=np.int32), max_new=1),
             Request(id=3, prompt=np.arange(1, 3, dtype=np.int32),
                     max_new=3)])
    good = Request(id=0, prompt=np.arange(1, 5, dtype=np.int32), max_new=4)
    assert len(_srv(ref, lanes=2, max_len=8).run([good])[0]) == 4
    exact = Request(id=4, prompt=np.arange(1, 5, dtype=np.int32), max_new=5)
    assert len(_srv(ref, lanes=1, max_len=8).run([exact])[4]) == 5


def test_adaptive_lanes_shrink_to_queue_depth_same_tokens(ref):
    prompt = np.arange(1, 5, dtype=np.int32)
    max_news = [2, 3, 12, 2]
    mk = lambda: [Request(id=i, prompt=prompt, max_new=m)
                  for i, m in enumerate(max_news)]
    fixed = _srv(ref, lanes=4)
    base = fixed.run(mk())
    srv = _srv(ref, lanes=4, adaptive_lanes=True)
    assert srv.run(mk()) == base
    assert srv.stats.lane_steps == sum(max_news)
    assert srv.stats.resizes >= 1
    assert srv.stats.lane_trace[-1][1] == 1
    assert srv.stats.global_steps == fixed.stats.global_steps
    assert srv.stats.lane_slots < fixed.stats.lane_slots
    assert srv.stats.step_efficiency > fixed.stats.step_efficiency


def test_zero_max_new_request_is_done_immediately(ref):
    srv = _srv(ref, lanes=1)
    reqs = [Request(id=0, prompt=np.arange(1, 4, dtype=np.int32), max_new=0),
            Request(id=1, prompt=np.arange(1, 4, dtype=np.int32), max_new=2)]
    out = srv.run(reqs)
    assert out[0] == [] and len(out[1]) == 2
    assert reqs[0].done and reqs[1].done
    srv.run([Request(id=2, prompt=np.arange(1, 4, dtype=np.int32),
                     max_new=0)])
    assert srv.stats.lane_steps == 0 and srv.stats.n_requests == 0


@pytest.mark.parametrize("axis", [0, 1])
def test_lane_get_set_stack_roundtrip(axis):
    """Lanes of a nested tree: stacking, reading a lane (a view) and
    writing one in place leave the other lanes untouched."""
    def tree(seed):
        g = torch.Generator().manual_seed(seed)
        return {"k": torch.randn(3, 5, generator=g),
                "c": {"len": torch.randint(0, 9, (3,), generator=g)}}
    lanes = [tree(i) for i in range(4)]
    pool = packing.stack_trees(lanes, axis)
    assert pool["k"].shape[axis] == 4 and pool["c"]["len"].shape[axis] == 4
    for i, lane in enumerate(lanes):
        got = packing.tree_get_lane(pool, i, axis)
        assert torch.equal(got["k"], lane["k"])
        assert torch.equal(got["c"]["len"], lane["c"]["len"])
    new = tree(9)
    assert packing.tree_set_lane(pool, 2, new, axis) is pool
    for i, lane in enumerate(lanes[:2] + [new] + lanes[3:]):
        assert torch.equal(packing.lane_slice(pool, i, axis)["k"], lane["k"])
