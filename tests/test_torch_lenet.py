"""The training slice's model and math against the JAX package: LeNet-4
(``apply``, ``loss``, gradients), the optimizers, lane packing
(``tests/test_packing.py`` on the port, and packed losses against the
reference's), the copied triples planner and synthetic data, and the
monitor's profile.

Inputs and parameters are made once (numpy or the reference's PRNG) and
handed to both packages as numpy arrays. Tolerances, f32 throughout:
- logits and losses: rtol = atol = 1e-5 (XLA's convolution against the
  port's im2col matmul: the same products summed in another order);
- gradients: rtol = 1e-5, atol = 1e-6 (largest |grad| ~0.3);
- one optimizer update: rtol = 1e-6, atol = 1e-7 (elementwise f32 math; the
  bias corrections' pow may differ in the last bit);
- five packed training steps: rtol = 1e-4, atol = 1e-6 (the rounding
  differences above, carried through five updates);
- inside the port, packed == sequential at the reference's own bound
  (tests/test_packing.py:75, rtol = 2e-5, atol = 1e-6), and lane-count
  independence exactly (``torch.equal``).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.core import packing as jpacking
from repro.core import triples as jtriples
from repro.core.monitor import profile_fn as j_profile_fn
from repro.data import mnist as jmnist
from repro.models import lenet as jlenet
from repro_torch import optim
from repro_torch.core import packing, triples
from repro_torch.core.monitor import (RunMonitor, StaticProfile,
                                      memory_per_lane, profile_fn)
from repro_torch.data import mnist
from repro_torch.models import lenet
from repro_torch.models.convert import params_from_numpy

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
UPDATE_TOL = dict(rtol=1e-6, atol=1e-7)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-6)
PACKED_TOL = dict(rtol=2e-5, atol=1e-6)


def _jparams(seed):
    return jax.tree_util.tree_map(np.asarray,
                                  jlenet.init(jax.random.PRNGKey(seed)))


def _tparams(np_tree):
    return params_from_numpy(np_tree, "cpu")


def _batch_np(batch, step, seed):
    return mnist.synthetic_mnist(batch, step, seed=seed)


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _close(got, want, tol):
    if isinstance(got, dict):
        assert set(got) == set(want)
        for k in got:
            _close(got[k], want[k], tol)
        return
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# LeNet-4
# ---------------------------------------------------------------------------

def test_init_matches_reference_tree():
    ref = _jparams(0)
    got = lenet.init(torch.Generator().manual_seed(0), device="cpu")
    assert set(got) == set(ref)
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape
        assert got[k].dtype == torch.float32 and ref[k].dtype == np.float32
        assert got[k].device.type == "cpu"


def _init_default_device():
    lenet.init(torch.Generator().manual_seed(0))


def _init_on_cuda_explicit():
    lenet.init(torch.Generator().manual_seed(0), device="cuda")


def _packed_jobs_default_device():
    opt = optim.sgd()
    packing.PackedJobs.create(lenet.init, opt.init, _step_fn(lenet.loss, opt),
                              torch.Generator().manual_seed(0), n_lanes=2,
                              hparams=torch.full((2,), 1e-2))


@pytest.mark.parametrize("call", [_init_default_device,
                                  _init_on_cuda_explicit,
                                  _packed_jobs_default_device])
def test_init_runs_on_the_card_unless_asked_otherwise(call):
    """LeNet-4's params, and so a ``PackedJobs`` built from ``lenet.init``,
    go to ``cuda`` unless the caller asks for the CPU: without a card that
    raises rather than train quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


@pytest.mark.parametrize("batch", [1, 8, 64])
def test_apply_and_loss_match_reference(batch):
    p_np, b_np = _jparams(1), _batch_np(batch, 0, 3)
    want = jlenet.apply(p_np, jnp.asarray(b_np["image"]))
    got = lenet.apply(_tparams(p_np), torch.from_numpy(b_np["image"]))
    _close(got, want, OUT_TOL)
    _close(lenet.loss(_tparams(p_np), _tbatch(b_np)),
           jlenet.loss(p_np, _jbatch(b_np)), OUT_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grads_match_reference(seed):
    p_np, b_np = _jparams(seed), _batch_np(16, seed, seed)
    want_l, want_g = jax.value_and_grad(jlenet.loss)(p_np, _jbatch(b_np))
    got_g, got_l = torch.func.grad_and_value(lenet.loss)(_tparams(p_np),
                                                         _tbatch(b_np))
    _close(got_l, want_l, OUT_TOL)
    _close(got_g, want_g, GRAD_TOL)


def test_max_pool_gradient_goes_to_the_first_tie():
    """Images clipped at 0 make many equal activations; the reference's
    max-pool gradient picks the first maximum of each window, and so must
    the port's, or the gradients differ by whole values, not by rounding."""
    p_np = _jparams(4)
    b_np = _batch_np(4, 0, 4)
    b_np["image"][:, :14, :14, :] = 0.0        # exact ties in every layer
    want = jax.grad(jlenet.loss)(p_np, _jbatch(b_np))
    got = torch.func.grad(lenet.loss)(_tparams(p_np), _tbatch(b_np))
    _close(got, want, GRAD_TOL)


def test_im2col_conv_grads_independent_of_lane_count():
    """Under vmap over lanes, a lane's gradient does not depend on how many
    lanes run beside it (8, 4 or 2), bit for bit: the property the pool's
    bit-identity guarantees rest on (F.conv2d breaks it; im2col does not)."""
    params = packing.stack_trees([_tparams(_jparams(i)) for i in range(8)])
    batch = packing.stack_trees([_tbatch(_batch_np(8, 0, i))
                                 for i in range(8)])
    f = torch.func.vmap(torch.func.grad_and_value(lenet.loss))
    g8, l8 = f(params, batch)
    for n in (4, 2):
        sub = lambda t: {k: v[:n] for k, v in t.items()}
        gn, ln = f(sub(params), sub(batch))
        assert torch.equal(ln, l8[:n])
        for k in gn:
            assert torch.equal(gn[k], g8[k][:n]), (n, k)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _grads_np(seed, like):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(v.shape).astype(np.float32) * 0.5
            for k, v in like.items()}


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("sgd", {"grad_clip": 1.0}),
    ("adamw", {}), ("adamw", {"weight_decay": 0.0, "grad_clip": 0.0}),
])
def test_optimizer_updates_match_reference(name, kw):
    p_np = _jparams(5)
    jopt, topt = getattr(joptim, name)(**kw), getattr(optim, name)(**kw)
    jstate, tstate = jopt.init(p_np), topt.init(_tparams(p_np))
    for step in range(3):          # moments and the count carry over
        g_np = _grads_np(step, p_np)
        jup, jstate = jopt.update(g_np, jstate, p_np, jnp.float32(0.01))
        tup, tstate = topt.update(_tparams(g_np), tstate, _tparams(p_np),
                                  torch.tensor(0.01))
        _close(tup, jup, UPDATE_TOL)
        _close(tstate, jax.tree_util.tree_map(np.asarray, jstate),
               UPDATE_TOL)
    new = optim.apply_updates(_tparams(p_np), tup)
    _close(new, joptim.apply_updates(p_np, jup), UPDATE_TOL)


def test_adamw_bf16_moments_keep_f32_math():
    p_np = _jparams(6)
    jopt = joptim.adamw(moment_dtype=jnp.bfloat16)
    topt = optim.adamw(moment_dtype=torch.bfloat16)
    g_np = _grads_np(9, p_np)
    jup, js = jopt.update(g_np, jopt.init(p_np), p_np, jnp.float32(1e-3))
    tup, ts = topt.update(_tparams(g_np), topt.init(_tparams(p_np)),
                          _tparams(p_np), torch.tensor(1e-3))
    assert all(v.dtype == torch.bfloat16 for v in ts["mu"].values())
    _close(tup, jup, UPDATE_TOL)
    _close(ts["nu"], jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), js["nu"]), UPDATE_TOL)


def test_global_norm_and_clip_match_reference():
    g_np = _grads_np(2, _jparams(0))
    _close(optim.global_norm(_tparams(g_np)), joptim.global_norm(g_np),
           UPDATE_TOL)
    got, gnorm = optim.clip_by_global_norm(_tparams(g_np), 0.5)
    want, _ = joptim.clip_by_global_norm(g_np, 0.5)
    _close(got, want, UPDATE_TOL)
    _close(optim.global_norm(got), np.float32(0.5), UPDATE_TOL)


# ---------------------------------------------------------------------------
# packing (tests/test_packing.py on the port) and packed LeNet training
# ---------------------------------------------------------------------------

def _tiny_params(seed):
    rng = np.random.default_rng(seed)
    return {"w1": (rng.standard_normal((8, 16)) * 0.1).astype(np.float32),
            "w2": (rng.standard_normal((16, 4)) * 0.1).astype(np.float32)}


def _tiny_batch(seed, step, n=32):
    rng = np.random.Generator(np.random.Philox(key=seed,
                                               counter=[step, 0, 0, 0]))
    x = rng.standard_normal((n, 8)).astype(np.float32)
    return {"x": x, "y": (x[:, :4] * 0.5).astype(np.float32)}


def _tiny_loss(params, batch):
    h = torch.tanh(batch["x"] @ params["w1"])
    return torch.mean((h @ params["w2"] - batch["y"]) ** 2)


def _j_tiny_loss(params, batch):
    h = jnp.tanh(batch["x"] @ params["w1"])
    return jnp.mean((h @ params["w2"] - batch["y"]) ** 2)


def _step_fn(loss, opt):
    def step(params, opt_state, batch, lr):
        g, l = torch.func.grad_and_value(loss)(params, batch)
        upd, opt_state = opt.update(g, opt_state, params, lr)
        return optim.apply_updates(params, upd), opt_state, {"loss": l}
    return step


def _j_step_fn(loss, opt):
    def step(params, opt_state, batch, lr):
        l, g = jax.value_and_grad(loss)(params, batch)
        upd, opt_state = opt.update(g, opt_state, params, lr)
        return joptim.apply_updates(params, upd), opt_state, {"loss": l}
    return step


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_packed_equals_sequential_and_reference(opt_name):
    make = {"sgd": lambda m: m.sgd(),
            "adamw": lambda m: m.adamw(weight_decay=0.0)}[opt_name]
    opt, jopt = make(optim), make(joptim)
    step, jstep = _step_fn(_tiny_loss, opt), _j_step_fn(_j_tiny_loss, jopt)
    lrs, seeds, K, steps = [1e-2, 3e-2, 1e-3], [0, 1, 2], 3, 5

    seq = []
    for lane in range(K):
        p = _tparams(_tiny_params(seeds[lane]))
        o = opt.init(p)
        ls = []
        for s in range(steps):
            p, o, m = step(p, o, _tbatch(_tiny_batch(seeds[lane], s)),
                           torch.tensor(lrs[lane]))
            ls.append(float(m["loss"]))
        seq.append(ls)

    params = packing.stack_trees([_tparams(_tiny_params(s)) for s in seeds])
    opt_state = packing.stack_trees([opt.init(packing.lane_slice(params, i))
                                     for i in range(K)])
    packed = packing.packed_step(step)
    lr_vec = torch.tensor(lrs)
    got = [[] for _ in range(K)]
    for s in range(steps):
        batch = packing.stack_trees([_tbatch(_tiny_batch(seeds[i], s))
                                     for i in range(K)])
        params, opt_state, m = packed(params, opt_state, batch, lr_vec)
        for i in range(K):
            got[i].append(float(m["loss"][i]))
    np.testing.assert_allclose(np.array(seq), np.array(got), **PACKED_TOL)

    jp = jpacking.stack_trees([_tiny_params(s) for s in seeds])
    jo = jax.vmap(jopt.init)(jp)
    jpacked = jpacking.packed_step(jstep, donate=False)
    want = [[] for _ in range(K)]
    for s in range(steps):
        batch = jpacking.stack_trees([_jbatch(_tiny_batch(seeds[i], s))
                                      for i in range(K)])
        jp, jo, m = jpacked(jp, jo, batch, jnp.asarray(lrs, jnp.float32))
        for i in range(K):
            want[i].append(float(m["loss"][i]))
    np.testing.assert_allclose(np.array(got), np.array(want), **TRAIN_TOL)


def test_stack_unstack_roundtrip():
    trees = [{"a": torch.arange(3) + i, "b": {"c": torch.ones(2, 2) * i}}
             for i in range(4)]
    back = packing.unstack_tree(packing.stack_trees(trees), 4)
    for orig, rec in zip(trees, back):
        assert torch.equal(orig["a"], rec["a"])
        assert torch.equal(orig["b"]["c"], rec["b"]["c"])


def test_packed_jobs_lifecycle():
    opt = optim.sgd()
    step = _step_fn(_tiny_loss, opt)

    def init(gen):
        return {"w1": torch.randn(8, 16, generator=gen) * 0.1,
                "w2": torch.randn(16, 4, generator=gen) * 0.1}

    jobs = packing.PackedJobs.create(init, opt.init, step,
                                     torch.Generator().manual_seed(0),
                                     n_lanes=4, hparams=torch.full((4,), 1e-2))
    assert not torch.equal(jobs.params["w1"][0], jobs.params["w1"][1])
    m = jobs.run_step(packing.stack_trees([_tbatch(_tiny_batch(i, 0))
                                           for i in range(4)]))
    assert m["loss"].shape == (4,) and torch.isfinite(m["loss"]).all()
    p0, _ = jobs.lane_state(0)
    assert p0["w1"].shape == (8, 16)
    p_list = [jobs.lane_state(i)[0] for i in range(2)]
    o_list = [jobs.lane_state(i)[1] for i in range(2)]
    jobs2 = jobs.replace_lanes(p_list, o_list, torch.full((2,), 1e-2))
    m2 = jobs2.run_step(packing.stack_trees([_tbatch(_tiny_batch(i, 1))
                                             for i in range(2)]))
    assert m2["loss"].shape == (2,)


def test_packed_lenet_losses_match_reference():
    """The paper's workflow, small: 4 LeNet-4 lanes with per-lane learning
    rates, packed SGD, 5 steps, against the reference's packed program."""
    K, steps, B = 4, 5, 8
    lrs = [0.01 * (i + 1) for i in range(K)]
    p_np = [_jparams(i) for i in range(K)]
    opt, jopt = optim.sgd(), joptim.sgd()
    step = _step_fn(lenet.loss, opt)
    jstep = _j_step_fn(jlenet.loss, jopt)
    params = packing.stack_trees([_tparams(p) for p in p_np])
    ostate = packing.stack_trees([opt.init(packing.lane_slice(params, i))
                                  for i in range(K)])
    jp = jpacking.stack_trees(p_np)
    jo = jax.vmap(jopt.init)(jp)
    packed = packing.packed_step(step)
    jpacked = jpacking.packed_step(jstep, donate=False)
    for s in range(steps):
        b_np = [_batch_np(B, s, i) for i in range(K)]
        params, ostate, m = packed(params, ostate, packing.stack_trees(
            [_tbatch(b) for b in b_np]), torch.tensor(lrs))
        jp, jo, jm = jpacked(jp, jo, jpacking.stack_trees(
            [_jbatch(b) for b in b_np]), jnp.asarray(lrs, jnp.float32))
        _close(m["loss"], jm["loss"], TRAIN_TOL)
    _close(params, jax.tree_util.tree_map(np.asarray, jp), TRAIN_TOL)


# ---------------------------------------------------------------------------
# copied modules: triples planner and synthetic data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_tasks,trip,cpn", [
    (8, (1, 8, 1), 1), (24, (2, 6, 2), 4), (10, (1, 4, 3), 4),
    (7, (3, 5, 1), 8), (0, (1, 2, 2), 2), (33, (2, 16, 1), 4),
])
def test_plan_matches_reference(n_tasks, trip, cpn):
    got = triples.plan(n_tasks, triples.Triples(*trip),
                       triples.NodeSpec(chips_per_node=cpn))
    want = jtriples.plan(n_tasks, jtriples.Triples(*trip),
                         jtriples.NodeSpec(chips_per_node=cpn))
    assert ([dataclasses.astuple(s) for s in got.slots]
            == [dataclasses.astuple(s) for s in want.slots])
    assert got.pack_factor == want.pack_factor
    assert got.chip_load() == want.chip_load()
    spec = triples.NodeSpec(chips_per_node=cpn)
    assert (triples.recommend_for_gpus(n_tasks, 2, spec, 3)
            == triples.Triples(*dataclasses.astuple(
                jtriples.recommend_for_gpus(
                    n_tasks, 2, jtriples.NodeSpec(chips_per_node=cpn), 3))))


@pytest.mark.parametrize("fn,kw", [("synthetic_mnist", {}),
                                   ("synthetic_imagenet", {"res": 16})])
def test_synthetic_data_matches_reference(fn, kw):
    for step in (0, 3):
        got = getattr(mnist, fn)(5, step, seed=7, **kw)
        want = getattr(jmnist, fn)(5, step, seed=7, **kw)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# monitor
# ---------------------------------------------------------------------------

def _lenet_step(opt):
    return _step_fn(lenet.loss, opt)


def test_profile_fn_counts_the_step_on_the_cpu():
    """FLOPs are the matmul work of one LeNet-4 SGD step: the forward, the
    weight gradients, and the input gradients of every layer but the first
    (the image needs none). On the CPU resident bytes are arguments plus
    outputs only."""
    B = 8
    opt = optim.sgd()
    p = _tparams(_jparams(0))
    args = (p, opt.init(p), _tbatch(_batch_np(B, 0, 0)), torch.tensor(0.05))
    prof = profile_fn(_lenet_step(opt), *args)
    conv1 = 2 * B * 4 * 25 * 28 * 28
    fwd = conv1 + 2 * B * 16 * 100 * 14 * 14 + 2 * B * 784 * 120 \
        + 2 * B * 120 * 10
    assert prof.flops == 3 * fwd - conv1
    n_param = sum(v.numel() for v in p.values())
    batch_bytes = B * 28 * 28 * 4 + B * 4
    assert prof.argument_bytes == 4 * 2 * n_param + batch_bytes + 4
    assert prof.output_bytes == 4 * 2 * n_param + 4
    assert prof.temp_bytes == 0
    assert prof.resident_bytes == prof.argument_bytes + prof.output_bytes
    assert prof.bytes_accessed == prof.resident_bytes
    assert memory_per_lane(_lenet_step(opt), *args) == prof.resident_bytes
    # the reference's resident bytes include XLA's temporaries: never fewer
    jp = _jparams(0)
    jprof = j_profile_fn(_j_step_fn(jlenet.loss, joptim.sgd()), jp,
                         joptim.sgd().init(jp), _jbatch(_batch_np(B, 0, 0)),
                         jnp.float32(0.05))
    assert jprof.argument_bytes == prof.argument_bytes
    assert jprof.resident_bytes >= prof.resident_bytes


def test_static_profile_fits_and_load_proxy():
    prof = StaticProfile(argument_bytes=100, temp_bytes=50, output_bytes=50,
                         flops=1e9, bytes_accessed=200)
    assert prof.resident_bytes == 200
    assert prof.fits(1000) and not prof.fits(200)
    assert math.isclose(prof.load_proxy(1e12, 0.01), 0.1)


def test_run_monitor_flags_stragglers():
    mon = RunMonitor(straggler_ratio=1.5)
    for step in range(4):
        mon.start_step()
        mon.end_step(step, lane_times=np.array([1.0, 1.0, 3.0, 1.1]))
    assert mon.stragglers() == [2]
    s = mon.summary()
    assert s["steps"] == 4 and s["last_live_bytes"] == 0
