"""The port's MoE FFN (``repro_torch.models.moe``) and the moe family's
``Model`` against the JAX reference, f32 on the CPU from the reference's own
parameters and numpy-seeded inputs: the router, the dense oracle, the
capacity-dispatch path (dropless, with drops, and routed per group as the
serving pool routes its lanes), shared experts and Arctic's dense residual,
and the reduced deepseek-moe-16b and arctic-480b models' prefill, decode,
loss (ce and aux) and the loss's gradient.

Tolerances: the router's weights and aux within 1e-6 (the same f32 softmax
and sums); FFN outputs within 2e-5, the reference's own bound between its
modes (``bench_kernels.py:119-125``); model logits and losses within 1e-4,
as ``tests/test_torch_model.py`` (two layers of f32 products summed in
other orders); gradients within 1e-4 relative to each leaf's largest
entry (sums over every token in other orders)."""
import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.compat  # noqa: F401  (jax version shims)
from repro import configs as jconfigs
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import ParallelCtx as JCtx, build_model as jbuild
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model
from repro_torch.models.transformer import ParallelCtx

ROUTER_TOL = dict(rtol=1e-6, atol=1e-6)
FFN_TOL = dict(rtol=2e-5, atol=2e-5)
ATOL = 1e-4
GRAD_REL = 1e-4
ARCHS = ["deepseek-moe-16b", "arctic-480b"]


def _setup(E=8, top_k=2, dff=16, d=32, T=40, cf=0.0, shared=0, seed=0):
    """The reference's ``tests/test_moe.py`` set-up: (port config, port
    params, reference config, reference params, x as numpy)."""
    kw = dict(num_experts=E, top_k=top_k, expert_d_ff=dff,
              capacity_factor=cf, num_shared_experts=shared)
    jm = JMoEConfig(**kw)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), d, jm, jnp.float32)
    x = np.random.default_rng(seed + 1).standard_normal((T, d)).astype(
        np.float32)
    return (MoEConfig(**kw), params_from_numpy(_np(jp), "cpu"), jm, jp, x)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("E,top_k,T", [(8, 2, 40), (4, 1, 7), (16, 4, 33),
                                       (64, 6, 50)])
def test_route_matches_reference(E, top_k, T):
    m, p, jm, jp, x = _setup(E=E, top_k=top_k, T=T)
    w, idx, aux = moe.route(p["router"], _t(x), top_k)
    jw, jidx, jaux = jmoe.route(jp["router"], jnp.asarray(x), top_k)
    assert torch.equal(idx, _t(jidx).long())
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **ROUTER_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **ROUTER_TOL)
    # the reference's router invariants
    assert w.shape == (T, top_k) and idx.shape == (T, top_k)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert bool((idx >= 0).all()) and bool((idx < E).all())
    assert all(len(set(row)) == top_k for row in idx.tolist())
    assert bool((w[:, :-1] >= w[:, 1:]).all())       # descending, as top_k
    assert float(aux) >= 1.0 - 1e-5


@pytest.mark.parametrize("mode", ["oracle", "dropless", "capacity_1",
                                  "capacity_factor"])
def test_ffn_paths_match_reference(mode):
    """The oracle and the routed path, dropless and with drops: capacity 1
    (the reference's ``test_capacity_drops_tokens``) and the default
    capacity factor 1.25."""
    cf = 1.25 if mode == "capacity_factor" else 0.0
    m, p, jm, jp, x = _setup(cf=cf, T=64)
    if mode == "oracle":
        y, aux = moe.moe_dense_oracle(p, _t(x), m)
        jy, jaux = jmoe.moe_dense_oracle(jp, jnp.asarray(x), jm)
    else:
        cap = 1 if mode == "capacity_1" else None
        y, aux = moe.moe_routed(p, _t(x), m, capacity=cap)
        jy, jaux = jmoe.moe_routed(jp, jnp.asarray(x), jm, capacity=cap)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **FFN_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **ROUTER_TOL)
    if mode == "capacity_1":
        full, _ = jmoe.moe_routed(jp, jnp.asarray(x), jm, capacity=64 * 2)
        assert not np.allclose(np.asarray(full), y.numpy())
        assert bool(torch.isfinite(y).all())


def _dropped(idx: np.ndarray, E: int, cap: int, groups: int = 1) -> int:
    """Assignments past ``cap`` per (group, expert): what the slot ranks
    drop."""
    counts = [np.bincount(g.reshape(-1), minlength=E)
              for g in idx.reshape(groups, -1)]
    return int(np.maximum(np.stack(counts) - cap, 0).sum())


@contextlib.contextmanager
def counted_drops():
    """Within the block, every routed dispatch appends the number of
    (token, expert) assignments its capacity dropped to the yielded list,
    read from its expert indices, capacity and groups."""
    seen: list = []
    orig = moe._dispatch_compute_combine

    def spy(x, w, idx, params, m, e_start, e_local, capacity, groups=1):
        seen.append(_dropped(idx.cpu().numpy(), e_local, capacity, groups))
        return orig(x, w, idx, params, m, e_start, e_local, capacity, groups)
    with mock.patch.object(moe, "_dispatch_compute_combine", spy):
        yield seen


@pytest.mark.parametrize("cap", [1, 3, 8, 80])
def test_capacity_keeps_each_experts_first_assignments(cap):
    """At capacity ``cap`` the routed path sums, for each token, the dense
    experts of the assignments that rank below ``cap`` at their expert in
    flat (token, k) order; the rest add nothing, and ``counted_drops``
    counts them."""
    m, p, _, _, x = _setup(T=40)
    xt = _t(x)
    w, idx, _ = moe.route(p["router"], xt, m.top_k)
    h = torch.nn.functional.silu(torch.einsum("td,edf->tef", xt, p["w_gate"])
                                 ) * torch.einsum("td,edf->tef", xt, p["w_up"])
    y_all = torch.einsum("tef,efd->ted", h, p["w_down"]).numpy()
    want = np.zeros_like(x)
    seen, dropped = np.zeros(m.num_experts, int), 0
    for t, (row_e, row_w) in enumerate(zip(idx.tolist(), w.tolist())):
        for e, wt in zip(row_e, row_w):
            if seen[e] < cap:
                want[t] += wt * y_all[t, e]
            else:
                dropped += 1
            seen[e] += 1
    with counted_drops() as drops:
        y, _ = moe.moe_routed(p, xt, m, capacity=cap)
    np.testing.assert_allclose(y.numpy(), want, **FFN_TOL)
    assert drops == [dropped] and (dropped > 0) == (cap < 40)


@pytest.mark.parametrize("groups,cf", [(4, 1.25), (10, 1.25), (5, 0.0),
                                       (40, 1.25)])
def test_groups_route_like_the_reference_under_vmap(groups, cf):
    """``groups`` G routes G consecutive groups alone, each with its own
    capacity: the reference's server routes each lane so, by vmapping a
    batch-1 call over the lanes."""
    m, p, jm, jp, x = _setup(T=40, cf=cf)
    y, _ = moe.moe_routed(p, _t(x), m, groups=groups)
    jy = jax.vmap(lambda xg: jmoe.moe_routed(jp, xg, jm)[0])(
        jnp.asarray(x).reshape(groups, 40 // groups, 32))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy).reshape(40, 32),
                               **FFN_TOL)
    with pytest.raises(ValueError, match="groups"):
        moe.moe_routed(p, _t(x), m, groups=7)


@pytest.mark.parametrize("oracle", [True, False])
@pytest.mark.parametrize("shared,dense", [(0, False), (2, False), (0, True),
                                          (1, True)])
def test_moe_ffn_matches_reference(oracle, shared, dense):
    """Shared experts (fused into one SwiGLU of width n_shared·d_ff) and
    Arctic's dense residual beside the routed experts."""
    m, p, jm, jp, x = _setup(shared=shared, cf=1.25, T=48)
    jdense = (jlayers.init_mlp(jax.random.PRNGKey(7), 32, 24, "swiglu",
                               jnp.float32) if dense else None)
    dp = params_from_numpy(_np(jdense), "cpu") if dense else None
    xb = x.reshape(2, 24, 32)
    y, aux = moe.moe_ffn(p, _t(xb), m, dense_params=dp, oracle=oracle)
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(xb), jm, dense_params=jdense,
                            oracle=oracle)
    assert tuple(y.shape) == xb.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **FFN_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **ROUTER_TOL)
    if shared or dense:   # the extra FFNs contribute
        bare, _ = moe.moe_ffn({k: v for k, v in p.items() if k != "shared"},
                              _t(xb), m, oracle=oracle)
        assert not torch.allclose(bare, y)


def test_expert_parallelism_raises():
    m, p, _, _, x = _setup()
    with pytest.raises(NotImplementedError, match="A.10"):
        moe.moe_routed(p, _t(x), m, ep_axis="model")
    with pytest.raises(NotImplementedError, match="A.10"):
        ParallelCtx(ep=True)


# ---------------------------------------------------------------------------
# the moe family's Model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def ref_model(request):
    """(arch, {oracle: jax model}, jax params, the port's params)."""
    arch = request.param
    jms = {o: jbuild(jconfigs.get(arch).reduced(), JCtx(moe_oracle=o))
           for o in (True, False)}
    jp = jms[True].init(jax.random.PRNGKey(0))
    return arch, jms, jp, params_from_numpy(_np(jp), "cpu")


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape), str(tree.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch,reduced", [("deepseek-moe-16b", True),
                                          ("deepseek-moe-16b", False),
                                          ("arctic-480b", True)])
def test_init_tree_matches_reference(arch, reduced):
    """The tree of shapes and dtypes against ``jax.eval_shape`` of the
    reference's init; the full config's is drawn under FakeTensorMode (no
    storage), its experts (L, E, d, f)."""
    jcfg, cfg = jconfigs.get(arch), configs.get(arch)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    want = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    with FakeTensorMode():
        mine = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert _shapes(mine) == _shapes(want)
    E, f = cfg.moe.num_experts, cfg.moe.expert_d_ff
    assert tuple(mine["blocks"]["moe"]["w_gate"].shape) == (
        cfg.num_layers, E, cfg.d_model, f)


@pytest.mark.parametrize("oracle", [True, False])
@pytest.mark.parametrize("impl", ["kernel", "chunked"])
def test_prefill_and_decode_match_reference(ref_model, oracle, impl):
    arch, jms, jp, tp = ref_model
    jm = jms[oracle]
    model = Model(configs.get(arch).reduced(),
                  ParallelCtx(attn_impl=impl, moe_oracle=oracle),
                  device="cpu")
    toks = np.random.default_rng(5).integers(0, 256, (2, 24))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                        max_len=32)
    tl, tc = model.prefill(tp, {"tokens": torch.from_numpy(toks)}, max_len=32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    for name in ("k", "v", "len", "pos"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=ATOL, rtol=0, err_msg=name)
    cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int64)[:, None]
    pos = np.array([24, 24], np.int64)
    for _ in range(3):
        jl, jc = jm.decode_step(jp, {"tokens": jnp.asarray(cur, jnp.int32),
                                     "pos": jnp.asarray(pos, jnp.int32)}, jc)
        tl, tc = model.decode_step(tp, {"tokens": torch.from_numpy(cur),
                                        "pos": torch.from_numpy(pos)}, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int64)[:, None]
        pos = pos + 1


def _batch(seed=6, B=2, S=20):
    toks = np.random.default_rng(seed).integers(0, 256, (B, S + 1))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("oracle", [True, False])
def test_loss_matches_reference(ref_model, oracle):
    """ce, the summed router aux over the layers, and ce + coef · aux."""
    arch, jms, jp, tp = ref_model
    model = Model(configs.get(arch).reduced(), ParallelCtx(moe_oracle=oracle),
                  device="cpu")
    b = _batch()
    total, met = model.loss(tp, {k: torch.from_numpy(v) for k, v in b.items()})
    jtotal, jmet = jms[oracle].loss(jp, {k: jnp.asarray(v, jnp.int32)
                                         for k, v in b.items()})
    for name in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(met[name]), float(jmet[name]),
                                   atol=ATOL, rtol=0, err_msg=name)
    assert float(met["aux"]) > 1.0      # two layers, each aux >= 1
    coef = configs.get(arch).moe.router_aux_coef
    assert torch.equal(total, met["ce"] + coef * met["aux"])


@pytest.mark.parametrize("oracle", [True, False])
def test_loss_gradient_matches_reference(ref_model, oracle):
    """``torch.func.grad`` of the loss at remat=False against ``jax.grad``:
    the router's gradient comes from the combine weights and the aux."""
    arch, jms, jp, tp = ref_model
    model = Model(configs.get(arch).reduced(), ParallelCtx(moe_oracle=oracle),
                  device="cpu")
    b = _batch()
    g = torch.func.grad(lambda p: model.loss(
        p, {k: torch.from_numpy(v) for k, v in b.items()})[0])(tp)
    jg = _np(jax.grad(lambda p: jms[oracle].loss(
        p, {k: jnp.asarray(v, jnp.int32) for k, v in b.items()})[0])(jp))

    def check(mine, want, path=""):
        if isinstance(want, dict):
            assert sorted(mine) == sorted(want)
            for k in want:
                check(mine[k], want[k], f"{path}/{k}")
            return
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(mine.numpy() - want).max())
        assert err <= GRAD_REL * scale, (path, err, scale)
    check(g, jg)
    assert float(g["blocks"]["moe"]["router"].abs().sum()) > 0


def test_remat_with_grad_raises_and_serving_does_not():
    """Until the moe training path (ROADMAP A.12), remat under grad raises;
    with remat set, no-grad paths still run."""
    cfg = dataclasses.replace(configs.get("deepseek-moe-16b").reduced(),
                              remat=True)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    b = {k: torch.from_numpy(v) for k, v in _batch().items()}
    with pytest.raises(NotImplementedError, match="A.12"):
        torch.func.grad(lambda p: model.loss(p, b)[0])(params)
    params["embed"].requires_grad_()
    with pytest.raises(NotImplementedError, match="A.12"):
        model.loss(params, b)
    params["embed"].requires_grad_(False)
    with torch.no_grad():
        logits, _ = model.prefill(params, {"tokens": b["tokens"]}, 32)
    assert bool(torch.isfinite(logits).all())


def test_decode_routes_rows_alone_only_when_asked(ref_model):
    """``decode_step`` routes its batch jointly, as the reference's does;
    ``route_rows=True`` gives each row the result of its own batch-1 step.
    With the capacity at its floor of 8, 16 joint tokens overflow an
    expert."""
    arch, _, _, tp = ref_model
    cfg = configs.get(arch).reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.01))
    model = Model(cfg, device="cpu")
    rng = np.random.default_rng(8)
    B = 16
    toks = torch.from_numpy(rng.integers(0, 256, (B, 10)))
    _, cache = model.prefill(tp, {"tokens": toks}, max_len=16)
    step = {"tokens": torch.from_numpy(rng.integers(0, 256, (B, 1))),
            "pos": torch.full((B,), 10)}
    fresh = lambda: {k: v.clone() for k, v in cache.items()}
    with counted_drops() as drops:
        joint, _ = model.decode_step(tp, step, fresh())
    assert len(drops) == cfg.num_layers and sum(drops) > 0
    with counted_drops() as drops:
        rows, _ = model.decode_step(tp, step, fresh(), route_rows=True)
    assert len(drops) == cfg.num_layers and sum(drops) == 0
    for i in range(B):
        one = {k: v[:, i:i + 1].clone() for k, v in cache.items()}
        alone, _ = model.decode_step(
            tp, {k: v[i:i + 1] for k, v in step.items()}, one)
        np.testing.assert_allclose(rows[i:i + 1].numpy(), alone.numpy(),
                                   atol=1e-5, rtol=0)
    assert not torch.allclose(joint, rows, atol=1e-3)
