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
from repro_torch.core import packing
from repro_torch.models import moe, transformer
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


def test_expert_parallelism_at_world_one_equals_routed(tmp_path):
    """Expert parallelism over a gloo group of one rank in this process:
    ``moe_routed(ep_axis=...)`` and a moe block's ``ParallelCtx(ep=True)``
    on a (1, 1) mesh (the experts under ``local_map``) equal the routed
    path bit for bit, with drops (every sum is over one rank)."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import (dim_placements,
                                                  local_shard)
    from repro_torch.launch.mesh import make_mesh
    m, p, _, _, x = _setup(cf=1.0, T=64)
    want, want_aux = moe.moe_routed(p, _t(x), m)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        y, aux = moe.moe_routed(p, _t(x), m, ep_axis=dist.group.WORLD)
        assert torch.equal(y, want) and torch.equal(aux, want_aux)
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        pd = {k: local_shard(v, mesh, dim_placements(mesh)) for k, v
              in p.items()}
        xd = local_shard(_t(x), mesh, dim_placements(mesh, data=0))
        cfg = dataclasses.replace(configs.get("deepseek-moe-16b"), moe=m)
        y, aux = transformer._ep_moe_call(
            pd, xd, cfg, ParallelCtx(mesh=mesh, ep=True))
        assert torch.equal(y.full_tensor(), want)
        assert torch.equal(aux.full_tensor(), want_aux)
    finally:
        dist.destroy_process_group()


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
    """Remat under grad no longer raises (the moe training path, ROADMAP
    A.12): the gradient with remat on is bit-equal to remat off, also when
    the loss runs under plain autograd; with remat set, no-grad paths run
    without entering the recompute Function."""
    cfg = configs.get("deepseek-moe-16b").reduced()
    b = {k: torch.from_numpy(v) for k, v in _batch().items()}
    grads, losses = {}, {}
    for remat in (True, False):
        model = Model(dataclasses.replace(cfg, remat=remat), device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        grads[remat] = torch.func.grad(lambda p: model.loss(p, b)[0])(params)
        params["embed"].requires_grad_()
        losses[remat] = model.loss(params, b)[0]
        losses[remat].backward()
        params["embed"].requires_grad_(False)
        losses[remat] = (losses[remat].detach(), params["embed"].grad)
    assert all(torch.equal(x, y) for x, y in zip(
        packing.tree_leaves(grads[True]), packing.tree_leaves(grads[False])))
    assert all(torch.equal(x, y) for x, y in zip(losses[True], losses[False]))
    assert float(grads[True]["blocks"]["moe"]["router"].abs().sum()) > 0
    model = Model(dataclasses.replace(cfg, remat=True), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with mock.patch.object(transformer._Recompute, "apply",
                           lambda *a: pytest.fail("remat without grad")):
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


# ---------------------------------------------------------------------------
# under torch.func.vmap and vmap(grad) (C13), and training under remat
# ---------------------------------------------------------------------------

LANES = 3


def _lane_inputs(x):
    """Three lanes of tokens: x, x reversed and x halved."""
    return np.stack([x, x[::-1].copy(), x * 0.5])


def _lane_params(tree, lib):
    """Three lanes of params: the tree scaled by 1, 1.1 and 0.9."""
    if lib == "jax":
        return jax.tree_util.tree_map(
            lambda v: jnp.stack([v, v * 1.1, v * 0.9]), tree)
    return packing.tree_map(lambda v: torch.stack([v, v * 1.1, v * 0.9]),
                            tree)


def _routed(lib, p, x, m, cap, groups):
    """``moe_routed`` of one lane; the reference routes each group alone by
    its own vmap over the groups (as its server does)."""
    if lib == "torch":
        return moe.moe_routed(p, x, m, capacity=cap, groups=groups)
    T, d = x.shape
    y, aux = jax.vmap(lambda xg: jmoe.moe_routed(p, xg, m, capacity=cap))(
        x.reshape(groups, T // groups, d))
    # the port's aux is over all T tokens: with groups it equals the
    # reference's aux of the whole call, computed apart
    return y.reshape(T, d), jmoe.route(p["router"], x, m.top_k)[2]


CAPS = {"dropless": (0.0, None), "capacity_8": (1.25, 8)}


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("cap", sorted(CAPS))
def test_routed_under_vmap_matches_reference(cap, groups):
    """``torch.func.vmap`` of ``moe_routed`` over three lanes of tokens,
    dropless and at capacity 8 (each group's 80 assignments on 8 experts
    overflow), against ``jax.vmap`` of the reference; the capacity drops
    change the result."""
    cf, c = CAPS[cap]
    m, p, jm, jp, x = _setup(T=40 * groups, cf=cf)
    xs = _lane_inputs(x)
    y, aux = torch.func.vmap(lambda xx: _routed("torch", p, xx, m, c,
                                                groups))(_t(xs))
    jy, jaux = jax.vmap(lambda xx: _routed("jax", jp, xx, jm, c, groups))(
        jnp.asarray(xs))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **FFN_TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), **ROUTER_TOL)
    for i in range(LANES):      # each lane as the call alone gives it
        alone, _ = _routed("torch", p, _t(xs[i]), m, c, groups)
        np.testing.assert_allclose(y[i].numpy(), alone.numpy(), **FFN_TOL)
    if c is not None:
        full, _ = torch.func.vmap(lambda xx: moe.moe_routed(
            p, xx, m, capacity=40, groups=groups))(_t(xs))
        assert not torch.allclose(full, y)


def _check_grads(mine, want, path=""):
    """Each leaf within GRAD_REL of its largest entry."""
    if isinstance(want, dict):
        assert sorted(mine) == sorted(want)
        for k in want:
            _check_grads(mine[k], want[k], f"{path}/{k}")
        return
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(mine.detach().numpy() - want).max())
    assert err <= GRAD_REL * scale, (path, err, scale)


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("cap", sorted(CAPS))
def test_routed_vmap_grad_matches_reference(cap, groups):
    """``vmap(grad)`` over three lanes of params and tokens, the loss the
    output against a fixed cotangent plus the aux, against
    ``jax.vmap(jax.grad)`` of the reference: the router's gradient comes
    through the combine weights and the aux."""
    cf, c = CAPS[cap]
    m, p, jm, jp, x = _setup(T=40 * groups, cf=cf)
    xs = _lane_inputs(x)
    r = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def loss(lib, pp, xx, rr):
        y, aux = _routed(lib, pp, xx, m if lib == "torch" else jm, c, groups)
        return (y * rr).sum() + aux
    g = torch.func.vmap(torch.func.grad(
        lambda pp, xx: loss("torch", pp, xx, _t(r))))(_lane_params(p, "torch"),
                                                       _t(xs))
    jg = jax.vmap(jax.grad(lambda pp, xx: loss("jax", pp, xx, jnp.asarray(
        r))))(_lane_params(jp, "jax"), jnp.asarray(xs))
    _check_grads(g, jg)
    assert float(g["router"].abs().sum()) > 0


@pytest.mark.parametrize("oracle", [True, False])
@pytest.mark.parametrize("shared,dense", [(2, False), (1, True)])
def test_moe_ffn_under_vmap_and_vmap_grad_matches_reference(oracle, shared,
                                                            dense):
    """``moe_ffn`` (shared experts, Arctic's dense residual) over three
    lanes under ``vmap`` and ``vmap(grad)``, against the reference under
    ``jax.vmap``."""
    m, p, jm, jp, x = _setup(shared=shared, cf=1.25, T=48)
    jdense = (jlayers.init_mlp(jax.random.PRNGKey(7), 32, 24, "swiglu",
                               jnp.float32) if dense else None)
    dp = params_from_numpy(_np(jdense), "cpu") if dense else None
    xs = _lane_inputs(x).reshape(LANES, 2, 24, 32)
    y, aux = torch.func.vmap(lambda xx: moe.moe_ffn(
        p, xx, m, dense_params=dp, oracle=oracle))(_t(xs))
    jy, jaux = jax.vmap(lambda xx: jmoe.moe_ffn(
        jp, xx, jm, dense_params=jdense, oracle=oracle))(jnp.asarray(xs))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **FFN_TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), **ROUTER_TOL)

    def loss(fn, pp, xx):
        y, aux = fn(pp, xx)
        return (y ** 2).mean() + aux
    tfn = lambda pp, xx: moe.moe_ffn(pp["moe"], xx, m,
                                     dense_params=pp.get("dense"),
                                     oracle=oracle)
    jfn = lambda pp, xx: jmoe.moe_ffn(pp["moe"], xx, jm,
                                      dense_params=pp.get("dense"),
                                      oracle=oracle)
    tp = {"moe": p, **({"dense": dp} if dense else {})}
    jtp = {"moe": jp, **({"dense": jdense} if dense else {})}
    g = torch.func.vmap(torch.func.grad(lambda pp, xx: loss(tfn, pp, xx)))(
        _lane_params(tp, "torch"), _t(xs))
    jg = jax.vmap(jax.grad(lambda pp, xx: loss(jfn, pp, xx)))(
        _lane_params(jtp, "jax"), jnp.asarray(xs))
    _check_grads(g, jg)


def _remat_cfg(pkg, arch, remat=True):
    return dataclasses.replace(pkg.get(arch).reduced(), remat=remat)


@pytest.mark.parametrize("oracle", [True, False])
def test_loss_gradient_with_remat_matches_reference(ref_model, oracle):
    """``torch.func.grad`` of the loss with remat on (each block under the
    recompute Function, its router loss the second output) against
    ``jax.grad`` of the reference with remat on (``jax.checkpoint``)."""
    arch, _, jp, tp = ref_model
    jm = jbuild(_remat_cfg(jconfigs, arch), JCtx(moe_oracle=oracle))
    model = Model(_remat_cfg(configs, arch), ParallelCtx(moe_oracle=oracle),
                  device="cpu")
    b = _batch()
    g = torch.func.grad(lambda p: model.loss(
        p, {k: torch.from_numpy(v) for k, v in b.items()})[0])(tp)
    jg = _np(jax.grad(lambda p: jm.loss(
        p, {k: jnp.asarray(v, jnp.int32) for k, v in b.items()})[0])(jp))
    _check_grads(g, jg)
    assert float(g["blocks"]["moe"]["router"].abs().sum()) > 0


def _lm_lanes(model, n=3, seq=20):
    params = packing.stack_trees([model.init(torch.Generator().manual_seed(s))
                                  for s in range(n)])
    batch = packing.stack_trees([{k: torch.from_numpy(v) for k, v in
                                  _batch(seed=s, S=seq).items()}
                                 for s in range(n)])
    return params, batch


@pytest.mark.parametrize("oracle", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_equal_under_vmap_grad(arch, oracle, monkeypatch):
    """Three lanes' gradients, losses and aux under ``vmap(grad)`` are
    bit-equal with remat on and off; the remat run goes through the
    recompute Function once a layer, and its aux is nonzero."""
    calls = []
    real = transformer._Recompute.apply
    monkeypatch.setattr(transformer._Recompute, "apply",
                        lambda *a: calls.append(1) or real(*a))
    out = {}
    for remat in (False, True):
        model = Model(_remat_cfg(configs, arch, remat),
                      ParallelCtx(moe_oracle=oracle), device="cpu")
        params, batch = _lm_lanes(model)
        out[remat] = torch.func.vmap(torch.func.grad_and_value(
            model.loss, has_aux=True))(params, batch)
        assert len(calls) == (model.cfg.num_layers if remat else 0)
    (g0, (l0, m0)), (g1, (l1, m1)) = out[False], out[True]
    assert torch.equal(l0, l1) and torch.equal(m0["aux"], m1["aux"])
    assert bool((m1["aux"] > 1.0).all())
    assert all(torch.equal(a, b) for a, b in zip(packing.tree_leaves(g0),
                                                  packing.tree_leaves(g1)))
    assert bool((g1["blocks"]["moe"]["router"].abs().sum((1, 2, 3)) > 0).all())


def test_pool_step_with_kernel_impl_reaches_the_plain_kernel():
    """A masked ``LanePool`` step of the reduced deepseek-moe-16b (remat on,
    routed, AdamW) with impl="kernel": each layer's attention goes through
    ``ops.flash_attention`` (its plain version on the CPU) twice a pool
    step, the forward and remat's recompute, and the pool's params after
    the step agree with the same step through the reference's chunked
    attention within the f32 bound."""
    from repro_torch import optim
    from repro_torch.core.lanepool import LanePool
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.train import make_train_step
    cfg = _remat_cfg(configs, "deepseek-moe-16b")
    got = {}
    for impl in ("kernel", "chunked"):
        model = Model(cfg, ParallelCtx(attn_impl=impl), device="cpu")
        opt = optim.adamw()
        tmpl = model.init(torch.Generator().manual_seed(0))
        pool = LanePool(3, make_train_step(model, opt), template_params=tmpl,
                        template_opt=opt.init(tmpl),
                        template_hparams=torch.tensor(0.0))
        for lane in (0, 2):                       # lane 1 stays free
            p = model.init(torch.Generator().manual_seed(lane))
            pool.attach(lane, lane, p, opt.init(p), torch.tensor(1e-3))
        _, batch = _lm_lanes(model)
        calls = []
        with mock.patch.object(fa, "flash_attention_plain",
                               lambda *a, real=fa.flash_attention_plain, **k:
                               calls.append(1) or real(*a, **k)):
            metrics = pool.step(batch)
        got[impl] = (pool.params, metrics["loss"], len(calls))
    assert got["kernel"][2] == 2 * cfg.num_layers and got["chunked"][2] == 0
    np.testing.assert_allclose(got["kernel"][1].numpy(),
                               got["chunked"][1].numpy(), rtol=2e-5,
                               atol=2e-5)
    for a, b in zip(packing.tree_leaves(got["kernel"][0]),
                    packing.tree_leaves(got["chunked"][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=2e-5)


SWEEP_BUDGETS = (2, 3, 1)


def sweep_vs_alone(cfg, pctx=None, seq=16):
    """A 2-lane ``run_sweep`` of three tasks (budgets 2, 3 and 1, so a lane
    refills) and each task swept alone on one lane: (packed losses, alone
    losses, result)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.sweep import SweepTask, run_sweep
    model = Model(cfg, pctx, device="cpu")
    bf = lambda seed, step: SyntheticLM(cfg.vocab_size, seq, 2,
                                        seed=seed).batch(step)
    tasks = [SweepTask(id=i, lr=lr, seed=i, steps=b) for i, (lr, b) in
             enumerate(zip((1e-3, 3e-3, 2e-3), SWEEP_BUDGETS))]
    res = run_sweep(model, tasks, batch_fn=bf, steps=3, max_pack=2)
    alone = {t.id: run_sweep(model, [t], batch_fn=bf, steps=3,
                             max_pack=1).losses[t.id] for t in tasks}
    return res.losses, alone, res


@pytest.mark.parametrize("oracle", [True, False])
def test_two_lane_sweep_matches_each_task_alone(oracle):
    """``run_sweep`` on the reduced deepseek-moe-16b with remat on: two
    lanes, one refill, every task's losses against the task run alone
    (f32; lanes under one vmap against one lane, sums in other orders:
    the f32 parity bound)."""
    packed, alone, res = sweep_vs_alone(_remat_cfg(configs,
                                                   "deepseek-moe-16b"),
                                        ParallelCtx(moe_oracle=oracle))
    assert res.pack_factor == 2 and res.refills == 3
    assert res.lane_steps == sum(SWEEP_BUDGETS)
    for i, want in alone.items():
        assert len(packed[i]) == SWEEP_BUDGETS[i]
        np.testing.assert_allclose(packed[i], want, rtol=2e-5, atol=2e-5)
