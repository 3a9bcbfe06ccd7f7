"""The port's hybrid family (zamba2: Mamba2 superblocks, each followed by
the one SHARED attention+MLP block, then a Mamba2 tail) against the JAX
reference, f32 on the CPU from the reference's own parameters: the layout,
the init tree (full zamba2-7b and reduced), the nested cache and its lane
axes, and prefill, decode and loss on the reduced config (period 2, no
tail) and on a variant with num_layers=5 (two superblocks and a tail).

Both sequence-mixer routes run: impl="kernel" (``ops`` on a CPU tensor:
the plain versions of B3 and B4) and "chunked" (the reference's own
paths). Tolerance: 1e-4 on logits, caches and losses, as
``tests/test_torch_ssm.py`` (f32 end to end, sums in other orders)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro.models import ParallelCtx as JCtx, build_model as jbuild
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.core import packing
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model
from repro_torch.models.transformer import ParallelCtx

ARCH = "zamba2-7b"
ATOL = 1e-4
VARIANTS = ["reduced", "tail"]


def _cfg(pkg, variant: str):
    cfg = pkg.get(ARCH)
    if variant == "full":
        return cfg
    cfg = cfg.reduced()
    if variant == "tail":
        cfg = dataclasses.replace(cfg, num_layers=5)
    return cfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape), str(tree.dtype).replace("torch.", "")


@pytest.mark.parametrize("variant,want", [("full", (13, 6, 3)),
                                          ("reduced", (1, 2, 0)),
                                          ("tail", (2, 2, 1))])
def test_hybrid_layout(variant, want):
    assert transformer.hybrid_layout(_cfg(configs, variant)) == want
    assert jtransformer.hybrid_layout(_cfg(jconfigs, variant)) == want


@pytest.mark.parametrize("variant", ["full"] + VARIANTS)
def test_init_tree_matches_reference(variant):
    """Against ``jax.eval_shape`` of the reference's init: the Mamba2 blocks
    stacked (n_super, period, ...), the shared block unstacked, the tail
    (n_tail, ...). The full config is drawn under FakeTensorMode."""
    want = jax.eval_shape(jbuild(_cfg(jconfigs, variant)).init,
                          jax.random.PRNGKey(0))
    with FakeTensorMode():
        mine = Model(_cfg(configs, variant), device="cpu").init(
            torch.Generator().manual_seed(0))
    assert _shapes(mine) == _shapes(want)
    if variant == "full":
        n = sum(t.numel() for t in packing.tree_leaves(mine))
        assert round(n / 1e9, 3) == 6.751          # 27.0 GB in f32


@pytest.fixture(scope="module", params=VARIANTS)
def ref_model(request):
    variant = request.param
    jm = jbuild(_cfg(jconfigs, variant), JCtx(moe_oracle=True))
    jp = jm.init(jax.random.PRNGKey(0))
    return variant, jm, jp, params_from_numpy(_np(jp), "cpu")


def test_cache_tree_and_lane_axes(ref_model):
    """``make_cache`` keeps the reference's nested layout; each leaf's lane
    axis (``cache_lane_axes``) is where its batch sits: 2 under "ssm"."""
    variant, jm, _, _ = ref_model
    model = Model(_cfg(configs, variant), device="cpu")
    cache = model.make_cache(3, 40)
    assert _shapes(cache) == _shapes(jm.make_cache(3, 40))
    axes = model.cache_lane_axes()
    assert packing.tree_map(lambda t, a: t.shape[a], cache, axes) == \
        packing.tree_map(lambda t: 3, cache)
    assert axes["ssm"] == {"conv": 2, "ssm": 2}
    assert ("tail" in axes) == (variant == "tail")
    lane = packing.tree_get_lane(cache, 1, axes)
    assert lane["ssm"]["ssm"].shape[:2] == cache["ssm"]["ssm"].shape[:2]


@pytest.mark.parametrize("impl", ["kernel", "chunked"])
def test_prefill_and_decode_match_reference(ref_model, impl):
    variant, jm, jp, tp = ref_model
    model = Model(_cfg(configs, variant), ParallelCtx(attn_impl=impl),
                  device="cpu")
    toks = np.random.default_rng(3).integers(0, 256, (2, 64))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                        max_len=72)
    tl, tc = model.prefill(tp, {"tokens": torch.from_numpy(toks)}, max_len=72)

    def close(mine, want):
        np.testing.assert_allclose(mine.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=ATOL)

    close(tl, jl)
    packing.tree_map(close, tc, jc)
    cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int64)[:, None]
    pos = np.array([64, 64], np.int64)
    for _ in range(4):
        jl, jc = jm.decode_step(jp, {"tokens": jnp.asarray(cur, jnp.int32),
                                     "pos": jnp.asarray(pos, jnp.int32)}, jc)
        tl, tc = model.decode_step(tp, {"tokens": torch.from_numpy(cur),
                                        "pos": torch.from_numpy(pos)}, tc)
        close(tl, jl)
        cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int64)[:, None]
        pos = pos + 1
    packing.tree_map(close, tc, jc)


@pytest.mark.parametrize("impl", ["kernel", "chunked"])
def test_loss_matches_reference(ref_model, impl):
    variant, jm, jp, tp = ref_model
    model = Model(_cfg(configs, variant), ParallelCtx(attn_impl=impl),
                  device="cpu")
    toks = np.random.default_rng(4).integers(0, 256, (2, 65))
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with torch.no_grad():
        _, met = model.loss(tp, {k: torch.from_numpy(v) for k, v in b.items()})
    _, jmet = jm.loss(jp, {k: jnp.asarray(v, jnp.int32) for k, v in b.items()})
    for name in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(met[name]), float(jmet[name]),
                                   atol=ATOL, rtol=0, err_msg=name)
    assert float(met["aux"]) == 0.0


def test_remat_with_grad_raises():
    """Remat under grad no longer raises (the hybrid training path, ROADMAP
    A.12): the gradient with remat on (each superblock under one recompute
    Function, the tail block by block) is bit-equal to remat off, and the
    shared block's gradient, summed over its applications, is nonzero."""
    cfg = _cfg(configs, "tail")
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (1, 33)))
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    got = {}
    for remat in (True, False):
        model = Model(dataclasses.replace(cfg, remat=remat), device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        got[remat] = torch.func.grad(lambda p: model.loss(p, b)[0])(params)
    assert all(torch.equal(x, y) for x, y in zip(
        packing.tree_leaves(got[True]), packing.tree_leaves(got[False])))
    assert float(got[True]["hybrid"]["shared"]["attn"]["w_q"].abs().sum()) > 0
    assert float(got[True]["hybrid"]["tail"]["mamba"]["w_in"].abs().sum()
                 ) > 0


# ---------------------------------------------------------------------------
# training: the gradient against jax.grad (C12), remat, vmap(grad), sweeps
# ---------------------------------------------------------------------------

GRAD_REL = 1e-4    # each leaf within 1e-4 of its largest entry (sums over
                   # every token in other orders), as tests/test_torch_moe.py


def _grad_batch(seed=4, S=64):
    toks = np.random.default_rng(seed).integers(0, 256, (2, S + 1))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _check_grads(mine, want, path=""):
    if isinstance(want, dict):
        assert sorted(mine) == sorted(want)
        for k in want:
            _check_grads(mine[k], want[k], f"{path}/{k}")
        return
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(mine.numpy() - want).max())
    assert err <= GRAD_REL * scale, (path, err, scale)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_gradient_matches_reference(ref_model, remat):
    """``torch.func.grad`` of the loss against ``jax.grad`` of the
    reference, both with remat off and both with it on (the reference's
    ``jax.checkpoint`` per superblock and per tail block)."""
    variant, _, jp, tp = ref_model
    jcfg = dataclasses.replace(_cfg(jconfigs, variant), remat=remat)
    jm = jbuild(jcfg, JCtx(moe_oracle=True))
    model = Model(dataclasses.replace(_cfg(configs, variant), remat=remat),
                  device="cpu")
    b = _grad_batch()
    g = torch.func.grad(lambda p: model.loss(
        p, {k: torch.from_numpy(v) for k, v in b.items()})[0])(tp)
    jg = _np(jax.grad(lambda p: jm.loss(
        p, {k: jnp.asarray(v, jnp.int32) for k, v in b.items()})[0])(jp))
    _check_grads(g, jg)


def _lanes(model, n=3, S=32):
    params = packing.stack_trees([model.init(torch.Generator().manual_seed(s))
                                  for s in range(n)])
    batch = packing.stack_trees([{k: torch.from_numpy(v) for k, v in
                                  _grad_batch(seed=s, S=S).items()}
                                 for s in range(n)])
    return params, batch


@pytest.mark.parametrize("variant", VARIANTS)
def test_remat_is_bit_equal_under_vmap_grad(variant, monkeypatch):
    """Three lanes' gradients and losses under ``vmap(grad)`` are bit-equal
    with remat on and off. With remat the forward applies the recompute
    Function once a superblock and once a tail block, and each
    superblock's recompute applies it again to each of its Mamba2 blocks
    (the reference's nested ``jax.checkpoint``)."""
    calls = []
    real = transformer._Recompute.apply
    monkeypatch.setattr(transformer._Recompute, "apply",
                        lambda *a: calls.append(1) or real(*a))
    cfg = _cfg(configs, variant)
    n_super, period, n_tail = transformer.hybrid_layout(cfg)
    out = {}
    for remat in (False, True):
        model = Model(dataclasses.replace(cfg, remat=remat), device="cpu")
        out[remat] = torch.func.vmap(torch.func.grad_and_value(
            model.loss, has_aux=True))(*_lanes(model))
        assert len(calls) == (n_super * (1 + period) + n_tail if remat
                              else 0)
    (g0, (l0, _)), (g1, (l1, _)) = out[False], out[True]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(packing.tree_leaves(g0),
                                                  packing.tree_leaves(g1)))


def test_remat_mamba_takes_chunked_and_attention_keeps_its_path(monkeypatch):
    """With no impl given and the card's default (the kernels) in force,
    a remat ``vmap(grad)`` step runs every Mamba2 block on the chunked scan
    in both passes of the superblock's Function, while the shared
    attention keeps ``ops.flash_attention`` (B3 on the card; its plain
    version here), twice a superblock: the forward and the recompute."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention, ssm
    monkeypatch.setattr(attention, "default_impl", lambda device: "kernel")
    monkeypatch.setattr(ssm, "default_impl", lambda device: "kernel")
    scans, flash = [], []
    real_scan, real_fa = ssm._scan, fa.flash_attention_plain
    monkeypatch.setattr(ssm, "_scan",
                        lambda impl, *a: scans.append(impl) or real_scan(
                            impl, *a))
    monkeypatch.setattr(fa, "flash_attention_plain",
                        lambda *a, **k: flash.append(1) or real_fa(*a, **k))
    cfg = dataclasses.replace(_cfg(configs, "tail"), remat=True)
    n_super, period, n_tail = transformer.hybrid_layout(cfg)
    model = Model(cfg, device="cpu")
    torch.func.vmap(torch.func.grad(lambda p, b: model.loss(p, b)[0]))(
        *_lanes(model, n=2))
    assert scans and set(scans) == {"chunked"}
    assert len(flash) == 2 * n_super


@pytest.mark.parametrize("variant", VARIANTS)
def test_two_lane_sweep_matches_each_task_alone(variant):
    """``run_sweep`` with remat on: two lanes, one refill, every task's
    losses against the task run alone (f32 parity bound)."""
    from test_torch_moe import SWEEP_BUDGETS, sweep_vs_alone
    cfg = dataclasses.replace(_cfg(configs, variant), remat=True)
    packed, alone, res = sweep_vs_alone(cfg)
    assert res.pack_factor == 2 and res.refills == 3
    assert res.lane_steps == sum(SWEEP_BUDGETS)
    for i, want in alone.items():
        assert len(packed[i]) == SWEEP_BUDGETS[i]
        np.testing.assert_allclose(packed[i], want, rtol=2e-5, atol=2e-5)
