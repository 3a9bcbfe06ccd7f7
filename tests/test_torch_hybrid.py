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
    """Until the hybrid training path (ROADMAP A.12), remat under grad
    raises; at remat=False the gradient runs (its Mamba2 blocks on the
    chunked scan)."""
    cfg = _cfg(configs, "reduced")
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (1, 33)))
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for remat in (True, False):
        model = Model(dataclasses.replace(cfg, remat=remat), device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        grad = torch.func.grad(lambda p: model.loss(p, b)[0])
        if remat:
            with pytest.raises(NotImplementedError, match="A.12"):
                grad(params)
        else:
            g = grad(params)
            assert float(g["hybrid"]["shared"]["attn"]["w_q"].abs().sum()) > 0
