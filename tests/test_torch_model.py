"""The port's dense ``Model`` against the JAX ``Model`` on the reduced
StableLM-2 config in f32, from the reference's own parameters: building
blocks, prefill logits and cache, and decode steps (ring cache included)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import ParallelCtx as JCtx, build_model as jbuild
from repro.models import layers as jlayers
from repro_torch import configs
from repro_torch.models import layers
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model
from repro_torch.models.transformer import ParallelCtx

ARCH = "stablelm-1.6b"
# f32 end to end on both sides; 2 layers of matmuls and softmax summed in
# different orders stay well inside 1e-4 on unit-scale logits
ATOL = 1e-4


@pytest.fixture(scope="module")
def ref_params():
    jm = jbuild(jconfigs.get(ARCH).reduced(), JCtx(moe_oracle=True))
    jp = jm.init(jax.random.PRNGKey(0))
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape), str(tree.dtype).replace("torch.", "")


@pytest.mark.parametrize("name", jconfigs.available())
def test_config_copy_matches_reference(name):
    assert configs.available() == jconfigs.available()
    for mine, ref in ((configs.get(name), jconfigs.get(name)),
                      (configs.get(name).reduced(),
                       jconfigs.get(name).reduced())):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.param_count() == ref.param_count()


def test_init_tree_matches_reference(ref_params):
    _, np_params = ref_params
    model = Model(configs.get(ARCH).reduced(), device="cpu")
    mine = model.init(torch.Generator().manual_seed(0))
    assert _shapes(mine) == _shapes(np_params)


def _f32(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_rms_norm_matches_reference(eps):
    x, w = _f32(0, 3, 5, 64), _f32(1, 64)
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), eps).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), eps)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches_reference(theta):
    x = _f32(2, 2, 7, 3, 16)
    pos = np.random.default_rng(3).integers(0, 3000, (2, 7)).astype(np.int32)
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          theta).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      theta)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
def test_mlp_matches_reference(mlp_type):
    jp = jlayers.init_mlp(jax.random.PRNGKey(4), 32, 48, mlp_type,
                          jnp.float32)
    x = _f32(5, 2, 6, 32)
    np.testing.assert_allclose(
        layers.mlp(params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                     "cpu"), torch.from_numpy(x),
                   mlp_type).numpy(),
        np.asarray(jlayers.mlp(jp, jnp.asarray(x), mlp_type)),
        rtol=1e-5, atol=1e-5)


def _close_tree(mine, ref):
    for name in ("k", "v", "len", "pos"):
        np.testing.assert_allclose(mine[name].numpy(), np.asarray(ref[name]),
                                   atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("impl", ["kernel", "chunked"])
@pytest.mark.parametrize("S,max_len,window", [
    (12, 16, 0),      # prompt inside the cache
    (16, 16, 0),      # exactly full
    (21, 16, 0),      # S > max_len: prefill keeps the last 16, ring decode
    (12, 16, 8),      # sliding window: the cache is an 8-slot ring
])
def test_prefill_and_decode_match_reference(ref_params, impl, S, max_len,
                                            window):
    jp, np_params = ref_params
    cfg = configs.get(ARCH).reduced()
    jm = jbuild(jconfigs.get(ARCH).reduced(),
                JCtx(attn_impl="pallas_interpret"), window=window)
    model = Model(cfg, ParallelCtx(attn_impl=impl), window=window,
                  device="cpu")
    params = params_from_numpy(np_params, "cpu")
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size, (2, S))

    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                        max_len=max_len)
    tl, tc = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                           max_len=max_len)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, 256)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    _close_tree(tc, jc)

    cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int64)[:, None]
    pos = np.array([S, S], np.int64)
    for _ in range(3):
        jl, jc = jm.decode_step(jp, {"tokens": jnp.asarray(cur, jnp.int32),
                                     "pos": jnp.asarray(pos, jnp.int32)}, jc)
        tl, tc = model.decode_step(params, {"tokens": torch.from_numpy(cur),
                                            "pos": torch.from_numpy(pos)}, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        _close_tree(tc, jc)
        cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int64)[:, None]
        pos = pos + 1


def test_score_bf16_matches_reference(ref_params):
    """ParallelCtx(score_bf16=True): the chunked path's PV product in bf16
    on both sides. Both round p and v to bf16 the same way, so the f32
    tolerance holds; the bf16 path itself moves these logits by ~2e-2
    from the f32 path, which this tolerance would catch."""
    jp, np_params = ref_params
    cfg = configs.get(ARCH).reduced()
    jm = jbuild(jconfigs.get(ARCH).reduced(), JCtx(score_bf16=True))
    model = Model(cfg, ParallelCtx(attn_impl="chunked", score_bf16=True),
                  device="cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 20))
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                       max_len=32)
    tl, _ = model.prefill(params_from_numpy(np_params, "cpu"),
                          {"tokens": torch.from_numpy(toks)}, max_len=32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)


def test_params_from_numpy_keeps_bf16_bits():
    """bf16 leaves (ml_dtypes in numpy) arrive bit-exact as torch.bfloat16."""
    x = _f32(6, 4, 8)
    tree = {"w": np.asarray(jnp.asarray(x).astype(jnp.bfloat16)),
            "blocks": {"b": x}}
    got = params_from_numpy(tree, "cpu")
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], torch.from_numpy(x).to(torch.bfloat16))
    assert torch.equal(got["blocks"]["b"], torch.from_numpy(x))
