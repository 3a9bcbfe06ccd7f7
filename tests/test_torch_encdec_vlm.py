"""The port's vlm (Qwen2-VL: dense GQA decoder under M-RoPE, fed embeddings)
and encdec (SeamlessM4T: bidirectional encoder, decoder blocks with
cross-attention) families against the JAX reference, f32 on the CPU from
the reference's own parameters: ``layer_norm``, M-RoPE with distinct t/h/w
streams, cross-attention, the init trees, prefill and decode (an encoder
memory longer and shorter than the cache), the loss and its gradient with
remat on and off, and ``input_specs`` for every config and runnable shape.

Self-attention runs both routes: impl="kernel" (``ops`` on a CPU tensor: B3's
plain version) and "chunked" (the reference's own path). Cross-attention
takes ``sdpa_chunked`` on every route, as in the reference. Tolerance: 1e-4
on logits, caches and losses, as ``tests/test_torch_model.py`` (f32 end to
end, sums in other orders); gradients within 1e-4 of the largest entry of
each leaf, as ``tests/test_torch_moe.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from chip_smoke import mrope_streams
from repro import configs as jconfigs
from repro.models import build_model as jbuild
from repro.models import attention as jattention
from repro.models import layers as jlayers
from repro_torch import configs
from repro_torch.core import packing
from repro_torch.models import attention, layers
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model
from repro_torch.models.transformer import ParallelCtx

VLM, ENCDEC = "qwen2-vl-7b", "seamless-m4t-medium"
ATOL = 1e-4
GRAD_REL = 1e-4
# a text prefix, an image of 2 x 3 merged patches, a text suffix: 13
# positions whose t, h and w streams differ
SEGMENTS = (("text", 3), ("image", (2, 3)), ("text", 4))


def _f32(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape), str(tree.dtype).replace("torch.", "")


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(mine, want, what=""):
    np.testing.assert_allclose(mine.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0, err_msg=what)


# --------------------------------------------------------------- layers


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_layer_norm_matches_reference(eps):
    x, w, b = _f32(0, 3, 5, 64) * 3 + 1, _f32(1, 64), _f32(2, 64)
    np.testing.assert_allclose(
        layers.layer_norm(*map(torch.from_numpy, (x, w, b)), eps).numpy(),
        np.asarray(jlayers.layer_norm(*map(jnp.asarray, (x, w, b)), eps)),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("head_dim,want", [(16, (2, 3, 3)), (64, (8, 12, 12)),
                                           (112, (14, 21, 21)),
                                           (128, (16, 24, 24))])
def test_mrope_section_sizes_match_reference(head_dim, want):
    assert layers.mrope_section_sizes(head_dim) == want
    assert jlayers.mrope_section_sizes(head_dim) == want


def test_mrope_streams_follow_qwen2_vl():
    """Text t = h = w = index; the image's t its start, h and w start + row
    and start + col; text after it resumes past the largest position."""
    pos, nxt = mrope_streams(SEGMENTS)
    assert pos.tolist() == [[0, 1, 2, 3, 3, 3, 3, 3, 3, 6, 7, 8, 9],
                            [0, 1, 2, 3, 3, 3, 4, 4, 4, 6, 7, 8, 9],
                            [0, 1, 2, 3, 4, 5, 3, 4, 5, 6, 7, 8, 9]]
    assert nxt == 10


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("D", [16, 128])
def test_apply_mrope_matches_reference(theta, D):
    """Distinct t/h/w streams (equal ones reduce M-RoPE to RoPE), and the
    result differs from RoPE on the t stream alone."""
    x = _f32(3, 2, 13, 3, D)
    pos = np.stack([mrope_streams(SEGMENTS)[0]] * 2, 1) * 37  # (3, 2, 13)
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta).numpy()
    want = np.asarray(jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos),
                                          theta))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * max(
        1.0, float(np.abs(want).max())))
    rope = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]),
                             theta).numpy()
    assert np.abs(rope - got).max() > 1e-2


# ------------------------------------------------------------ attention


def _attn_params(seed, d, hq, hkv, hd):
    jp = jattention.init_attention(jax.random.PRNGKey(seed), d, hq, hkv, hd,
                                   jnp.float32)
    return jp, params_from_numpy(_np(jp), "cpu")


def test_project_kv_and_attn_with_kv_match_reference():
    jp, tp = _attn_params(0, 32, 4, 2, 8)
    ctx, x = _f32(4, 2, 11, 32), _f32(5, 2, 7, 32)
    jk, jv = jattention.project_kv(jp, jnp.asarray(ctx), 2, 8)
    tk, tv = attention.project_kv(tp, torch.from_numpy(ctx), 2, 8)
    assert tuple(tk.shape) == (2, 11, 2, 8)
    _close(tk, jk, "k")
    _close(tv, jv, "v")
    _close(attention.attn_with_kv(tp, torch.from_numpy(x), tk, tv, 4, 8),
           jattention.attn_with_kv(jp, jnp.asarray(x), jk, jv, 4, 8))


@pytest.mark.parametrize("impl", ["kernel", "chunked"])
def test_attention_block_cross_and_mrope_match_reference(impl):
    """``attention_block`` with ``kv_ctx`` (cross-attention: no rope, no
    cache) and with ``mrope_positions`` (self-attention, prefill into a
    cache, then one decode step whose cache slots come from ``positions``
    and whose rotation from the M-RoPE streams)."""
    jp, tp = _attn_params(1, 32, 4, 2, 16)
    x, ctx = _f32(6, 2, 13, 32), _f32(7, 2, 9, 32)
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=16, rope_theta=1e4)
    pos = np.stack([np.arange(13)] * 2)
    mrope = np.stack([mrope_streams(SEGMENTS)[0]] * 2, 1)
    jo, jc = jattention.attention_block(
        jp, jnp.asarray(x), positions=jnp.asarray(pos),
        kv_ctx=jnp.asarray(ctx), **kw)
    to, tc = attention.attention_block(
        tp, torch.from_numpy(x), positions=torch.from_numpy(pos),
        kv_ctx=torch.from_numpy(ctx), impl=impl, **kw)
    assert jc is None and tc is None
    _close(to, jo, "cross")

    jcache = jattention.init_kv_cache(2, 16, 2, 16, jnp.float32)
    tcache = attention.init_kv_cache(2, 16, 2, 16, torch.float32)
    jo, jcache = jattention.attention_block(
        jp, jnp.asarray(x), positions=jnp.asarray(pos),
        mrope_positions=jnp.asarray(mrope), kv_cache=jcache, **kw)
    to, tcache = attention.attention_block(
        tp, torch.from_numpy(x), positions=torch.from_numpy(pos),
        mrope_positions=torch.from_numpy(mrope), kv_cache=tcache, impl=impl,
        **kw)
    _close(to, jo, "mrope prefill")
    x1 = _f32(8, 2, 1, 32)
    step = np.full((2, 1), 13)
    jo, jcache = jattention.attention_block(
        jp, jnp.asarray(x1), positions=jnp.asarray(step),
        mrope_positions=jnp.full((3, 2, 1), 10), kv_cache=jcache, **kw)
    to, tcache = attention.attention_block(
        tp, torch.from_numpy(x1), positions=torch.from_numpy(step),
        mrope_positions=torch.full((3, 2, 1), 10), kv_cache=tcache,
        impl=impl, **kw)
    _close(to, jo, "mrope decode")
    for name in ("k", "v", "len", "pos"):
        _close(tcache[name], jcache[name], name)


# --------------------------------------------------------------- models


@pytest.mark.parametrize("arch", [VLM, ENCDEC])
@pytest.mark.parametrize("reduced", [True, False])
def test_init_tree_matches_reference(arch, reduced):
    """Keys, shapes and dtypes against ``jax.eval_shape`` of the
    reference's init; the full configs are drawn under FakeTensorMode."""
    jcfg, cfg = jconfigs.get(arch), configs.get(arch)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    want = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    with FakeTensorMode():
        mine = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert _shapes(mine) == _shapes(want)
    if not reduced:
        # 30.5 GB and 3.5 GB in f32 (the encdec's vocab padded to 256256)
        n = sum(t.numel() for t in packing.tree_leaves(mine))
        assert n == {VLM: 7_615_487_488, ENCDEC: 877_197_312}[arch]


@pytest.fixture(scope="module", params=[VLM, ENCDEC])
def ref_model(request):
    arch = request.param
    jm = jbuild(jconfigs.get(arch).reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    return arch, jm, jp, params_from_numpy(_np(jp), "cpu")


def _prefill_batch(arch, B, S, Se=0, seed=0):
    rng = np.random.default_rng(seed)
    if arch == VLM:
        segs = (("text", 3), ("image", (2, (S - 7) // 2)), ("text", 4))
        pos, nxt = mrope_streams(segs)
        assert pos.shape[1] == S
        embeds = rng.standard_normal((B, S, 64)).astype(np.float32) * 0.1
        return {"embeds": embeds,
                "mrope_pos": np.stack([pos] * B, 1)}, nxt
    return {"enc_embeds": rng.standard_normal((B, Se, 64)).astype(
        np.float32) * 0.1, "tokens": rng.integers(0, 256, (B, S))}, None


def _cache_close(mine, want):
    got = dict(mine.get("self", mine), **{k: mine[k] for k in mine
                                          if k.startswith("cross")})
    ref = dict(want.get("self", want), **{k: want[k] for k in want
                                          if k.startswith("cross")})
    assert sorted(got) == sorted(ref)
    for name in ref:
        assert tuple(got[name].shape) == tuple(ref[name].shape), name
        _close(got[name], ref[name], name)


@pytest.mark.parametrize("impl", ["kernel", "chunked"])
@pytest.mark.parametrize("Se,max_len", [(24, 16), (9, 16)])
def test_prefill_and_decode_match_reference(ref_model, impl, Se, max_len):
    """Prefill logits and cache, then 3 greedy decode steps. encdec: an
    encoder memory longer (24) and shorter (9) than the cache (16): the
    cross K/V come back Se long and decode attends over exactly them.
    vlm: distinct M-RoPE streams, a cache of 16 and one of 8 (shorter than
    the prompt: the ring keeps the last 8); decode moves all three streams
    to the next position, the ring cache to the next index."""
    arch, jm, jp, tp = ref_model
    if arch == VLM and Se < max_len:
        max_len = 8     # no encoder memory: a cache shorter than the prompt
    cfg = configs.get(arch).reduced()
    model = Model(cfg, ParallelCtx(attn_impl=impl), device="cpu")
    S = 11
    batch, nxt = _prefill_batch(arch, 2, S, Se)
    jl, jc = jm.prefill(jp, _j(batch), max_len=max_len)
    tl, tc = model.prefill(tp, _t(batch), max_len=max_len)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, 256)
    _close(tl, jl, "prefill logits")
    _cache_close(tc, jc)
    if arch == ENCDEC:
        assert tuple(tc["cross_k"].shape) == (2, 2, Se, 2, 16)

    cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int64)[:, None]
    pos = np.array([S, S], np.int64)
    for i in range(3):
        step = {"tokens": cur, "pos": pos}
        if arch == VLM:
            step["mrope_pos"] = np.full((3, 2, 1), nxt + i, np.int64)
        jl, jc = jm.decode_step(jp, {k: jnp.asarray(v, jnp.int32)
                                     for k, v in step.items()}, jc)
        tl, tc = model.decode_step(tp, _t(step), tc)
        _close(tl, jl, f"decode {i}")
        _cache_close(tc, jc)
        cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int64)[:, None]
        pos = pos + 1


def _loss_batch(arch, seed=6, B=2, S=11):
    batch, _ = _prefill_batch(arch, B, S, Se=9, seed=seed)
    batch["labels"] = np.random.default_rng(seed + 1).integers(0, 256, (B, S))
    return batch


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradient_match_reference(ref_model, remat):
    """The loss, and ``torch.func.grad`` of it against ``jax.grad``, with
    remat off and on (the encoder memory rides through remat as a tensor
    input, so the encoder's gradient is whole; the M-RoPE streams as an
    integer input)."""
    arch, _, jp, tp = ref_model
    jm = jbuild(dataclasses.replace(jconfigs.get(arch).reduced(),
                                    remat=remat))
    model = Model(dataclasses.replace(configs.get(arch).reduced(),
                                      remat=remat), device="cpu")
    b = _loss_batch(arch)
    jloss = jax.jit(lambda p: jm.loss(p, _j(b))[0])
    jgrad = jax.jit(jax.grad(lambda p: jm.loss(p, _j(b))[0]))
    tb = _t(b)
    tl = model.loss(tp, tb)[0]
    np.testing.assert_allclose(float(tl), float(jloss(jp)), rtol=0,
                               atol=ATOL)
    g = torch.func.grad(lambda p: model.loss(p, tb)[0])(tp)
    jg = _np(jgrad(jp))

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
    if arch == ENCDEC:
        assert float(g["encoder"]["attn"]["w_q"].abs().sum()) > 0


def _spec_tree(tree):
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    return tuple(tree.shape), str(tree.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", jconfigs.available())
def test_input_specs_match_reference(arch):
    """Every config builds, and for each runnable shape cell the port's
    ``input_specs`` has the reference's keys, shapes and dtypes, every leaf
    on ``meta`` (nothing allocated; decode_32k's cache alone would be
    hundreds of GB for the largest configs)."""
    model = Model(configs.get(arch), device="cpu")
    jm = jbuild(jconfigs.get(arch))
    for shape in configs.SHAPES:
        if not configs.cell_is_runnable(arch, shape.name):
            continue
        mine = model.input_specs(shape)
        want = jm.input_specs(jconfigs.SHAPES_BY_NAME[shape.name])
        assert _spec_tree(mine) == _spec_tree(want), shape.name
        assert all(t.is_meta for t in packing.tree_leaves(mine))
