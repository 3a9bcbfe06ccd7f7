"""The port's Mamba2 sequence mixer (``models/ssm.py``) and the ssm family of
``Model`` against the JAX reference on the CPU, from the same numpy inputs
and the reference's own parameters: the chunked scan with and without an
initial state, the recurrent step, the causal conv, the full block and its
decode step (with the prefill-then-decode continuity test of
tests/test_ssm_attention.py), and prefill / decode of the reduced
mamba2-130m under each sequence-mixer path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import SSMConfig as JSSMConfig
from repro.models import ParallelCtx as JCtx, build_model as jbuild
from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.configs.base import SSMConfig
from repro_torch.models import ssm
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model
from repro_torch.models.transformer import ParallelCtx

ARCH = "mamba2-130m"
# f32 on both sides, the same algorithm summed in different orders: y and
# the states reach |x| ~ 100 on unit-normal inputs, so the bound is on the
# output's scale (max |a - d| <= 1e-5 · max(1, max |d|)), as in
# tests/test_torch_ssd.py; seen: <= 3e-6
SCALED = 1e-5
# a block or a model: projections, conv, scan, norm and (for the model) two
# layers and the tied head, all f32, unit-scale outputs; the dense model's
# bound (tests/test_torch_model.py)
ATOL = 1e-4
# the continuity test's own bounds (tests/test_ssm_attention.py:62-68): the
# decode chain is another algorithm than the chunked scan
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
CHAIN_TOL = dict(rtol=1e-3, atol=1e-3)
SMALL = SSMConfig(state_dim=16, head_dim=8, expand=2, conv_width=4,
                  chunk_size=16)
J_SMALL = JSSMConfig(state_dim=16, head_dim=8, expand=2, conv_width=4,
                     chunk_size=16)
D = 32


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(actual, desired, scaled=SCALED):
    a, d = _np(actual), _np(desired)
    assert a.shape == d.shape
    err = np.abs(a - d).max()
    assert err <= scaled * max(1.0, np.abs(d).max()), err


def _scan_inputs(seed, b, S, nh, hd, N):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, S, nh, hd)).astype(np.float32),
            np.log1p(np.exp(rng.standard_normal((b, S, nh)))).astype(
                np.float32),
            -np.exp(rng.standard_normal((nh,))).astype(np.float32),
            rng.standard_normal((b, S, N)).astype(np.float32),
            rng.standard_normal((b, S, N)).astype(np.float32))


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("b,S,nh,hd,N,chunk",
                         [(2, 64, 2, 8, 16, 16), (1, 96, 3, 16, 8, 32),
                          (2, 40, 4, 4, 8, 8)])
def test_ssd_chunked_matches_reference(b, S, nh, hd, N, chunk, with_state):
    arrays = _scan_inputs(S + nh, b, S, nh, hd, N)
    s0 = (np.random.default_rng(1).standard_normal((b, nh, hd, N)).astype(
        np.float32) if with_state else None)
    y, st = ssm.ssd_chunked(*_t(arrays), chunk=chunk,
                            init_state=None if s0 is None
                            else torch.from_numpy(s0))
    y_j, st_j = jssm.ssd_chunked(*_j(arrays), chunk=chunk,
                                 init_state=None if s0 is None
                                 else jnp.asarray(s0))
    _close(y, y_j)
    _close(st, st_j)


def test_ssd_chunked_init_state_continues_a_split_sequence():
    """Scanning the second half from the first half's state gives the
    second half of the whole scan."""
    x, dt, A, B, C = _t(_scan_inputs(3, 2, 64, 2, 8, 16))
    y, st = ssm.ssd_chunked(x, dt, A, B, C, chunk=16)
    _, st1 = ssm.ssd_chunked(x[:, :32], dt[:, :32], A, B[:, :32], C[:, :32],
                             chunk=16)
    y2, st2 = ssm.ssd_chunked(x[:, 32:], dt[:, 32:], A, B[:, 32:], C[:, 32:],
                              chunk=16, init_state=st1)
    _close(y2, y[:, 32:])
    _close(st2, st)


@pytest.mark.parametrize("seed", range(4))
def test_ssd_chunked_matches_recurrence(seed):
    """Port of tests/test_ssm_attention.py::test_ssd_chunked_matches_
    recurrence on the port alone, at its bound (2e-4)."""
    rng = np.random.default_rng(100 + seed)
    nh = int(rng.choice([1, 2, 4]))
    hd = int(rng.choice([4, 8, 16]))
    N = int(rng.choice([8, 16]))
    chunk = int(rng.choice([8, 16, 32]))
    S = chunk * int(rng.integers(1, 5))
    x, dt, A, B, C = _t(_scan_inputs(seed, int(rng.integers(1, 3)), S, nh,
                                     hd, N))
    y1, s1 = ssm.ssd_chunked(x, dt, A, B, C, chunk=chunk)
    y2, s2 = ssm.ssd_reference_recurrent(x, dt, A, B, C)
    np.testing.assert_allclose(_np(y1), _np(y2), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(s1), _np(s2), rtol=2e-4, atol=2e-4)


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(4)
    b, nh, hd, N = 3, 4, 8, 16
    arrays = [rng.standard_normal(s).astype(np.float32) for s in
              ((b, nh, hd, N), (b, nh, hd), (b, nh), (nh,), (b, N), (b, N))]
    arrays[2] = np.abs(arrays[2])
    arrays[3] = -np.abs(arrays[3])
    y, st = ssm.ssd_decode_step(*_t(arrays))
    y_j, st_j = jssm.ssd_decode_step(*_j(arrays))
    _close(y, y_j)
    _close(st, st_j)


def test_causal_conv_and_step_match_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, 8)).astype(np.float32)
    w = rng.standard_normal((4, 8)).astype(np.float32)
    b = rng.standard_normal((8,)).astype(np.float32)
    _close(ssm.causal_conv1d(*_t((x, w, b))),
           jssm.causal_conv1d(*_j((x, w, b))))
    conv = rng.standard_normal((2, 3, 8)).astype(np.float32)
    y, new = ssm.causal_conv1d_step(*_t((conv, x[:, 0], w, b)))
    y_j, new_j = jssm.causal_conv1d_step(*_j((conv, x[:, 0], w, b)))
    _close(y, y_j)
    _close(new, new_j)


def test_causal_conv_is_causal():
    g = torch.Generator().manual_seed(0)
    w = torch.randn((4, 8), generator=g)
    b = torch.zeros((8,))
    x = torch.randn((1, 16, 8), generator=g)
    y1 = ssm.causal_conv1d(x, w, b)
    x2 = x.clone()
    x2[:, 10:] = 99.0                           # corrupt the future
    y2 = ssm.causal_conv1d(x2, w, b)
    assert torch.equal(y1[:, :10], y2[:, :10])


def _small_params(seed=0):
    jp = jssm.init_mamba2(jax.random.PRNGKey(seed), D, J_SMALL, jnp.float32)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 "cpu")


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape), str(tree.dtype).replace("torch.", "")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mamba2_tree_matches_reference(dtype):
    """Same names, shapes and dtypes (A_log, dt_bias and D stay f32); the
    draws are the port's own, so only their ranges are held."""
    jp = jssm.init_mamba2(jax.random.PRNGKey(0), D, J_SMALL,
                          getattr(jnp, dtype))
    mine = ssm.init_mamba2(torch.Generator().manual_seed(0), D, SMALL,
                           getattr(torch, dtype))
    assert _shapes(mine) == _shapes(jax.tree_util.tree_map(np.asarray, jp))
    dt = torch.nn.functional.softplus(mine["dt_bias"])
    assert (dt > 1e-3 * 0.999).all() and (dt < 1e-1 * 1.001).all()
    a = torch.exp(mine["A_log"])
    assert (a >= 1.0).all() and (a <= 16.0).all()


@pytest.mark.parametrize("impl", ["kernel", "chunked", "plain"])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_block_matches_reference(impl, with_state):
    """Every path on the CPU (an initial state always takes the chunked
    scan) against the reference's block from its own parameters."""
    jp, tp = _small_params()
    x = (np.random.default_rng(6).standard_normal((2, 32, D)) * 0.5).astype(
        np.float32)
    s0 = (np.random.default_rng(7).standard_normal((2, 8, 8, 16)).astype(
        np.float32) if with_state else None)
    y, st = ssm.mamba2_block(tp, torch.from_numpy(x), D, SMALL,
                             init_state=None if s0 is None
                             else torch.from_numpy(s0), impl=impl)
    y_j, st_j = jssm.mamba2_block(jp, jnp.asarray(x), D, J_SMALL,
                                  init_state=None if s0 is None
                                  else jnp.asarray(s0))
    np.testing.assert_allclose(_np(y), _np(y_j), rtol=ATOL, atol=ATOL)
    _close(st, st_j)


def test_mamba2_prefill_state_matches_reference_projection():
    """``mamba2_prefill`` takes the conv state from its one projection: the
    last width-1 projected inputs, as the reference re-projects them."""
    jp, tp = _small_params()
    x = (np.random.default_rng(8).standard_normal((2, 32, D)) * 0.5).astype(
        np.float32)
    _, state = ssm.mamba2_prefill(tp, torch.from_numpy(x), D, SMALL)
    _, xBC, _, _ = jssm._project(jp, jnp.asarray(x), D, J_SMALL)
    _, st_j = jssm.mamba2_block(jp, jnp.asarray(x), D, J_SMALL)
    np.testing.assert_allclose(_np(state["conv"]), _np(xBC[:, -3:]),
                               rtol=1e-5, atol=1e-5)
    _close(state["ssm"], st_j)


def test_mamba2_decode_step_matches_reference():
    jp, tp = _small_params(1)
    rng = np.random.default_rng(9)
    x_t = rng.standard_normal((3, D)).astype(np.float32)
    st = {"conv": rng.standard_normal((3, 3, 64 + 32)).astype(np.float32),
          "ssm": rng.standard_normal((3, 8, 8, 16)).astype(np.float32)}
    y, new = ssm.mamba2_decode_step(
        tp, torch.from_numpy(x_t),
        {k: torch.from_numpy(v) for k, v in st.items()}, D, SMALL)
    y_j, new_j = jssm.mamba2_decode_step(
        jp, jnp.asarray(x_t), {k: jnp.asarray(v) for k, v in st.items()},
        D, J_SMALL)
    np.testing.assert_allclose(_np(y), _np(y_j), rtol=ATOL, atol=ATOL)
    for k in ("conv", "ssm"):
        _close(new[k], new_j[k])


@pytest.mark.parametrize("impl", ["kernel", "chunked", "plain"])
def test_mamba2_prefill_then_decode_continues_exactly(impl):
    """Port of tests/test_ssm_attention.py::test_mamba2_prefill_then_decode_
    continues_exactly: decode from the prefill state == the decode chain,
    and the chunked block == the decode chain everywhere."""
    p = ssm.init_mamba2(torch.Generator().manual_seed(0), D, SMALL,
                        torch.float32)
    x = torch.randn((2, 33, D), generator=torch.Generator().manual_seed(1)) \
        * 0.5
    y_full, _ = ssm.mamba2_block(p, x[:, :32], D, SMALL, impl=impl)
    _, state = ssm.mamba2_prefill(p, x[:, :32], D, SMALL, impl=impl)
    y_t, _ = ssm.mamba2_decode_step(p, x[:, 32], state, D, SMALL)
    st = ssm.init_decode_state(2, D, SMALL, torch.float32)
    ys = []
    for t in range(33):
        y_step, st = ssm.mamba2_decode_step(p, x[:, t], st, D, SMALL)
        ys.append(y_step)
    np.testing.assert_allclose(_np(y_t), _np(ys[32]), **STEP_TOL)
    np.testing.assert_allclose(_np(y_full), _np(torch.stack(ys[:32], 1)),
                               **CHAIN_TOL)


# ---------------------------------------------------------------------------
# the ssm family of Model, reduced mamba2-130m
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_model():
    jm = jbuild(jconfigs.get(ARCH).reduced(), JCtx())
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                     "cpu")


def test_model_init_and_cache_match_reference(ref_model):
    jm, jp, tp = ref_model
    model = Model(configs.get(ARCH).reduced(), device="cpu")
    mine = model.init(torch.Generator().manual_seed(0))
    assert _shapes(mine) == _shapes(tp)
    want = jax.tree_util.tree_map(np.asarray, jm.make_cache(3, 40))
    got = model.make_cache(3, 40)
    assert _shapes(got) == _shapes(want)
    assert all(not t.any() for t in got.values())


@pytest.mark.parametrize("impl", ["kernel", "chunked", "plain"])
@pytest.mark.parametrize("S", [64, 20])
def test_model_prefill_and_decode_match_reference(ref_model, impl, S):
    """Prefill (a chunk multiple, and one short chunk), then four decode
    steps, under each sequence-mixer path, against the reference's Model:
    logits and the whole cache."""
    jm, jp, tp = ref_model
    model = Model(configs.get(ARCH).reduced(), ParallelCtx(attn_impl=impl),
                  device="cpu")
    toks = np.random.default_rng(S).integers(0, 256, (2, S))
    lg, cache = model.prefill(tp, {"tokens": torch.from_numpy(toks)}, 96)
    lg_j, cache_j = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 96)
    np.testing.assert_allclose(_np(lg), _np(lg_j), rtol=ATOL, atol=ATOL)
    for k in ("conv", "ssm"):
        _close(cache[k], cache_j[k])
    rng = np.random.default_rng(S + 1)
    for step in range(4):
        batch = {"tokens": rng.integers(0, 256, (2, 1)),
                 "pos": np.full((2,), S + step)}
        lg, cache = model.decode_step(
            tp, {k: torch.from_numpy(v) for k, v in batch.items()}, cache)
        lg_j, cache_j = jm.decode_step(
            jp, {k: jnp.asarray(v) for k, v in batch.items()}, cache_j)
        np.testing.assert_allclose(_np(lg), _np(lg_j), rtol=ATOL, atol=ATOL)
    for k in ("conv", "ssm"):
        _close(cache[k], cache_j[k])


def test_model_kernel_and_plain_paths_agree_on_cpu(ref_model):
    """On a CPU tensor the "kernel" path is the kernel's plain version,
    which computes what ``ssd_chunked`` does: the three paths agree."""
    _, _, tp = ref_model
    toks = torch.from_numpy(np.random.default_rng(11).integers(0, 256,
                                                               (1, 96)))
    outs = [Model(configs.get(ARCH).reduced(), ParallelCtx(attn_impl=i),
                  device="cpu").prefill(tp, {"tokens": toks}, 100)
            for i in ("kernel", "chunked", "plain")]
    for lg, cache in outs[1:]:
        _close(lg, outs[0][0])
        _close(cache["ssm"], outs[0][1]["ssm"])


def test_prefill_rejects_a_seq_that_is_not_a_chunk_multiple(ref_model):
    _, _, tp = ref_model
    model = Model(configs.get(ARCH).reduced(), device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        model.prefill(tp, {"tokens": torch.zeros((1, 40), dtype=torch.long)},
                      64)


@pytest.mark.parametrize("name", ["qwen2-vl-7b", "seamless-m4t-medium"])
def test_unported_families_raise(name):
    with pytest.raises(NotImplementedError, match="A.7"):
        Model(configs.get(name).reduced(), device="cpu")


@pytest.mark.parametrize("device,grad,want", [
    ("cuda", False, "kernel"), ("cuda", True, "chunked"),
    ("cpu", False, "chunked"), ("cpu", True, "chunked"),
])
def test_scan_route_by_device_and_grad(device, grad, want):
    """With no ``impl`` given, a block runs the kernel only where no gradient
    is needed; under autograd it takes the reference model's own scan."""
    assert ssm.scan_impl(torch.device(device), grad) == want


def test_block_route_under_grad_transforms(monkeypatch):
    """Where the device default is "kernel" (the card), a block under
    ``torch.func.grad``, ``vmap(grad)`` or ``torch.autograd`` routes its
    scan to "chunked", and its gradient matches ``jax.grad`` of the
    reference's block; without grad the kernel route stays."""
    monkeypatch.setattr(ssm, "default_impl", lambda device: "kernel")
    seen = []
    real = ssm._scan
    monkeypatch.setattr(ssm, "_scan",
                        lambda impl, *a: seen.append(impl) or real(impl, *a))
    jp, tp = _small_params()
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((3, 2, 32, D)) * 0.5).astype(np.float32)
    w = rng.standard_normal((3, 2, 32, D)).astype(np.float32)

    def loss(x, w):
        return (ssm.mamba2_block(tp, x, D, SMALL)[0] * w).sum()

    g = torch.func.vmap(torch.func.grad(loss))(torch.from_numpy(x),
                                               torch.from_numpy(w))
    g0 = torch.func.grad(loss)(torch.from_numpy(x[0]), torch.from_numpy(w[0]))
    xt = torch.from_numpy(x[0]).requires_grad_()
    loss(xt, torch.from_numpy(w[0])).backward()
    with torch.no_grad():
        ssm.mamba2_block(tp, torch.from_numpy(x[0]), D, SMALL)
    assert seen == ["chunked"] * 3 + ["kernel"]

    def j_loss(x, w):
        return (jssm.mamba2_block(jp, x, D, J_SMALL)[0] * w).sum()

    expect = jax.vmap(jax.grad(j_loss))(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(_np(g), np.asarray(expect), rtol=ATOL,
                               atol=ATOL)
    np.testing.assert_allclose(_np(g0), _np(g[0]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(xt.grad), _np(g0), rtol=1e-6, atol=1e-6)


def test_needs_grad_sees_grad_transforms():
    x = torch.randn(3)
    assert not ssm.needs_grad(x, None)
    assert ssm.needs_grad(x.requires_grad_(), None)
    with torch.no_grad():
        assert not ssm.needs_grad(x)
    seen = []

    def f(y):
        seen.append(ssm.needs_grad(y))
        return y.sum()

    torch.func.grad(f)(torch.randn(3))
    torch.func.vmap(torch.func.grad(f))(torch.randn(2, 3))
    torch.func.vmap(f)(torch.randn(2, 3))
    assert seen == [True, True, False]
