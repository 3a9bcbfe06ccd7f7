"""The SSD chunked scan (B4): the port's plain version and ``ops.ssd`` on the
CPU against the JAX Pallas kernel in interpret mode, the reference's
``ops.ssd`` and the recurrent oracle; the lane mask; the chunk rule; and the
no-fallback rule of the kernel's wrapper."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan
from repro.models import ssm as jssm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as sd
from repro_torch.models import ssm

# f32: both sides compute the same chunked algorithm in f32, summed in
# different orders. y sums up to Q·N + Q·hd products and reaches |y| ~ 100
# on these inputs, where small entries are the cancellation of large terms,
# so the bound is relative to the output's scale: max |a - d| <= 1e-5 ·
# max(1, max |d|), the reference's own 1e-5 kernel-vs-chunked bound
# (tests/test_kernels.py:122) applied to that scale; seen: <= 3e-6.
# bf16: both compute in f32 from the same bf16 inputs and round y to bf16
# once, so y may land one bf16 ulp (at most 2^-7 relative) apart; the f32
# states still meet the f32 bound.
SCALED = 1e-5
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# against the O(S) recurrence: another algorithm (a cumsum of log decays vs
# a product of decays), the reference's own bound (tests/test_ssm_attention
# .py:35) on the output's scale; seen: <= 4e-6
ORACLE = 2e-4


def _close(actual, desired, scaled=SCALED):
    a, d = _np(actual), _np(desired)
    assert a.shape == d.shape
    err = np.abs(a - d).max()
    assert err <= scaled * max(1.0, np.abs(d).max()), err


def _close_y(actual, desired, dtype):
    if dtype == "bfloat16":
        np.testing.assert_allclose(_np(actual), _np(desired), **BF16_TOL)
    else:
        _close(actual, desired)


# the reference's kernel test shapes (tests/test_kernels.py:89-92)
SHAPES = [(2, 128, 4, 16, 32, 32),
          (1, 64, 2, 8, 16, 64),
          (2, 96, 3, 16, 64, 32)]


def _inputs(seed, b, S, nh, hd, N):
    """x, dt = softplus(normal), A = -exp(normal), B, C as f32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, nh)))).astype(np.float32)
    A = -np.exp(rng.standard_normal((nh,))).astype(np.float32)
    B = rng.standard_normal((b, S, N)).astype(np.float32)
    C = rng.standard_normal((b, S, N)).astype(np.float32)
    return x, dt, A, B, C


def _both(arrays, dtype):
    """(jax, torch) versions; x, dt, B, C in ``dtype`` (as the reference's
    kernel test casts them), A in f32."""
    x, dt, A, B, C = arrays
    j = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (x, dt, B, C)]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, dt, B, C)]
    return ((j[0], j[1], jnp.asarray(A), j[2], j[3]),
            (t[0], t[1], torch.from_numpy(A), t[2], t[3]))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,S,nh,hd,N,chunk", SHAPES)
def test_plain_matches_pallas_kernel(b, S, nh, hd, N, chunk, dtype):
    jin, tin = _both(_inputs(S + N, b, S, nh, hd, N), dtype)
    y_j, st_j = j_ssd_scan(*jin, chunk=chunk, interpret=True)
    y, st = sd.ssd_scan_plain(*tin, chunk=chunk)
    assert y.dtype == tin[0].dtype and y.shape == tin[0].shape
    assert st.dtype == torch.float32 and st.shape == (b, nh, hd, N)
    _close_y(y, y_j, dtype)
    _close(st, st_j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,S,nh,hd,N,chunk", SHAPES)
def test_ops_ssd_matches_reference_ops(b, S, nh, hd, N, chunk, dtype):
    """The entry point on the CPU (the plain version) against the
    reference's ``ops.ssd`` on the CPU (its chunked jnp path)."""
    jin, tin = _both(_inputs(7 * S + N, b, S, nh, hd, N), dtype)
    y_j, st_j = jops.ssd(*jin, chunk=chunk)
    y, st = ops.ssd(*tin, chunk=chunk)
    _close_y(y, y_j, dtype)
    _close(st, st_j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,S,nh,hd,N,chunk", SHAPES)
def test_plain_matches_recurrent_oracle(b, S, nh, hd, N, chunk, dtype):
    """Against both packages' ``ssd_ref`` fed the same f32-widened inputs,
    as tests/test_kernels.py:98-99 does."""
    jin, tin = _both(_inputs(S + 3 * N, b, S, nh, hd, N), dtype)
    y, st = sd.ssd_scan_plain(*tin, chunk=chunk)
    y_o, st_o = ref.ssd_ref(*(t.float() for t in tin))
    y_jo, st_jo = jref.ssd_ref(*(a.astype(jnp.float32) for a in jin))
    _close(y_o, y_jo, ORACLE)
    _close(st_o, st_jo, ORACLE)
    if dtype == "float32":
        _close(y, y_o, ORACLE)
    else:
        np.testing.assert_allclose(_np(y), _np(y_o), **BF16_TOL)
    _close(st, st_o, ORACLE)


@pytest.mark.parametrize("chunk", [64, 128, 1000])
def test_chunk_at_least_seq_is_one_chunk(chunk):
    """chunk >= S runs one chunk of S (``min(chunk, S)``), as the
    reference's kernel does."""
    jin, tin = _both(_inputs(5, 2, 64, 2, 16, 16), "float32")
    y_j, st_j = j_ssd_scan(*jin, chunk=chunk, interpret=True)
    for y, st in (sd.ssd_scan_plain(*tin, chunk=chunk),
                  ops.ssd(*tin, chunk=chunk)):
        _close(y, y_j)
        _close(st, st_j)


def _start_state(seed, b, nh, hd, N):
    return np.random.default_rng(seed).standard_normal(
        (b, nh, hd, N)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", [sd.ssd_scan_plain, sd.ssd_scan, ops.ssd])
def test_init_state_matches_reference_chunked(fn, dtype):
    """A non-zero start state (on the card, the kernel's ``init`` input)
    against the reference's ``ssd_chunked(init_state=...)``."""
    b, S, nh, hd, N = 2, 96, 3, 16, 64
    jin, tin = _both(_inputs(41, b, S, nh, hd, N), dtype)
    s0 = _start_state(42, b, nh, hd, N)
    y_j, st_j = jssm.ssd_chunked(*jin, chunk=32, init_state=jnp.asarray(s0))
    y, st = fn(*tin, chunk=32, init_state=torch.from_numpy(s0))
    _close_y(y, y_j, dtype)
    _close(st, st_j)


def test_init_state_continues_a_split_sequence_through_ops():
    """``ops.ssd`` over the second half from the first half's final state
    gives the whole sequence's y and state."""
    _, tin = _both(_inputs(43, 2, 128, 2, 16, 32), "float32")
    y, st = ops.ssd(*tin, chunk=32)
    half = [t[:, :64] for t in (tin[0], tin[1])]
    y1, st1 = ops.ssd(*half, tin[2], tin[3][:, :64], tin[4][:, :64],
                      chunk=32)
    y2, st2 = ops.ssd(tin[0][:, 64:], tin[1][:, 64:], tin[2],
                      tin[3][:, 64:], tin[4][:, 64:], chunk=32,
                      init_state=st1)
    _close(torch.cat([y1, y2], dim=1), y)
    _close(st2, st)


@pytest.mark.parametrize("active", [(1, 0, 1), (0, 0, 1)])
def test_ssd_masked_lanes_with_init_state(active):
    """A start state does not leak into an inactive lane: its y and state
    are exact zeros; active lanes are bit-identical to the unmasked call."""
    _, tin = _both(_inputs(44, 3, 64, 2, 16, 16), "float32")
    s0 = torch.from_numpy(_start_state(45, 3, 2, 16, 16))
    y_d, st_d = ops.ssd(*tin, chunk=32, init_state=s0)
    y_m, st_m = ops.ssd(*tin, chunk=32, init_state=s0,
                        active=torch.tensor(active))
    for j, a in enumerate(active):
        if a:
            assert torch.equal(y_m[j], y_d[j]) and torch.equal(st_m[j],
                                                               st_d[j])
        else:
            assert not y_m[j].any() and not st_m[j].any()


@pytest.mark.parametrize("fn", [sd.ssd_scan_plain, sd.ssd_scan, ops.ssd,
                                ssm.ssd_chunked])
def test_seq_not_a_chunk_multiple_raises(fn):
    _, tin = _both(_inputs(6, 1, 48, 2, 8, 16), "float32")
    with pytest.raises(ValueError, match="chunk"):
        fn(*tin, chunk=32)


def test_plain_matches_chunked_without_nan_when_decays_overflow():
    """Strong decay (|dt A| up to ~500 a step) makes exp(la_i - la_j)
    overflow above the diagonal; a where keeps it out (a mask product would
    give inf * 0 = NaN), and the result still matches the recurrence."""
    x, dt, A, B, C = _inputs(8, 1, 32, 2, 8, 8)
    dt = dt * 20.0
    A = A * 10.0
    tin = [torch.from_numpy(a) for a in (x, dt, A, B, C)]
    y_o, st_o = ref.ssd_ref(*tin)
    for y, st in (sd.ssd_scan_plain(*tin, chunk=16),
                  ssm.ssd_chunked(*tin, chunk=16)):
        assert torch.isfinite(y).all() and torch.isfinite(st).all()
        _close(y, y_o, ORACLE)
        _close(st, st_o, ORACLE)


@pytest.mark.parametrize("active", [(1, 0, 1, 0), (0, 1, 0, 0), (1, 1, 1, 1),
                                    (0, 0, 0, 0)])
def test_ssd_masked_lanes_y_and_state(active):
    """The reference's masked contract (tests/test_kernels.py:338-360): y
    AND the final state are exact zeros on inactive lanes and bit-identical
    to the unmasked call on active ones; and the port's masked outputs
    agree with the reference's ``ops.ssd(active=...)``."""
    jin, tin = _both(_inputs(31, 4, 64, 2, 16, 16), "float32")
    y_d, st_d = ops.ssd(*tin, chunk=32)
    y_m, st_m = ops.ssd(*tin, chunk=32, active=torch.tensor(active))
    for j, a in enumerate(active):
        if a:
            assert torch.equal(y_m[j], y_d[j]) and torch.equal(st_m[j],
                                                               st_d[j])
        else:
            assert not y_m[j].any() and not st_m[j].any()
    y_jm, st_jm = jops.ssd(*jin, chunk=32, active=jnp.asarray(active))
    _close(y_m, y_jm)
    _close(st_m, st_jm)


def test_mask_accepts_bool_and_numpy_predicates():
    _, tin = _both(_inputs(32, 3, 32, 2, 8, 8), "float32")
    want = ops.ssd(*tin, chunk=32, active=torch.tensor([1, 0, 1]))
    for active in (np.array([True, False, True]), [1, 0, 1],
                   torch.tensor([True, False, True])):
        got = ops.ssd(*tin, chunk=32, active=active)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_cuda_wrapper_never_runs_on_cpu_tensors():
    """On a CPU tensor ``ssd_scan_cuda`` raises (no silent fallback), and
    ``ssd_scan`` refuses a device that has no kernel."""
    _, tin = _both(_inputs(9, 1, 32, 2, 8, 8), "float32")
    before = sd.ssd_scan_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        sd.ssd_scan_cuda(*tin, chunk=32)
    with pytest.raises(ValueError, match="no kernel"):
        sd.ssd_scan(*(t.to("meta") for t in tin), chunk=32)
    assert sd.ssd_scan_cuda.launches == before


def test_cuda_wrapper_refuses_grad():
    """No backward kernel in either package: the CUDA wrapper raises before
    anything else when autograd would need one."""
    _, tin = _both(_inputs(10, 1, 32, 2, 8, 8), "float32")
    x = tin[0].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        sd.ssd_scan_cuda(x, *tin[1:], chunk=32)


def test_shared_memory_plan_fits_the_serving_shape():
    """mamba2-130m's prefill (chunk 128, head dim 64, state 128) fits one
    CTA's shared memory (227 KB) in the kernel's layout; a head dim of 128
    at that chunk and state does not, and the wrapper would refuse it."""
    assert sd.smem_bytes(128, 64, 128) == 219_648 <= sd._MAX_SMEM
    assert sd.smem_bytes(128, 128, 128) > sd._MAX_SMEM
    assert sd.smem_bytes(9, 16, 16) == 4 * (2 * 16 * 16 + 12 * 16 + 12 * 36
                                            + 16 * 16 + 12)
