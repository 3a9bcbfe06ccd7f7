"""The packed kernels of the lane pool's "kernel" mode: the port's
``ops.packed_matmul`` (B1, ``packed_gemm``) and ``ops.packed_norm`` (B2,
``packed_rmsnorm``) and its ``fused_rmsnorm`` (B5) on the CPU (the kernels'
plain versions) against the JAX Pallas kernels in interpret mode, their
lane masks, the no-fallback and no-backward rules, and the build rules.

Tolerances: the reference's own kernel-vs-oracle bounds
(tests/test_kernels.py:15): f32 rtol = atol = 2e-5 (two summation orders),
bf16 rtol = atol = 2e-2 (both sides compute in f32 and round the output to
bf16 once, so they may land one bf16 ulp apart). Masks are exact: active
lanes ``torch.equal`` to the unmasked call, inactive lanes exact zeros.
"""
import ctypes
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_rmsnorm import fused_rmsnorm as j_fused_rmsnorm
from repro.kernels.fused_rmsnorm import packed_rmsnorm as j_packed_rmsnorm
from repro.kernels.packed_gemm import packed_gemm as j_packed_gemm
from repro_torch.kernels import _build
from repro_torch.kernels import fused_rmsnorm as rn
from repro_torch.kernels import ops
from repro_torch.kernels import packed_gemm as pg
from tests.prop import given_cases

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
GEMM_SHAPES = [(4, 64, 64, 64, 32), (3, 50, 70, 30, 32), (8, 128, 32, 16, 64),
               (1, 16, 16, 16, 16)]             # tests/test_kernels.py:133-136
NORM_SHAPES = [(4, 16, 32, 8), (3, 20, 48, 8), (2, 300, 128, 256)]


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrays, dtype):
    j = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _assert_masked(masked, dense, active):
    for lane, a in enumerate(active):
        if a:
            assert torch.equal(masked[lane], dense[lane])
        else:
            assert torch.equal(masked[lane], torch.zeros_like(masked[lane]))


# ---------------------------------------------------------------------------
# B1 packed_gemm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("J,M,K,N,bm", GEMM_SHAPES)
def test_packed_matmul_matches_pallas_kernel(J, M, K, N, bm, dtype):
    (jx, jw), (x, w) = _both(_arrays(J * M + N, (J, M, K), (J, K, N)), dtype)
    expect = j_packed_gemm(jx, jw, block_m=bm, block_n=bm, block_k=bm,
                           interpret=True)
    out = ops.packed_matmul(x, w)
    assert out.dtype == x.dtype and out.shape == (J, M, N)
    np.testing.assert_allclose(_np(out), _np(expect), **TOL[dtype])


def test_packed_matmul_reads_a_transposed_view():
    """The gradient GEMM passes x^T as a strided view (no copy)."""
    (jx, jw), (x, w) = _both(_arrays(3, (4, 40, 24), (4, 40, 16)), "float32")
    xt = x.transpose(-1, -2)
    assert not xt.is_contiguous()
    out = ops.packed_matmul(xt, w)
    assert torch.equal(out, ops.packed_matmul(xt.contiguous(), w))
    expect = j_packed_gemm(jnp.swapaxes(jx, -1, -2), jw, block_m=16,
                           block_n=16, block_k=16, interpret=True)
    np.testing.assert_allclose(_np(out), _np(expect), **TOL["float32"])


@pytest.mark.parametrize("active", [(1, 0, 1, 0), (0, 0, 0, 1), (1, 1, 1, 1)])
def test_packed_matmul_masked_vs_dense(active):
    (jx, jw), (x, w) = _both(_arrays(11, (4, 64, 64), (4, 64, 64)), "float32")
    dense = ops.packed_matmul(x, w)
    masked = ops.packed_matmul(x, w, active=torch.tensor(active))
    _assert_masked(masked, dense, active)
    expect = j_packed_gemm(jx, jw, active=jnp.asarray(active), block_m=32,
                           block_n=32, block_k=32, interpret=True)
    np.testing.assert_allclose(_np(masked), _np(expect), **TOL["float32"])


# ---------------------------------------------------------------------------
# B2 packed_rmsnorm and B5 fused_rmsnorm
# ---------------------------------------------------------------------------

def test_packed_rmsnorm_masked_vs_oracle():
    """tests/test_kernels.py::test_packed_rmsnorm_masked_vs_oracle, on the
    port, against the Pallas kernel."""
    J, rows, d = 4, 16, 32
    x_np, w_np = _arrays(5, (J, rows, d), (J, d))
    w_np = 1.0 + 0.1 * w_np
    (jx, jw), (x, w) = _both([x_np, w_np], "float32")
    active = [1, 0, 1, 1]
    out = ops.packed_norm(x, w, active=torch.tensor(active))
    dense = ops.packed_norm(x, w)
    _assert_masked(out, dense, active)
    expect = j_packed_rmsnorm(jx, jw, active=jnp.asarray(active),
                              block_rows=8, interpret=True)
    np.testing.assert_allclose(_np(out), _np(expect), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("J,rows,d,block_rows", NORM_SHAPES)
def test_packed_norm_matches_pallas_kernel(J, rows, d, block_rows, dtype):
    x_np, w_np = _arrays(J + rows + d, (J, rows, d), (J, d))
    (jx, jw), (x, w) = _both([x_np, 1.0 + 0.1 * w_np], dtype)
    expect = j_packed_rmsnorm(jx, jw, block_rows=block_rows, interpret=True)
    out = ops.packed_norm(x, w)
    assert out.dtype == x.dtype and out.shape == x.shape
    np.testing.assert_allclose(_np(out), _np(expect), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(16, 32), (3, 20, 48), (2, 5, 7, 128)])
def test_fused_rmsnorm_matches_pallas_kernel(shape, dtype):
    x_np, w_np = _arrays(sum(shape), shape, shape[-1:])
    (jx, jw), (x, w) = _both([x_np, 1.0 + 0.1 * w_np], dtype)
    expect = j_fused_rmsnorm(jx, jw, block_rows=8, interpret=True)
    out = rn.fused_rmsnorm(x, w)
    assert out.dtype == x.dtype and out.shape == x.shape
    np.testing.assert_allclose(_np(out), _np(expect), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_lane_equals_fused_on_its_slice(dtype):
    """B2's contract: an active lane equals B5 on the same slice bit for
    bit (fused_rmsnorm.py:80-86)."""
    x_np, w_np = _arrays(8, (4, 24, 96), (4, 96))
    _, (x, w) = _both([x_np, 1.0 + 0.1 * w_np], dtype)
    active = torch.tensor([1, 1, 0, 1])
    out = ops.packed_norm(x, w, active=active)
    for j in range(4):
        if active[j]:
            assert torch.equal(out[j], rn.fused_rmsnorm(x[j], w[j]))


@given_cases(n=8, seed=17)
def test_masked_ops_random_occupancy(rng):
    """tests/test_kernels.py::test_masked_ops_random_occupancy on the port,
    for both packed ops: inactive lanes are zeros, active lanes equal the
    dense run."""
    J = int(rng.choice([2, 4, 8]))
    M = int(rng.choice([16, 32, 48]))
    K = int(rng.choice([16, 32]))
    N = int(rng.choice([16, 32]))
    mask = rng.integers(0, 2, size=J)
    if mask.sum() == 0:
        mask[int(rng.integers(0, J))] = 1
    x, w, g = (torch.from_numpy(a) for a in _arrays(
        int(rng.integers(1 << 30)), (J, M, K), (J, K, N), (J, K)))
    _assert_masked(ops.packed_matmul(x, w, active=mask),
                   ops.packed_matmul(x, w), mask)
    _assert_masked(ops.packed_norm(x, g, active=mask), ops.packed_norm(x, g),
                   mask)


# ---------------------------------------------------------------------------
# no fallback, no backward
# ---------------------------------------------------------------------------

def _gemm_cuda_on_cpu():
    x = torch.zeros(2, 8, 8)
    pg.packed_gemm_cuda(x, x)


def _gemm_on_meta():
    x = torch.zeros(2, 8, 8, device="meta")
    ops.packed_matmul(x, x)


def _packed_norm_cuda_on_cpu():
    rn.packed_rmsnorm_cuda(torch.zeros(2, 4, 8), torch.ones(2, 8))


def _fused_norm_cuda_on_cpu():
    rn.fused_rmsnorm_cuda(torch.zeros(4, 8), torch.ones(8))


def _norm_on_meta():
    ops.packed_norm(torch.zeros(2, 4, 8, device="meta"),
                    torch.ones(2, 8, device="meta"))


def _gemm_cuda_with_grad():
    x = torch.zeros(2, 8, 8, requires_grad=True)
    pg.packed_gemm_cuda(x, x.detach())


def _norm_cuda_with_grad():
    rn.packed_rmsnorm_cuda(torch.zeros(2, 4, 8),
                           torch.ones(2, 8, requires_grad=True))


@pytest.mark.parametrize("call,exc,match", [
    (_gemm_cuda_on_cpu, ValueError, "CUDA device"),
    (_gemm_on_meta, ValueError, "no kernel"),
    (_packed_norm_cuda_on_cpu, ValueError, "CUDA device"),
    (_fused_norm_cuda_on_cpu, ValueError, "CUDA device"),
    (_norm_on_meta, ValueError, "no kernel"),
    (_gemm_cuda_with_grad, RuntimeError, "no backward"),
    (_norm_cuda_with_grad, RuntimeError, "no backward"),
])
def test_kernel_wrappers_raise_instead_of_falling_back(call, exc, match):
    """A CUDA wrapper handed tensors it cannot take, or inputs that need a
    gradient it does not have, raises; nothing runs quietly elsewhere."""
    with pytest.raises(exc, match=match):
        call()


# ---------------------------------------------------------------------------
# build rules
# ---------------------------------------------------------------------------

def test_every_source_is_built():
    assert set(_build.SOURCES) == {p.stem for p in _build.CSRC.glob("*.cu")}
    assert {"packed_gemm", "rmsnorm", "flash_attention"} <= set(
        _build.SOURCES)


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """An edited header rebuilds every library that includes it, directly
    or through another header, and no other."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "a.cuh").write_text("// a\n")
    (tmp_path / "b.cuh").write_text('#include "a.cuh"\n')
    (tmp_path / "uses_b.cu").write_text('#include <cuda_runtime.h>\n'
                                        '  #include "b.cuh"\nint x;\n')
    (tmp_path / "plain.cu").write_text("int y;\n")
    before = {n: _build.library_path(n) for n in ("uses_b", "plain")}
    (tmp_path / "a.cuh").write_text("// a, edited\n")
    after = {n: _build.library_path(n) for n in ("uses_b", "plain")}
    assert after["uses_b"] != before["uses_b"]
    assert after["plain"] == before["plain"]


def test_entry_binds_each_c_function_once(monkeypatch):
    """A wrapper asks ``_build.entry`` for its C function on every launch;
    the function is looked up and its argument types set only the first
    time."""
    libs = {}
    monkeypatch.setattr(_build, "load", lambda name: libs.setdefault(
        name, types.SimpleNamespace(fn=types.SimpleNamespace())))
    monkeypatch.setattr(_build, "_ENTRIES", {})
    first = _build.entry("a", "fn", [ctypes.c_void_p, ctypes.c_int])
    assert first.argtypes == [ctypes.c_void_p, ctypes.c_int]
    assert first.restype is ctypes.c_int
    first.argtypes = "bound"
    again = _build.entry("a", "fn", [ctypes.c_void_p, ctypes.c_int])
    assert again is first and again.argtypes == "bound"
    assert _build.entry("b", "fn", []) is not first


def test_shipped_sources_include_the_shared_header():
    for name in _build.SOURCES:
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "dtype.cuh"' in text, name
