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
import re
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
from repro_torch.kernels import tma
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
    """Every source includes dtype.cuh, and every source that uses TMA or
    wgmma takes them from tma.cuh (whose edits then rebuild it)."""
    assert {"packed_gemm", "flash_attention"} <= set(_build.SOURCES)
    for name in _build.SOURCES:
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "dtype.cuh"' in text, name
        uses_tma = any(word in text for word in (
            "CUtensorMap", "tma_load", "wgmma_", "mbar_"))
        assert uses_tma == ('#include "tma.cuh"' in text), name
        assert uses_tma == (name in ("packed_gemm", "flash_attention")), name
        assert "cp.async.bulk.tensor" not in text, name
    header = (_build.CSRC / "tma.cuh").read_text()
    for helper in ("cuTensorMapEncodeTiled", "cp.async.bulk.tensor",
                   "mbarrier.try_wait.parity", "wgmma.fence",
                   "m64n256k16", "m64n128k16",
                   "m64n64k16", "setmaxnreg"):
        assert helper in header, helper


# ---------------------------------------------------------------------------
# B1's bodies and the bf16 body's operand layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,body", [(torch.bfloat16, "wgmma"),
                                        (torch.float32, "simt"),
                                        (torch.float16, None),
                                        (torch.float64, None)])
def test_gemm_body_by_dtype(dtype, body):
    """bf16 runs the tensor-core body, f32 the CUDA-core body (no TF32);
    any other dtype has no body and raises."""
    if body is None:
        with pytest.raises(ValueError, match="no kernel body"):
            pg.gemm_body(dtype)
    else:
        assert pg.gemm_body(dtype) == body
    assert set(pg.packed_gemm_cuda.launches_by_body) == {"wgmma", "simt"}


def _unaligned(shape, dtype=torch.bfloat16):
    """A contiguous tensor whose storage starts one element past a 16-byte
    boundary."""
    n = int(np.prod(shape))
    t = torch.zeros(n + 1, dtype=dtype)[1:].view(*shape)
    assert t.data_ptr() % 16 == t.element_size()
    return t


def _layout(x, w):
    return pg.wgmma_layout(x.shape, x.stride(), x.data_ptr(), w.shape,
                           w.stride(), w.data_ptr(), x.element_size())


@pytest.mark.parametrize("case,want", [
    ("contiguous", ("k", "n")),
    ("pool_shape", ("k", "n")),
    ("gradient_xT", ("m", "n")),
    ("K70", ("copy", "copy")),
    ("unaligned_offset", ("copy", "copy")),
    ("w_transposed", ("k", "copy")),
])
def test_wgmma_layout_decision(case, want):
    """How the bf16 body reads each operand, from shapes, strides and base
    alignment: K-major or M-major x, N-major w, or a padded copy."""
    bf16 = torch.bfloat16
    if case == "contiguous":
        x, w = torch.zeros(4, 64, 64, dtype=bf16), torch.zeros(4, 64, 64,
                                                                dtype=bf16)
    elif case == "pool_shape":
        x, w = torch.zeros(16, 256, 256, dtype=bf16), torch.zeros(
            16, 256, 256, dtype=bf16)
    elif case == "gradient_xT":
        x = torch.zeros(16, 256, 128, dtype=bf16).transpose(1, 2)
        w = torch.zeros(16, 256, 64, dtype=bf16)
    elif case == "K70":
        x, w = torch.zeros(3, 50, 70, dtype=bf16), torch.zeros(3, 70, 30,
                                                               dtype=bf16)
    elif case == "unaligned_offset":
        x, w = _unaligned((4, 64, 64)), _unaligned((4, 64, 64))
    else:
        x = torch.zeros(4, 64, 64, dtype=bf16)
        w = torch.zeros(4, 64, 64, dtype=bf16).transpose(1, 2)
    assert _layout(x, w) == want


def test_wgmma_layout_at_the_mlp_shape():
    """Contiguous operands of one StableLM-2 MLP up-projection per lane
    (shapes and strides only) need no copy."""
    J, M, K, N = 4, 512, 2048, 5632
    assert pg.wgmma_layout((J, M, K), (M * K, K, 1), 0, (J, K, N),
                           (K * N, N, 1), 1 << 20) == ("k", "n")


def test_wgmma_layout_ignores_strides_of_length_one_axes():
    """An axis of length 1 is never stepped over, so its stride does not
    decide the layout; ``tma.map_strides`` gives it one a map takes."""
    got = pg.wgmma_layout((1, 16, 16), (3, 16, 1), 0, (1, 16, 16),
                          (5, 16, 1), 0)
    assert got == ("k", "n")
    strides = tma.map_strides((1, 16, 16), (3, 16, 1))
    assert strides[1:] == (16, 1)
    assert strides[0] % 8 == 0 and strides[0] >= 16 * 16


@pytest.mark.parametrize("J,M,K,N", [(3, 50, 70, 30), (1, 16, 9, 5),
                                     (2, 8, 64, 24)])
def test_padded_copy_round_trip(J, M, K, N):
    """The zero-padded copy cut back equals its input; its extra columns
    are zeros; the plain product of padded operands equals the unpadded
    one (zero products add exact zeros)."""
    x_np, w_np = _arrays(J + M + K + N, (J, M, K), (J, K, N))
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(x_np).to(dtype)
        w = torch.from_numpy(w_np).to(dtype)
        xp, wp = pg.padded_copy(x), pg.padded_copy(w)
        assert xp.is_contiguous() and xp.shape[2] % 8 == 0
        assert xp.shape[2] - K < 8 and wp.shape[2] - N < 8
        assert torch.equal(xp[..., :K], x) and torch.equal(wp[..., :N], w)
        assert not xp[..., K:].any() and not wp[..., N:].any()
        assert _layout(xp.to(torch.bfloat16), wp.to(torch.bfloat16)) == (
            "k", "n")
        w_rows = torch.nn.functional.pad(wp, (0, 0, 0, xp.shape[2] - K))
        got = pg.packed_gemm_plain(xp, w_rows)[..., :N]
        np.testing.assert_allclose(_np(got), _np(pg.packed_gemm_plain(x, w)),
                                   **TOL[str(dtype).split(".")[1]])


# ---------------------------------------------------------------------------
# B1's f32 body: operand layouts; B2/B5: the row routine per d and dtype
# ---------------------------------------------------------------------------

def _view(case, seed):
    """x (J,M,K) and w (J,K,N) in one of the layouts the f32 body reads
    differently (K-major or M-/N-major, float4 or scalar loads), filled
    from a seed."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    if case == "contiguous":
        return r(4, 64, 64), r(4, 64, 64)
    if case == "x_transposed":                  # the gradient GEMM's x^T
        return r(4, 64, 64).transpose(1, 2), r(4, 64, 64)
    if case == "w_transposed":
        return r(4, 64, 64), r(4, 64, 64).transpose(1, 2)
    if case == "both_transposed":
        return r(3, 40, 24).transpose(1, 2), r(3, 16, 40).transpose(1, 2)
    if case == "K70_N30":                       # rows of 70 and 30 floats
        return r(3, 50, 70), r(3, 70, 30)
    if case == "K32_N16":                       # tests/test_kernels.py:135
        return r(2, 128, 32), r(2, 32, 16)
    if case == "unaligned_offset":
        x, w = _unaligned((4, 64, 64), torch.float32), _unaligned(
            (4, 64, 64), torch.float32)
        return x.copy_(r(4, 64, 64)), w.copy_(r(4, 64, 64))
    return r(4, 64, 128)[..., ::2], r(4, 64, 128)[..., ::2]   # strided


@pytest.mark.parametrize("case", [
    "contiguous", "x_transposed", "w_transposed", "both_transposed",
    "K70_N30", "K32_N16", "unaligned_offset", "strided_rows"])
def test_packed_matmul_operand_layouts(case):
    """``ops.packed_matmul`` on views in every layout the f32 body tells
    apart, without copies, against the Pallas kernel on contiguous
    copies."""
    x, w = _view(case, len(case))
    expect = j_packed_gemm(jnp.asarray(x.contiguous().numpy()),
                           jnp.asarray(w.contiguous().numpy()), block_m=32,
                           block_n=32, block_k=32, interpret=True)
    out = ops.packed_matmul(x, w)
    assert out.shape == (x.shape[0], x.shape[1], w.shape[2])
    np.testing.assert_allclose(_np(out), _np(expect), **TOL["float32"])


def test_packed_matmul_length_one_axes_with_odd_strides():
    """One lane, or one row, is never stepped over: operands whose
    length-1 axes carry odd strides give the reference's result."""
    g = torch.Generator().manual_seed(7)
    buf = torch.randn(4096, generator=g)
    for x, w in ((buf.as_strided((1, 16, 16), (3, 16, 1)),
                  buf[1000:].as_strided((1, 16, 8), (5, 8, 1))),
                 (buf.as_strided((2, 1, 16), (16, 5, 1)),
                  buf[2000:].as_strided((2, 16, 8), (128, 8, 1)))):
        expect = j_packed_gemm(jnp.asarray(x.contiguous().numpy()),
                               jnp.asarray(w.contiguous().numpy()),
                               block_m=16, block_n=16, block_k=16,
                               interpret=True)
        np.testing.assert_allclose(_np(ops.packed_matmul(x, w)),
                                   _np(expect), **TOL["float32"])


def test_simt_modes_match_the_kernel():
    """The f32 entry point decides each operand's read mode itself, from
    the strides and base it is given, and takes as many arguments as its
    binding gives."""
    src = (_build.CSRC / "packed_gemm.cu").read_text()
    assert "constexpr int K_FAST = 1;" in src
    assert "constexpr int VEC4 = 2;" in src
    assert "p.x_mode = simt::operand_mode(p.x, J, M, K," in src
    assert "p.w_mode = simt::operand_mode(p.w, J, N, K," in src
    sig = src[src.index('extern "C" int repro_packed_gemm('):]
    sig = sig[:sig.index(")")]
    assert sig.count(",") + 1 == 4 + 4 + 6 + 1


# every d and dtype that chip_smoke's [kernel] phase and the reference tests
# use, odd d, and the cut-over to the two-read routine
@pytest.mark.parametrize("d,dtype,want", [
    (32, "float32", 1), (32, "bfloat16", 1),
    (48, "float32", 1), (100, "float32", 1), (100, "bfloat16", 1),
    (128, "float32", 1), (128, "bfloat16", 1),
    (130, "float32", 2), (130, "bfloat16", 1),
    (256, "float32", 2), (256, "bfloat16", 1),
    (1000, "bfloat16", 4),
    (1024, "float32", 8), (1025, "float32", 0),
    (2047, "bfloat16", 8), (2048, "bfloat16", 8), (2049, "bfloat16", 0),
    (2048, "float32", 0), (4096, "float32", 0), (4096, "bfloat16", 0),
])
def test_row_vectors(d, dtype, want):
    """The register routine's vectors per lane: the least power of two
    whose 32 lanes of 16-byte vectors cover the row, up to 8; 0 (two
    reads) past that."""
    dt = getattr(torch, dtype)
    got = rn.row_vectors(d, dt)
    assert got == want
    per_vector = 16 // dt.itemsize
    if got:
        assert 32 * per_vector * got >= d > 32 * per_vector * got // 2 \
            or got == 1
    else:
        assert d > 32 * per_vector * rn.MAX_ROW_VECTORS


def test_row_vectors_are_instantiated():
    """Every count ``row_vectors`` can give has a case in the kernel's
    dispatch, and the two entry points take the count."""
    src = (_build.CSRC / "rmsnorm.cu").read_text()
    cases = {int(c) for c in re.findall(r"case (\d+): err = launch<T, \1>",
                                         src)}
    counts = {rn.row_vectors(d, dt) for d in range(1, 9000, 7)
              for dt in (torch.float32, torch.bfloat16)}
    assert counts == cases == {0, 1, 2, 4, 8}
    for name, n_args in (("repro_fused_rmsnorm", 9),
                         ("repro_packed_rmsnorm", 11)):
        sig = src[src.index(f'extern "C" int {name}('):]
        assert sig[:sig.index(")")].count(",") + 1 == n_args, name


def test_kernel_resources_reads_ptxas_output():
    """chip_smoke's [build] lines: registers and spills per entry function
    of an ``nvcc -Xptxas -v`` log (read by the kernel report, whose spill
    counts are integers)."""
    from repro_torch.analysis.kernel_report import kernel_resources
    log = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z1av' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1av\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 151 registers, used 1 barriers, 25600 bytes\n"
        "ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1bv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 36 registers, used 0 barriers\n")
    rows = kernel_resources(log)
    assert [r[1:] for r in rows] == [(151, 8, 4), (36, 0, 0)]
    assert rows[0][0] in ("_Z1av", "a()")
