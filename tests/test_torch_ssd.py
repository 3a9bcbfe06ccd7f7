"""The SSD chunked scan (B4): the port's plain version and ``ops.ssd`` on the
CPU against the JAX Pallas kernel in interpret mode, the reference's
``ops.ssd`` and the recurrent oracle; the lane mask; the chunk rule; and the
no-fallback rule of the kernel's wrapper."""
import contextlib
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

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


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """csrc/ssd_plan.cuh built alone by the host C++ compiler: the sums the
    kernels launch with (shared memory, grids, scratch, 16-byte rows)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/ssd_plan.cuh")
    csrc = Path(sd.__file__).parent / "csrc"
    lib = tmp_path_factory.mktemp("ssd_plan") / "ssd_plan.so"
    subprocess.run([cxx, "-x", "c++", "-", "-std=c++17", "-O1", "-shared",
                    "-fPIC", "-I", str(csrc), "-o", str(lib)],
                   input=b'#include "ssd_plan.cuh"\n', check=True)
    lib = ctypes.CDLL(str(lib))
    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    lib.repro_ssd_scan_layout.argtypes = [i] * 7 + [ctypes.POINTER(ll)]
    lib.repro_ssd_scan_copyable.argtypes = [p] * 3 + [i] * 6 + [ll] * 7
    lib.repro_ssd_scan_layout.restype = i
    lib.repro_ssd_scan_copyable.restype = i
    return lib


def _layout(lib, b, S, nh, hd, N, Q, dtype) -> dict:
    out = (ctypes.c_longlong * 11)()
    assert lib.repro_ssd_scan_layout(b, S, nh, hd, N, Q,
                                     sd._DTYPE_CODE[dtype], out) == 0
    v = list(out)
    return {"scratch": {"la": v[0], "cb": v[1], "cs": v[2]},
            "grids": {"chunk": tuple(v[3:6]), "state": tuple(v[6:9]),
                      "out": tuple(v[3:6])},
            "smem": {"chunk": v[9], "out": v[10]}}


# an H100 SM's shared memory, the most one CTA may take, and what the card
# keeps for each resident CTA (CUDA C++ Programming Guide, compute 9.0)
SM_SMEM, CTA_MAX_SMEM, CTA_RESERVED = 233_472, 232_448, 1_024


def test_shared_memory_plan_fits_the_serving_shape(layout):
    """mamba2-130m's prefill (1, 1024, 24, 64), N = 128, chunk 128: the
    chunk and output kernels run one CTA per (chunk, head, batch), 192 CTAs
    for 132 SMs, each small enough in bf16 for two CTAs per SM; the state
    kernel covers 24 heads x 8192 entries, 4 per thread; the scratch is the
    log decays, C·Bᵀ once per chunk (512 KiB) and one (N, hd) f32 state per
    chunk and head (6.3 MB). In f32 (three bf16 pieces per operand) a CTA
    still fits, one per SM."""
    pl = _layout(layout, 1, 1024, 24, 64, 128, 128, torch.bfloat16)
    assert pl["grids"] == {"chunk": (8, 24, 1), "state": (8, 24, 1),
                           "out": (8, 24, 1)}
    assert np.prod(pl["grids"]["chunk"]) >= 132
    assert pl["scratch"] == {"la": 8 * 24 * 128, "cb": 8 * 128 * 128,
                             "cs": 8 * 24 * 128 * 64}
    assert 4 * pl["scratch"]["cb"] == 512 * 1024
    assert 4 * pl["scratch"]["cs"] == 6_291_456
    assert pl["smem"] == {"chunk": 109_568, "out": 109_568}
    assert all(SM_SMEM // (v + CTA_RESERVED) == 2
               for v in pl["smem"].values())
    f32 = _layout(layout, 1, 1024, 24, 64, 128, 128, torch.float32)
    assert max(f32["smem"].values()) <= CTA_MAX_SMEM
    assert SM_SMEM // (f32["smem"]["out"] + CTA_RESERVED) == 1


def test_plan_pads_ragged_chunks_and_bounds_shared_memory(layout):
    """A chunk of 9 (S = 9 < 32) or 10 is padded to 16 rows; the scratch
    keeps the padded decays. A head dim of 128 fits in bf16 but not in f32
    at chunk 128 and state 128, which the wrapper refuses; a chunk above
    128, or one that does not divide S, is no layout at all."""
    pl = _layout(layout, 2, 9, 3, 16, 16, 9, torch.float32)
    assert pl["grids"]["chunk"] == (1, 3, 2)
    assert pl["grids"]["state"] == (1, 3, 2)
    assert pl["scratch"]["la"] == 2 * 1 * 3 * 16
    assert pl["scratch"]["cb"] == 2 * 1 * 16 * 16
    assert _layout(layout, 1, 30, 2, 16, 16, 10, torch.float32)[
        "scratch"]["la"] == 1 * 3 * 2 * 16
    assert max(_layout(layout, 1, 1024, 24, 128, 128, 128, torch.bfloat16)
               ["smem"].values()) <= CTA_MAX_SMEM
    assert max(_layout(layout, 1, 1024, 24, 128, 128, 128, torch.float32)
               ["smem"].values()) > CTA_MAX_SMEM
    out = (ctypes.c_longlong * 11)()
    assert layout.repro_ssd_scan_layout(1, 256, 2, 16, 16, 256, 1, out) == 1
    assert layout.repro_ssd_scan_layout(1, 30, 2, 16, 16, 7, 1, out) == 1


def test_copyable_rows_of_the_models_views(layout):
    """The kernels copy x, B and C 16 bytes at a time when every row starts
    on a 16-byte boundary: contiguous tensors and mamba2-130m's views of one
    conv output do; a row offset by one element or a bf16 row of 4 values
    does not (those rows are read one element at a time)."""
    def copyable(x, B, C):
        b, S, nh, hd = x.shape
        return bool(layout.repro_ssd_scan_copyable(
            x.data_ptr(), B.data_ptr(), C.data_ptr(), b, S, nh, hd,
            B.shape[-1], x.element_size(), *x.stride()[:3],
            *B.stride()[:2], *C.stride()[:2]))

    b, S, nh, hd, N = 1, 64, 24, 64, 128
    xBC = torch.zeros(b, S, nh * hd + 2 * N, dtype=torch.bfloat16)
    x = xBC[..., :nh * hd].reshape(b, S, nh, hd)
    Bv, Cv = xBC[..., nh * hd:nh * hd + N], xBC[..., nh * hd + N:]
    assert x.stride(1) == 1792
    assert copyable(x, Bv, Cv)
    assert not copyable(x, xBC[..., 1:N + 1], Cv)
    small = torch.zeros(2, 8, 3, 4, dtype=torch.bfloat16)
    rows = torch.zeros(2, 8, 4, dtype=torch.bfloat16)
    assert not copyable(small, rows, rows)
    assert copyable(small.float(), rows.float(), rows.float())


def _c_params(src: str, symbol: str) -> list:
    decl = re.search(r'extern "C" int ' + symbol + r'\(([^)]*)\)', src)
    return [a.strip() for a in decl.group(1).split(",")]


# (C return code, out[0..5] the source fills in, the error expected)
PLAN_CASES = {
    "serving_shape": (0, (1_728_512, 109_568, 109_568, 232_448, 2, 2), None),
    "shared_memory": (1, (0, 216_064, 250_000, 232_448, 0, 0),
                      "250000 bytes of shared memory"),
    "refused_shape": (1, (0, 0, 0, 0, 0, 0), "chunk is at most 128"),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_reads_the_sources_plan(case, monkeypatch):
    """``plan`` takes a call's scratch size, shared memory and CTAs per SM
    from the C source's ``repro_ssd_scan_plan`` (the one place that lays
    the kernels out), through as many arguments as the source declares, and
    raises ValueError naming what the kernels refuse: too much shared memory
    for the device, or a shape (a chunk above 128)."""
    src = (Path(sd.__file__).parent / "csrc" / "ssd_scan.cu").read_text()
    rc, filled, error = PLAN_CASES[case]
    seen = []

    def fake(*args):
        seen.append(args)
        for k, v in enumerate(filled):
            args[-1][k] = v
        return rc

    monkeypatch.setattr(sd, "_bind_plan", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    sd.plan.cache_clear()
    try:
        if error is not None:
            with pytest.raises(ValueError, match=error):
                sd.plan(1, 1024, 24, 64, 128, 128, torch.float32, 0)
        else:
            pl = sd.plan(1, 1024, 24, 64, 128, 128, torch.bfloat16, 0)
            assert pl.scratch_floats == 1_728_512
            assert pl.smem == {"chunk": 109_568, "out": 109_568}
            assert pl.ctas_per_sm == {"chunk": 2, "out": 2}
            assert pl.max_smem == 232_448
    finally:
        sd.plan.cache_clear()
    assert len(seen) == 1
    assert len(seen[0]) == len(_c_params(src, "repro_ssd_scan_plan"))
    assert seen[0][6] == (1 if error is None else 0)


def test_launches_count_calls_and_the_entry_takes_every_argument(
        monkeypatch):
    """``launches`` counts wrapper calls (one per prefill layer),
    ``launches_by_body`` the body by dtype, ``scalar_reads`` the calls in
    which the C entry reports rows it could not copy 16 bytes at a time;
    the wrapper passes the C entry as many arguments as the source
    declares, one scratch of the plan's size among them, and no count of
    CUDA kernels (that is read from a trace on the card)."""
    src = (Path(sd.__file__).parent / "csrc" / "ssd_scan.cu").read_text()
    n_params = len(_c_params(src, "repro_ssd_scan"))
    seen = []
    scalar = iter((0, 0, 1))

    def fake(*args):
        seen.append(args)
        sd._SCALAR.value = next(scalar)
        return 0

    monkeypatch.setattr(sd, "_check", lambda *a: sd.Plan(
        scratch_floats=1234, smem={}, ctas_per_sm={}, max_smem=0))
    monkeypatch.setattr(sd, "_bind", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": 0})())
    sizes = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: sizes.append(a)
                        or empty(*a, **k))
    before = (sd.ssd_scan_cuda.launches,
              dict(sd.ssd_scan_cuda.launches_by_body),
              sd.ssd_scan_cuda.scalar_reads)
    _, tin = _both(_inputs(12, 2, 64, 3, 16, 16), "float32")
    sd.ssd_scan_cuda(*tin, chunk=32)
    xb = [t.to(torch.bfloat16) if t.dim() != 1 and i != 1 else t
          for i, t in enumerate(tin)]
    sd.ssd_scan_cuda(*xb, chunk=32)
    sd.ssd_scan_cuda(xb[0][..., :12], *xb[1:3], xb[3][..., :12],
                     xb[4][..., :12], chunk=32)
    assert len(seen) == 3 and {len(a) for a in seen} == {n_params}
    assert (1234,) in sizes
    assert sd.ssd_scan_cuda.launches == before[0] + 3
    assert not hasattr(sd.ssd_scan_cuda, "kernels")
    assert sd.ssd_scan_cuda.launches_by_body == {
        "bf16": before[1]["bf16"] + 2,
        "f32_split3": before[1]["f32_split3"] + 1}
    assert sd.ssd_scan_cuda.scalar_reads == before[2] + 1
    assert [a[-3] for a in seen] == [0, 1, 1]
