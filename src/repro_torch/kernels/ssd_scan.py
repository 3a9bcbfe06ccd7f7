"""Mamba2 SSD chunked scan: the Hopper kernel's wrapper and its plain version.

Port of ``repro.kernels.ssd_scan.ssd_scan`` (the Pallas TPU kernel). The
kernel is ``csrc/ssd_scan.cu`` (CUDA C++, sm_90a), built at first use by
``_build`` and called through ctypes: one call of its C entry launches three
CUDA kernels on the current stream, chunk-parallel (each chunk's log decays,
state contribution and, once per chunk, C·Bᵀ; the state carried across the
chunks; each chunk's y), with the products on the tensor cores. ``plan``
asks the source for a call's scratch size, shared memory and CTAs per SM;
the source says what bounds the kernel and how it is laid out. ``ssd_scan_plain`` computes the
same function in plain PyTorch (``models.ssm.ssd_chunked``, the reference's
own chunked path, then the lane mask): the CPU path and the tests use it,
and the card compares the kernel against it.

Contract (both versions): x (b,S,nh,hd), dt (b,S,nh), A (nh,), B/C (b,S,N)
-> (y (b,S,nh,hd) in x.dtype, final state (b,nh,hd,N) f32), everything
computed in f32, from ``init_state`` (b,nh,hd,N) or, when it is None, from a
zero state as the TPU kernel always starts; the chunk is ``min(chunk, S)``
and must divide S. ``active`` (b,) makes inactive lanes exact zeros in y and
in the state and leaves active lanes bit-identical to the call without it. x, B
and C may be strided views with a contiguous last dim (the model passes
slices of one conv output). The kernel has no backward: the CUDA wrapper
raises rather than return a result cut off from autograd.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mask_lanes

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the body by dtype (one source, csrc/ssd_scan.cu): bf16 operands go to the
# tensor cores as they are, f32 operands as three bf16 pieces each
_BODY = {torch.bfloat16: "bf16", torch.float32: "f32_split3"}
_F32 = torch.float32
_MAX_GRID_YZ = 65535
_SCALAR = ctypes.c_int(0)    # set by each call of the C entry
_SCALAR_PTR = ctypes.addressof(_SCALAR)


@dataclasses.dataclass(frozen=True)
class Plan:
    """One call's needs, as ``repro_ssd_scan_plan`` in csrc/ssd_scan.cu
    computes them: the f32 scratch (log decays, C·Bᵀ per chunk, each
    chunk's state) in floats, each CTA's dynamic shared memory in bytes and
    the CTAs one SM holds, by kernel ("chunk", "out"), and the most shared
    memory one CTA may take on the device."""
    scratch_floats: int
    smem: dict
    ctas_per_sm: dict
    max_smem: int


@functools.lru_cache(maxsize=64)
def plan(b: int, S: int, nh: int, hd: int, N: int, Q: int, dtype,
         device: int) -> Plan:
    """The plan of a call with chunk ``Q`` (already ``min(chunk, S)``) on
    CUDA device ``device``; raises ValueError for a shape the kernels do
    not take."""
    out = (ctypes.c_longlong * 6)()
    with torch.cuda.device(device):
        err = _bind_plan()(b, S, nh, hd, N, Q, _DTYPE_CODE[dtype], out)
    if err == 1 and out[3]:          # cudaErrorInvalidValue: the memory
        raise ValueError(f"ssd_scan_cuda: chunk {Q}, head dim {hd} and "
                         f"state dim {N} in {dtype} need {max(out[1:3])} "
                         f"bytes of shared memory (at most {out[3]})")
    if err != 0:
        raise ValueError(f"ssd_scan_cuda: the kernels do not take (b, S, "
                         f"nh, hd, N, chunk) = {(b, S, nh, hd, N, Q)} in "
                         f"{dtype}: the chunk is at most 128 (CUDA error "
                         f"{err})")
    return Plan(scratch_floats=out[0], smem={"chunk": out[1], "out": out[2]},
                ctas_per_sm={"chunk": out[4], "out": out[5]},
                max_smem=out[3])


def ssd_scan_plain(x, dt, A, B, C, *, chunk: int = 128, active=None,
                   init_state=None):
    """The kernel's function in plain PyTorch, f32 inside."""
    from repro_torch.models.ssm import ssd_chunked
    y, state = ssd_chunked(x, dt, A, B, C, chunk=chunk, init_state=init_state)
    if active is None:
        return y, state
    return mask_lanes(active, y), mask_lanes(active, state)


def _bind():
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    return _build.entry("ssd_scan", "repro_ssd_scan",
                        [p] * 10 + [i] * 6 + [ll] * 14 + [i, p, p])


def _bind_plan():
    i = ctypes.c_int
    return _build.entry("ssd_scan", "repro_ssd_scan_plan",
                        [i] * 7 + [ctypes.POINTER(ctypes.c_longlong)])


def _check(x, dt, A, B, C, chunk: int, init_state):
    given = (x, dt, A, B, C) + (() if init_state is None else (init_state,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in given):
        raise RuntimeError("ssd_scan_cuda has no backward: call it under "
                           "torch.no_grad() or on tensors that do not "
                           "require grad")
    for name, t in zip(("x", "dt", "A", "B", "C", "init_state"), given):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"ssd_scan_cuda: {name} must be on x's CUDA "
                             f"device, got {t.device}")
        if any(s < 0 for s in t.stride()):
            raise ValueError(f"ssd_scan_cuda: {name} has a negative stride")
    if x.dtype not in _DTYPE_CODE or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"ssd_scan_cuda: x, B, C must share a dtype in "
                         f"{tuple(_DTYPE_CODE)}, got {x.dtype}, {B.dtype}, "
                         f"{C.dtype}")
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 3 \
            or C.dim() != 3:
        raise ValueError("ssd_scan_cuda: want x (b,S,nh,hd), dt (b,S,nh), "
                         "A (nh,), B/C (b,S,N)")
    b, S, nh, hd = x.shape
    N = B.shape[-1]
    if tuple(dt.shape) != (b, S, nh) or tuple(A.shape) != (nh,) \
            or tuple(B.shape) != (b, S, N) or tuple(C.shape) != (b, S, N):
        raise ValueError(f"ssd_scan_cuda: shapes x {tuple(x.shape)} dt "
                         f"{tuple(dt.shape)} A {tuple(A.shape)} B "
                         f"{tuple(B.shape)} C {tuple(C.shape)} disagree")
    if init_state is not None and tuple(init_state.shape) != (b, nh, hd, N):
        raise ValueError(f"ssd_scan_cuda: init_state "
                         f"{tuple(init_state.shape)} is not (b, nh, hd, N) "
                         f"= {(b, nh, hd, N)}")
    if min(b, S, nh, hd, N, chunk) <= 0:
        raise ValueError("ssd_scan_cuda: empty input or chunk < 1")
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"ssd_scan: seq {S} % chunk {Q} != 0")
    if x.stride(-1) != 1 or B.stride(-1) != 1 or C.stride(-1) != 1:
        raise ValueError("ssd_scan_cuda: x, B, C need a contiguous last dim")
    if hd % 4 or N % 4:
        raise ValueError(f"ssd_scan_cuda: head dim {hd} and state dim {N} "
                         f"must be multiples of 4")
    if b > _MAX_GRID_YZ or nh > _MAX_GRID_YZ:
        raise ValueError(f"ssd_scan_cuda: batch {b} or heads {nh} exceed "
                         f"the grid")
    dev = x.device.index
    return plan(b, S, nh, hd, N, Q, x.dtype,
                torch.cuda.current_device() if dev is None else dev)


def ssd_scan_cuda(x, dt, A, B, C, *, chunk: int = 128, active=None,
                  init_state=None):
    """Launch the Hopper kernels on CUDA tensors (raises on anything else).
    dt, A and ``init_state`` are cast to f32 here when they come in another
    dtype (the TPU kernel casts dt and A on load), and ``init_state`` is
    made contiguous. ``ssd_scan_cuda.launches`` counts the calls,
    ``launches_by_body`` splits them by body and ``scalar_reads`` the calls
    in which the C entry found x, B or C rows it could not copy 16 bytes at
    a time."""
    _build.reject_dtensor("ssd_scan_cuda", x, dt, A, B, C, init_state)
    pl = _check(x, dt, A, B, C, chunk, init_state)
    fn = _bind()
    b, S, nh, hd = x.shape
    N = B.shape[-1]
    dt, A = dt.to(_F32), A.to(_F32)
    init = None if init_state is None else init_state.to(_F32).contiguous()
    act = None
    if active is not None:
        act = torch.as_tensor(active, device=x.device).to(torch.int32)
        if act.numel() != b:
            raise ValueError(f"ssd_scan_cuda: active has {act.numel()} "
                             f"entries for batch {b}")
        act = act.reshape(b).contiguous()
    y = torch.empty((b, S, nh, hd), dtype=x.dtype, device=x.device)
    state = torch.empty((b, nh, hd, N), dtype=_F32, device=x.device)
    scratch = torch.empty(pl.scratch_floats, dtype=_F32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                 C.data_ptr(), y.data_ptr(), state.data_ptr(),
                 None if init is None else init.data_ptr(),
                 None if act is None else act.data_ptr(),
                 scratch.data_ptr(), b, S, nh, hd, N, min(chunk, S),
                 *x.stride()[:3], *dt.stride(), A.stride(0),
                 *B.stride()[:2], *C.stride()[:2], *y.stride()[:3],
                 _DTYPE_CODE[x.dtype], _SCALAR_PTR,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_cuda: launch failed with CUDA error "
                           f"{err}")
    ssd_scan_cuda.launches += 1
    ssd_scan_cuda.launches_by_body[_BODY[x.dtype]] += 1
    ssd_scan_cuda.scalar_reads += _SCALAR.value
    return y, state


ssd_scan_cuda.launches = 0
ssd_scan_cuda.launches_by_body = {"bf16": 0, "f32_split3": 0}
ssd_scan_cuda.scalar_reads = 0


def ssd_scan(x, dt, A, B, C, *, chunk: int = 128, active=None,
             init_state=None):
    """The plain version for CPU tensors; the kernel for CUDA tensors (it
    launches or raises, never falls back)."""
    _build.reject_dtensor("ssd_scan", x, dt, A, B, C, init_state)
    kw = dict(chunk=chunk, active=active, init_state=init_state)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, **kw)
    if x.device.type == "cuda":
        return ssd_scan_cuda(x, dt, A, B, C, **kw)
    raise ValueError(f"ssd_scan: no kernel for device {x.device}")
