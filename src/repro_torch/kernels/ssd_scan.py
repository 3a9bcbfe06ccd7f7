"""Mamba2 SSD chunked scan: the Hopper kernel's wrapper and its plain version.

Port of ``repro.kernels.ssd_scan.ssd_scan`` (the Pallas TPU kernel). The
kernel is ``csrc/ssd_scan.cu`` (CUDA C++, sm_90a), built at first use by
``_build`` and called through ctypes; its source says what bounds it and
how it is laid out. ``ssd_scan_plain`` computes the same function in plain
PyTorch (``models.ssm.ssd_chunked``, the reference's own chunked path, then
the lane mask): the CPU path and the tests use it, and the card compares
the kernel against it.

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

import torch

from repro_torch.kernels.ref import mask_lanes

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_F32 = torch.float32
# the kernel's shared-memory plan (csrc/ssd_scan.cu, ``Layout``)
_MAX_CHUNK = 128
_ROW_BLOCK_LD = 36
_MAX_SMEM = 232_448
_MAX_GRID_Y = 65535


def ssd_scan_plain(x, dt, A, B, C, *, chunk: int = 128, active=None,
                   init_state=None):
    """The kernel's function in plain PyTorch, f32 inside."""
    from repro_torch.models.ssm import ssd_chunked
    y, state = ssd_chunked(x, dt, A, B, C, chunk=chunk, init_state=init_state)
    if active is None:
        return y, state
    return mask_lanes(active, y), mask_lanes(active, state)


def smem_bytes(Q: int, hd: int, N: int) -> int:
    """Dynamic shared memory of one CTA (``Layout`` in csrc/ssd_scan.cu):
    C and B of the chunk transposed (N rows of Q4 + 4), the dt-weighted x
    (Q4 x hd), one 32-row block of C·Bᵀ (Q4 x 36), the state (N x hd) and
    the log decays (Q4), all f32."""
    q4 = -(-Q // 4) * 4
    return 4 * (2 * N * (q4 + 4) + q4 * hd + q4 * _ROW_BLOCK_LD + N * hd + q4)


def _bind():
    from repro_torch.kernels import _build
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    return _build.entry("ssd_scan", "repro_ssd_scan",
                        [p] * 9 + [i] * 6 + [ll] * 14 + [i, p])


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
    if Q > _MAX_CHUNK or smem_bytes(Q, hd, N) > _MAX_SMEM:
        raise ValueError(f"ssd_scan_cuda: chunk {Q} (at most {_MAX_CHUNK}), "
                         f"head dim {hd} and state dim {N} need "
                         f"{smem_bytes(Q, hd, N)} bytes of shared memory "
                         f"(at most {_MAX_SMEM})")
    if b > _MAX_GRID_Y:
        raise ValueError(f"ssd_scan_cuda: batch {b} exceeds the grid")


def ssd_scan_cuda(x, dt, A, B, C, *, chunk: int = 128, active=None,
                  init_state=None):
    """Launch the Hopper kernel on CUDA tensors (raises on anything else).
    dt, A and ``init_state`` are cast to f32 here when they come in another
    dtype (the TPU kernel casts dt and A on load), and ``init_state`` is
    made contiguous. ``ssd_scan_cuda.launches`` counts the launches."""
    _check(x, dt, A, B, C, chunk, init_state)
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
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                 C.data_ptr(), y.data_ptr(), state.data_ptr(),
                 None if init is None else init.data_ptr(),
                 None if act is None else act.data_ptr(),
                 b, S, nh, hd, N, min(chunk, S),
                 *x.stride()[:3], *dt.stride(), A.stride(0),
                 *B.stride()[:2], *C.stride()[:2], *y.stride()[:3],
                 _DTYPE_CODE[x.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_cuda: launch failed with CUDA error "
                           f"{err}")
    ssd_scan_cuda.launches += 1
    return y, state


ssd_scan_cuda.launches = 0


def ssd_scan(x, dt, A, B, C, *, chunk: int = 128, active=None,
             init_state=None):
    """The plain version for CPU tensors; the kernel for CUDA tensors (it
    launches or raises, never falls back)."""
    kw = dict(chunk=chunk, active=active, init_state=init_state)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, **kw)
    if x.device.type == "cuda":
        return ssd_scan_cuda(x, dt, A, B, C, **kw)
    raise ValueError(f"ssd_scan: no kernel for device {x.device}")
