"""Packed multi-job GEMM: the Hopper kernel's wrapper and its plain version.

Port of ``repro.kernels.packed_gemm.packed_gemm`` (the Pallas TPU kernel):
K co-resident tasks' small matmuls run as ONE launch over a lane axis, the
paper's GPU sharing at the level of one kernel. The kernel is
``csrc/packed_gemm.cu`` (CUDA C++, sm_90a), built at first use by
``_build`` and called through ctypes; its source says what bounds it and
how it is laid out. ``packed_gemm_plain`` computes the same function in
plain PyTorch: the CPU path and the tests use it, and the card compares the
kernel against it.

Contract: x (J,M,K) @ w (J,K,N) -> (J,M,N) in x.dtype (float32 or
bfloat16), products accumulated in f32. ``active`` (J,) makes inactive
lanes exact zeros and leaves active lanes bit-identical to the call without
it. x and w may be any strided views (the gradient GEMM passes x^T). The
kernel has no backward: the kernel-mode pool step writes its gradient by
hand, as the reference's does, and the CUDA wrapper raises rather than
return a result cut off from autograd.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import mask_lanes, packed_gemm_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 64
_MAX_GRID_YZ = 65535


def packed_gemm_plain(x, w, *, active=None):
    """The kernel's function in plain PyTorch."""
    out = packed_gemm_ref(x, w)
    return out if active is None else mask_lanes(active, out)


def _bind():
    from repro_torch.kernels import _build
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    return _build.entry("packed_gemm", "repro_packed_gemm",
                        [p] * 4 + [i] * 4 + [ll] * 6 + [i, p])


def _check(x, w):
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("packed_gemm_cuda has no backward: call it under "
                           "torch.no_grad() or on tensors that do not "
                           "require grad")
    for name, t in (("x", x), ("w", w)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"packed_gemm_cuda: {name} must be on x's CUDA "
                             f"device, got {t.device}")
        if t.dim() != 3:
            raise ValueError(f"packed_gemm_cuda: {name} must be 3-D, got "
                             f"shape {tuple(t.shape)}")
        if any(s < 0 for s in t.stride()):
            raise ValueError(f"packed_gemm_cuda: {name} has a negative stride")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise ValueError(f"packed_gemm_cuda: x and w must share a dtype in "
                         f"{tuple(_DTYPE_CODE)}, got {x.dtype}, {w.dtype}")
    J, M, K = x.shape
    Jw, Kw, N = w.shape
    if Jw != J or Kw != K:
        raise ValueError(f"packed_gemm_cuda: shapes x {tuple(x.shape)} and "
                         f"w {tuple(w.shape)} disagree")
    if min(J, M, K, N) == 0:
        raise ValueError("packed_gemm_cuda: empty input")
    if J > _MAX_GRID_YZ or -(-M // _TILE) > _MAX_GRID_YZ:
        raise ValueError(f"packed_gemm_cuda: J={J} or M={M} exceeds the grid")


def packed_gemm_cuda(x, w, *, active=None):
    """Launch the Hopper kernel on CUDA tensors (raises on anything else).
    ``packed_gemm_cuda.launches`` counts the launches."""
    _check(x, w)
    fn = _bind()
    J, M, K = x.shape
    N = w.shape[2]
    act = None
    if active is not None:
        act = torch.as_tensor(active, device=x.device).to(torch.int32)
        if act.numel() != J:
            raise ValueError(f"packed_gemm_cuda: active has {act.numel()} "
                             f"entries for {J} lanes")
        act = act.reshape(J).contiguous()
    out = torch.empty((J, M, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                 None if act is None else act.data_ptr(),
                 J, M, N, K, *x.stride(), *w.stride(), _DTYPE_CODE[x.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"packed_gemm_cuda: launch failed with CUDA error "
                           f"{err}")
    packed_gemm_cuda.launches += 1
    return out


packed_gemm_cuda.launches = 0


def packed_gemm(x, w, *, active=None):
    """The plain version for CPU tensors; the kernel for CUDA tensors (it
    launches or raises, never falls back)."""
    if x.device.type == "cpu":
        return packed_gemm_plain(x, w, active=active)
    if x.device.type == "cuda":
        return packed_gemm_cuda(x, w, active=active)
    raise ValueError(f"packed_gemm: no kernel for device {x.device}")
