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

Two hand-written bodies, chosen by dtype (``gemm_body``): bf16 runs the
tensor-core body (``wgmma`` products fed by TMA), f32 the CUDA-core body
(the tensor cores take f32 only as TF32, which the port does not use).
``packed_gemm_cuda.launches_by_body`` counts each; ``launches`` is their
sum. The f32 body loads float4s along an operand's contiguous axis where
its base and other strides allow and scalars elsewhere (the kernel's entry
decides, per operand, from the strides and base it is given). The bf16 body
reads its operands through TMA tensor maps, which need a 16-byte aligned
base and strides of multiples of 16 bytes; ``wgmma_layout`` decides, from
shapes, strides and base alignment alone, how each operand is read, and an
operand TMA cannot describe is copied into a contiguous buffer whose
contiguous axis is zero-padded to a multiple of 8
(``packed_gemm_cuda.padded_copies`` counts the copies).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, tma
from repro_torch.kernels.ref import mask_lanes, packed_gemm_ref

_BODY = {torch.float32: "simt", torch.bfloat16: "wgmma"}
_TILE = 64
_MAX_GRID_YZ = 65535


def packed_gemm_plain(x, w, *, active=None):
    """The kernel's function in plain PyTorch."""
    out = packed_gemm_ref(x, w)
    return out if active is None else mask_lanes(active, out)


def gemm_body(dtype) -> str:
    """The hand-written body that takes ``dtype``: "wgmma" (tensor cores)
    for bfloat16, "simt" (CUDA cores) for float32; raises for any other."""
    body = _BODY.get(dtype)
    if body is None:
        raise ValueError(f"packed_gemm_cuda: no kernel body for dtype "
                         f"{dtype}; bodies take {tuple(_BODY)}")
    return body


def wgmma_layout(x_shape, x_stride, x_ptr: int, w_shape, w_stride,
                 w_ptr: int, itemsize: int = 2) -> tuple:
    """How the bf16 body reads x (J,M,K) and w (J,K,N), from shapes, element
    strides and base addresses alone: x as "k" (K contiguous), "m" (M
    contiguous, the gradient GEMM's x^T) or "copy"; w as "n" (N contiguous)
    or "copy". "copy" means TMA cannot describe the operand as it lies."""
    if tma.describable(x_shape, x_stride, 2, x_ptr, itemsize):
        xl = "k"
    elif tma.describable(x_shape, x_stride, 1, x_ptr, itemsize):
        xl = "m"
    else:
        xl = "copy"
    wl = ("n" if tma.describable(w_shape, w_stride, 2, w_ptr, itemsize)
          else "copy")
    return xl, wl


def padded_copy(t):
    """``t`` (J, R, C) as a new contiguous (J, R, C') tensor, C' = C rounded
    up to a multiple of 8, the extra columns zeros: a layout TMA takes."""
    J, R, C = t.shape
    out = t.new_zeros((J, R, -(-C // tma.MULTIPLE) * tma.MULTIPLE))
    out[..., :C] = t
    return out


def _bind(body: str):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    if body == "simt":
        return _build.entry("packed_gemm", "repro_packed_gemm",
                            [p] * 4 + [i] * 4 + [ll] * 6 + [p])
    return _build.entry("packed_gemm", "repro_packed_gemm_wgmma",
                        [p] * 4 + [i] * 4 + [ll, ll, i, ll] + [ll] * 3 + [p])


def launch_smem(body: str) -> int:
    """The dynamic shared memory, in bytes, that ``body``'s launch passes,
    asked of the library's own launch function (``repro_packed_gemm_smem``),
    which launches nothing for it."""
    if body not in ("simt", "wgmma"):
        raise ValueError(f"packed_gemm: no body {body!r}")
    smem = ctypes.c_int(0)
    fn = _build.entry("packed_gemm", "repro_packed_gemm_smem",
                      [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    err = fn(int(body == "wgmma"), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"packed_gemm: the library's size query failed "
                           f"(CUDA error {err})")
    return smem.value


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
    if w.dtype != x.dtype:
        raise ValueError(f"packed_gemm_cuda: x and w must share a dtype, got "
                         f"{x.dtype}, {w.dtype}")
    gemm_body(x.dtype)
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
    """Launch the Hopper kernel on CUDA tensors (raises on anything else):
    the wgmma body for bf16, the simt body for f32.
    ``packed_gemm_cuda.launches`` counts the launches,
    ``launches_by_body`` splits them by body, and ``padded_copies`` counts
    the operands the bf16 body had to copy (``wgmma_layout``)."""
    _build.reject_dtensor("packed_gemm_cuda", x, w)
    _check(x, w)
    body = gemm_body(x.dtype)
    fn = _bind(body)
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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    act_ptr = None if act is None else act.data_ptr()
    with torch.cuda.device(x.device):
        if body == "simt":
            err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), act_ptr,
                     J, M, N, K, *x.stride(), *w.stride(), stream)
        else:
            xl, wl = wgmma_layout(x.shape, x.stride(), x.data_ptr(),
                                  w.shape, w.stride(), w.data_ptr(),
                                  x.element_size())
            if xl == "copy":
                x, xl = padded_copy(x), "k"
                packed_gemm_cuda.padded_copies += 1
            if wl == "copy":
                w = padded_copy(w)
                packed_gemm_cuda.padded_copies += 1
            x_sj, x_sm, x_sk = tma.map_strides(x.shape, x.stride())
            w_sj, w_sk, _ = tma.map_strides(w.shape, w.stride())
            if xl == "k":
                x_outer, x_inner = x_sm, x.shape[2]
            else:
                x_outer, x_inner = x_sk, M
            err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), act_ptr,
                     J, M, N, K, x_sj, x_outer, int(xl == "m"), x_inner,
                     w_sj, w_sk, w.shape[2], stream)
    if err != 0:
        what = ("tensor map refused (CUresult %d)" % -err if err < 0
                else "CUDA error %d" % err)
        raise RuntimeError(f"packed_gemm_cuda: launch failed: {what}")
    packed_gemm_cuda.launches_by_body[body] += 1
    packed_gemm_cuda.launches += 1
    return out


packed_gemm_cuda.launches = 0
packed_gemm_cuda.launches_by_body = {"wgmma": 0, "simt": 0}
packed_gemm_cuda.padded_copies = 0


def packed_gemm(x, w, *, active=None):
    """The plain version for CPU tensors; the kernel for CUDA tensors (it
    launches or raises, never falls back)."""
    _build.reject_dtensor("packed_gemm", x, w)
    if x.device.type == "cpu":
        return packed_gemm_plain(x, w, active=active)
    if x.device.type == "cuda":
        return packed_gemm_cuda(x, w, active=active)
    raise ValueError(f"packed_gemm: no kernel for device {x.device}")
