"""RMSNorm kernels: the Hopper kernels' wrappers and their plain versions.

Ports of ``repro.kernels.fused_rmsnorm.fused_rmsnorm`` (row RMSNorm over the
flattened leading dims, weight (d,)) and ``packed_rmsnorm`` (the
lane-batched variant: x (J, rows, d), per-lane weights (J, d), optional
per-lane ``active``), the two Pallas TPU kernels. Both kernels are in
``csrc/rmsnorm.cu`` (CUDA C++, sm_90a) and call one ``__device__`` routine
per row, so an active lane of ``packed_rmsnorm`` equals ``fused_rmsnorm``
on the same slice bit for bit, as the reference's contract asks. The plain
versions compute the same functions in plain PyTorch (the reference's
``models.layers.rms_norm``): the CPU path and the tests use them, and the
card compares the kernels against them.

Each warp holds its row in registers, ``row_vectors(d, dtype)`` 16-byte
vectors per lane (a power of two up to ``MAX_ROW_VECTORS``); a longer row
is read twice instead (``row_vectors`` gives 0). Both kernels take the
same count for the same d and dtype, so they run the same routine.

Contract: f32 statistics, out = x * rsqrt(mean(x^2) + eps) * w rounded once
to x.dtype (float32 or bfloat16; w has x's dtype). Inactive lanes are exact
zeros. The kernels have no backward; their CUDA wrappers raise rather than
return a result cut off from autograd.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mask_lanes

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535
# the largest register routine of csrc/rmsnorm.cu (instantiated for 1, 2,
# 4 and 8 vectors per lane)
MAX_ROW_VECTORS = 8


def row_vectors(d: int, dtype) -> int:
    """16-byte vectors each of a warp's 32 lanes holds for a row of ``d``
    elements of ``dtype``: the least power of two whose 32 lanes cover the
    row, or 0 past ``MAX_ROW_VECTORS`` (the row is then read twice)."""
    per_vector = 16 // dtype.itemsize
    need = -(-d // (32 * per_vector))
    vpl = 1
    while vpl < need:
        vpl *= 2
    return vpl if vpl <= MAX_ROW_VECTORS else 0


def fused_rmsnorm_plain(x, w, *, eps: float = 1e-5):
    """Row RMSNorm in plain PyTorch (``models.layers.rms_norm``'s math)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def packed_rmsnorm_plain(x, w, *, active=None, eps: float = 1e-5):
    """Lane-batched RMSNorm in plain PyTorch: lane j of x with w[j]."""
    out = fused_rmsnorm_plain(x, w[:, None, :], eps=eps)
    return out if active is None else mask_lanes(active, out)


def _bind(packed: bool):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if packed:
        return _build.entry("rmsnorm", "repro_packed_rmsnorm",
                            [p] * 4 + [i] * 3 + [f, i, i, p])
    return _build.entry("rmsnorm", "repro_fused_rmsnorm",
                        [p] * 3 + [i] * 2 + [f, i, i, p])


def _check(name, x, w, w_shape):
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError(f"{name} has no backward: call it under "
                           f"torch.no_grad() or on tensors that do not "
                           f"require grad")
    for label, t in (("x", x), ("w", w)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name}: {label} must be on x's CUDA device, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise ValueError(f"{name}: x and w must share a dtype in "
                         f"{tuple(_DTYPE_CODE)}, got {x.dtype}, {w.dtype}")
    if tuple(w.shape) != w_shape:
        raise ValueError(f"{name}: w has shape {tuple(w.shape)}, expected "
                         f"{w_shape} for x {tuple(x.shape)}")
    if x.numel() == 0:
        raise ValueError(f"{name}: empty input")


def _launch(fn, x, args):
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel: launch failed with CUDA error "
                           f"{err}")


def fused_rmsnorm_cuda(x, w, *, eps: float = 1e-5):
    """Launch the row kernel on CUDA tensors: x (..., d), w (d,). Raises on
    anything else. ``fused_rmsnorm_cuda.launches`` counts the launches."""
    _build.reject_dtensor("fused_rmsnorm_cuda", x, w)
    if x.dim() < 1:
        raise ValueError("fused_rmsnorm_cuda: x must have a last dim")
    d = x.shape[-1]
    _check("fused_rmsnorm_cuda", x, w, (d,))
    fn = _bind(packed=False)
    out = torch.empty_like(x)
    _launch(fn, x, (x.data_ptr(), w.data_ptr(), out.data_ptr(),
                    x.numel() // d, d, eps, _DTYPE_CODE[x.dtype],
                    row_vectors(d, x.dtype)))
    fused_rmsnorm_cuda.launches += 1
    return out


fused_rmsnorm_cuda.launches = 0


def packed_rmsnorm_cuda(x, w, *, active=None, eps: float = 1e-5):
    """Launch the lane-batched kernel on CUDA tensors: x (J, rows, d),
    w (J, d), ``active`` (J,) or None. Raises on anything else.
    ``packed_rmsnorm_cuda.launches`` counts the launches."""
    _build.reject_dtensor("packed_rmsnorm_cuda", x, w)
    if x.dim() != 3:
        raise ValueError(f"packed_rmsnorm_cuda: x must be (J, rows, d), got "
                         f"{tuple(x.shape)}")
    J, rows, d = x.shape
    _check("packed_rmsnorm_cuda", x, w, (J, d))
    if J > _MAX_GRID_Y:
        raise ValueError(f"packed_rmsnorm_cuda: {J} lanes exceed the grid")
    fn = _bind(packed=True)
    act = None
    if active is not None:
        act = torch.as_tensor(active, device=x.device).to(torch.int32)
        if act.numel() != J:
            raise ValueError(f"packed_rmsnorm_cuda: active has {act.numel()} "
                             f"entries for {J} lanes")
        act = act.reshape(J).contiguous()
    out = torch.empty_like(x)
    _launch(fn, x, (x.data_ptr(), w.data_ptr(), out.data_ptr(),
                    None if act is None else act.data_ptr(), J, rows, d, eps,
                    _DTYPE_CODE[x.dtype], row_vectors(d, x.dtype)))
    packed_rmsnorm_cuda.launches += 1
    return out


packed_rmsnorm_cuda.launches = 0


def fused_rmsnorm(x, w, *, eps: float = 1e-5):
    """The plain version for CPU tensors; the kernel for CUDA tensors."""
    _build.reject_dtensor("fused_rmsnorm", x, w)
    if x.device.type == "cpu":
        return fused_rmsnorm_plain(x, w, eps=eps)
    if x.device.type == "cuda":
        return fused_rmsnorm_cuda(x, w, eps=eps)
    raise ValueError(f"fused_rmsnorm: no kernel for device {x.device}")


def packed_rmsnorm(x, w, *, active=None, eps: float = 1e-5):
    """The plain version for CPU tensors; the kernel for CUDA tensors."""
    _build.reject_dtensor("packed_rmsnorm", x, w)
    if x.device.type == "cpu":
        return packed_rmsnorm_plain(x, w, active=active, eps=eps)
    if x.device.type == "cuda":
        return packed_rmsnorm_cuda(x, w, active=active, eps=eps)
    raise ValueError(f"packed_rmsnorm: no kernel for device {x.device}")
