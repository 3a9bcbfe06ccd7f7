"""Forward flash attention: the Hopper kernel's wrapper and its plain version.

Port of ``repro.kernels.flash_attention.flash_attention_fwd`` (the Pallas
TPU kernel). The kernel is ``csrc/flash_attention.cu`` (CUDA C++, sm_90a),
built at first use by ``_build`` and called through ctypes; its source says
what bounds it and how it is laid out. ``flash_attention_plain`` computes the
same function in plain PyTorch: the CPU path and the tests use it, and the
card compares the kernel against it.

Contract (both versions): q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D) -> (B,Sq,Hq,D) in
q.dtype; q-head h reads kv-head h // (Hq/Hkv); scale 1/sqrt(D); causal and
sliding-window masks with positions counted from 0 in both q and k; f32
softmax statistics; the denominator clamped at 1e-30. ``active`` (B,) makes
inactive batch lanes exact zeros and leaves active lanes bit-identical to
the call without it.

Two hand-written bodies, chosen by dtype and head dim (``attention_body``):
bf16 runs the tensor-core body (``wgmma`` products, Q/K/V tiles fed by
TMA), f32 the CUDA-core body (the tensor cores take f32 only as TF32, which
the port does not use); each takes every head dim that is a multiple of 16
from 16 to 128 (the reduced configs' 16, zamba2-7b's 112).
``flash_attention_cuda.launches_by_body`` counts each; ``launches`` is their
sum. The bf16 body reads q, k, v through TMA tensor maps over their own
strides: a base or a stride that is not a multiple of 16 bytes raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, tma
from repro_torch.kernels.ref import mask_lanes

NEG_INF = -1e30

_BODY = {torch.float32: "simt", torch.bfloat16: "wgmma"}
_HEAD_DIMS = tuple(range(16, 129, 16))
_LOG2E = 1.4426950408889634


def attention_body(dtype, head_dim: int) -> str:
    """The hand-written body that takes ``dtype`` and ``head_dim``: "wgmma"
    (tensor cores) for bfloat16, "simt" (CUDA cores) for float32; raises for
    any other dtype, or a head dim that is not a multiple of 16 from 16 to
    128."""
    body = _BODY.get(dtype)
    if body is None:
        raise ValueError(f"flash_attention_cuda: no kernel body for dtype "
                         f"{dtype}; bodies take {tuple(_BODY)}")
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {head_dim} is not "
                         f"a multiple of 16 from 16 to 128")
    return body


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          active=None):
    """The kernel's function in plain PyTorch (full score materialization)."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    qf = q.float().reshape(B, Sq, Hkv, G, D) * (1.0 / math.sqrt(D))
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window:
        mask &= q_pos - k_pos < window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float()) / l.clamp_min(1e-30)
    out = o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)
    return out if active is None else mask_lanes(active, out)


def _bind(body: str):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    symbol = ("repro_flash_attention_fwd" if body == "simt"
              else "repro_flash_attention_fwd_wgmma")
    return _build.entry("flash_attention", symbol,
                        [p] * 5 + [i] * 6 + [ll] * 12
                        + [i, i, ctypes.c_float, p])


def _tma_strides(t) -> tuple:
    """(b, s, h) element strides of ``t`` for a tensor map, or raise: a
    layout TMA cannot describe (``tma.describable``) has no body to take
    it in bf16."""
    if not tma.describable(t.shape, t.stride(), 3, t.data_ptr(),
                           t.element_size()):
        raise ValueError(f"flash_attention_cuda: the bf16 body reads q, k, "
                         f"v through TMA, which needs 16-byte aligned bases "
                         f"and strides; got strides {t.stride()} at address "
                         f"{t.data_ptr():#x}")
    return tma.map_strides(t.shape, t.stride())[:3]


def _check(q, k, v, window: int):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention_cuda: {name} must be on "
                             f"q's CUDA device, got {t.device}")
        if t.dtype != q.dtype:
            raise ValueError("flash_attention_cuda: q, k, v must share a dtype")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"flash_attention_cuda: {name} must be 4-D "
                             f"(B,S,H,D) with a contiguous last dim")
    B, Sq, Hq, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    if tuple(v.shape) != tuple(k.shape) or Bk != B or Dk != D:
        raise ValueError(f"flash_attention_cuda: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} disagree")
    attention_body(q.dtype, D)
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention_cuda: {Hq} q heads not a multiple "
                         f"of {Hkv} kv heads")
    if Sq == 0 or Sk == 0 or B == 0 or window < 0:
        raise ValueError("flash_attention_cuda: empty input or negative window")


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         active=None):
    """Launch the Hopper kernel on CUDA tensors (raises on anything else):
    the wgmma body for bf16, the simt body for f32.
    ``flash_attention_cuda.launches`` counts the launches and
    ``launches_by_body`` splits them by body."""
    _build.reject_dtensor("flash_attention_cuda", q, k, v)
    _check(q, k, v, window)
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    body = attention_body(q.dtype, D)
    fn = _bind(body)
    act = None
    if active is not None:
        act = torch.as_tensor(active, device=q.device).to(torch.int32)
        if act.numel() != B:
            raise ValueError(f"flash_attention_cuda: active has {act.numel()} "
                             f"entries for batch {B}")
        act = act.reshape(B).contiguous()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if body == "simt":
        strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
        scale = 1.0 / math.sqrt(D)
    else:
        strides = (*_tma_strides(q), *_tma_strides(k), *_tma_strides(v))
        scale = _LOG2E / math.sqrt(D)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if act is None else act.data_ptr(),
                 B, Sq, Sk, Hq, Hkv, D, *strides, *out.stride()[:3],
                 int(causal), int(window), scale,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        what = ("tensor map refused (CUresult %d)" % -err if err < 0
                else "CUDA error %d" % err)
        raise RuntimeError(f"flash_attention_cuda: launch failed: {what}")
    flash_attention_cuda.launches_by_body[body] += 1
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_body = {"wgmma": 0, "simt": 0}


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        active=None):
    """The plain version for CPU tensors; the kernel for CUDA tensors (it
    launches or raises, never falls back)."""
    _build.reject_dtensor("flash_attention_fwd", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     active=active)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    active=active)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")
