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
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.ref import mask_lanes

NEG_INF = -1e30

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


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


def _bind():
    from repro_torch.kernels import _build
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    return _build.entry("flash_attention", "repro_flash_attention_fwd",
                        [p] * 5 + [i] * 6 + [ll] * 12
                        + [i, i, ctypes.c_float, i, p])


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
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention_cuda: dtype {q.dtype} not in "
                         f"{tuple(_DTYPE_CODE)}")
    B, Sq, Hq, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    if tuple(v.shape) != tuple(k.shape) or Bk != B or Dk != D:
        raise ValueError(f"flash_attention_cuda: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} disagree")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {D} not in {_HEAD_DIMS}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention_cuda: {Hq} q heads not a multiple "
                         f"of {Hkv} kv heads")
    if Sq == 0 or Sk == 0 or B == 0 or window < 0:
        raise ValueError("flash_attention_cuda: empty input or negative window")


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         active=None):
    """Launch the Hopper kernel on CUDA tensors (raises on anything else).
    ``flash_attention_cuda.launches`` counts the launches."""
    _check(q, k, v, window)
    fn = _bind()
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    act = None
    if active is not None:
        act = torch.as_tensor(active, device=q.device).to(torch.int32)
        if act.numel() != B:
            raise ValueError(f"flash_attention_cuda: active has {act.numel()} "
                             f"entries for batch {B}")
        act = act.reshape(B).contiguous()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if act is None else act.data_ptr(),
                 B, Sq, Sk, Hq, Hkv, D,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3],
                 int(causal), int(window), 1.0 / math.sqrt(D),
                 _DTYPE_CODE[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_cuda: launch failed with CUDA "
                           f"error {err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        active=None):
    """The plain version for CPU tensors; the kernel for CUDA tensors (it
    launches or raises, never falls back)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     active=active)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    active=active)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")
