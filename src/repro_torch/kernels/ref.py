"""Plain-PyTorch oracles for the kernels (the ground truth in tests).

Port of ``repro.kernels.ref``. ``mask_lanes`` is the where-zero lane mask
of the reference's XLA paths (``repro.kernels.ops._mask_lanes``), shared by
every plain version that takes ``active``.
"""
from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """Naive full-materialization attention. q (B,Sq,Hq,D); k/v (B,Sk,Hkv,D)."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    qf = q.float().reshape(B, Sq, Hkv, G, D) * (D ** -0.5)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window:
        mask &= q_pos - k_pos < window
    s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


def ssd_ref(x, dt, A, B, C):
    """Sequential SSD recurrence oracle (see models.ssm)."""
    from repro_torch.models.ssm import ssd_reference_recurrent
    return ssd_reference_recurrent(x, dt, A, B, C)


def packed_gemm_ref(x, w):
    """x (J, M, K); w (J, K, N) -> (J, M, N): per-job matmul in f32, output
    in x.dtype."""
    return torch.einsum("jmk,jkn->jmn", x.float(), w.float()).to(x.dtype)


def mask_lanes(active, out):
    """Where-zero the lanes of ``out``'s leading axis where ``active == 0``:
    inactive lanes become exact zeros, active lanes pass through unchanged."""
    mask = torch.as_tensor(active, device=out.device).reshape(-1) != 0
    mask = mask.reshape((-1,) + (1,) * (out.dim() - 1))
    return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))
