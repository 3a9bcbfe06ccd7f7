"""Plain-PyTorch oracles for the kernels (the ground truth in tests).

Port of ``repro.kernels.ref``; ``ssd_ref`` and ``packed_gemm_ref`` arrive
with their kernels.
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
