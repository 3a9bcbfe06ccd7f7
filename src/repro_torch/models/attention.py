"""Attention: GQA, causal/bidirectional/sliding-window, ring KV cache,
cross-attention onto an encoder memory, RoPE and M-RoPE.

Port of ``repro.models.attention``. Self-attention's prefill and training
paths, selected by ``impl``:
  * ``"kernel"``  — ``kernels.ops.flash_attention``: the Hopper kernel on a
                    CUDA tensor, its plain version on a CPU tensor.
                    Default on ``cuda``.
  * ``"chunked"`` — ``sdpa_chunked``, online softmax over KV chunks in plain
                    PyTorch (the reference's "xla" path). Default on ``cpu``.
  * ``"plain"``   — the kernel's plain version called directly, on any
                    device (the yardstick the card holds the kernel to).

Decode (one token against a cache) always runs ``sdpa_decode``, and
cross-attention always ``sdpa_chunked``, as in the reference.

The KV cache is updated IN PLACE (``index_put_`` / slice assignment into the
cache tensors) where the reference returns an updated copy: the caches of a
serving pool are the largest tensors it holds, and a copy per decode step
would move them all once more. ``attention_block`` returns the same dict.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers

NEG_INF = -1e30


def default_impl(device: torch.device) -> str:
    return "kernel" if torch.device(device).type == "cuda" else "chunked"


def init_attention(gen: torch.Generator, d_model: int, num_heads: int,
                   num_kv_heads: int, head_dim: int, dtype) -> dict:
    return {
        "w_q": layers.dense_init(gen, d_model, num_heads * head_dim, dtype),
        "w_k": layers.dense_init(gen, d_model, num_kv_heads * head_dim, dtype),
        "w_v": layers.dense_init(gen, d_model, num_kv_heads * head_dim, dtype),
        "w_o": layers.dense_init(gen, num_heads * head_dim, d_model, dtype),
    }


def _chunk_mask(q_pos, k_pos, causal: bool, window: int):
    """(Sq, Ck) boolean mask. window==0 => unbounded look-back."""
    m = None
    if causal:
        m = q_pos[:, None] >= k_pos[None, :]
    if window:
        w = q_pos[:, None] - k_pos[None, :] < window
        m = w if m is None else (m & w)
    return m


def sdpa_chunked(q, k, v, *, causal: bool, window: int = 0,
                 q_offset: int = 0, chunk_k: int = 1024,
                 kv_valid_len: Optional[torch.Tensor] = None,
                 prob_dtype=torch.float32):
    """Online-softmax attention over KV chunks.

    q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D); Hq % Hkv == 0.
    q_offset: absolute position of q[0]; kv_valid_len: optional (B,) number
    of valid cache entries. Returns (B, Sq, Hq, D) in q.dtype.
    """
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    chunk_k = min(chunk_k, Sk)
    pad = (-Sk) % chunk_k
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    n_chunks = (Sk + pad) // chunk_k

    dev = q.device
    qf = (q.float() * (D ** -0.5)).reshape(B, Sq, Hkv, G, D)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    limit = (torch.full((1, 1), Sk, device=dev) if kv_valid_len is None
             else kv_valid_len.reshape(B, 1))

    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, D), dtype=torch.float32, device=dev)
    for idx in range(n_chunks):
        k_blk = k[:, idx * chunk_k:(idx + 1) * chunk_k]
        v_blk = v[:, idx * chunk_k:(idx + 1) * chunk_k]
        k_pos = idx * chunk_k + torch.arange(chunk_k, device=dev)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k_blk.float())
        mask = _chunk_mask(q_pos, k_pos, causal, window)
        if mask is not None:
            s = s.masked_fill(~mask, NEG_INF)
        valid = k_pos[None, :] < limit                   # (B,Ck) or (1,Ck)
        s = s.masked_fill(~valid[:, None, None, None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(prob_dtype),
            v_blk.to(prob_dtype)).float()
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]           # (B,Hkv,G,Sq,D)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D)
    return out.to(q.dtype)


def sdpa_decode(q, k_cache, v_cache, valid):
    """Single-token decode attention over a cache with explicit validity.

    q: (B, 1, Hq, D); caches: (B, Smax, Hkv, D); valid: (B, Smax) bool.
    """
    B, _, Hq, D = q.shape
    _, Smax, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    qf = (q.float() * (D ** -0.5)).reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float())
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(B, 1, Hq, D).to(q.dtype)


def project_kv(params: dict, ctx, num_kv_heads: int, head_dim: int) -> tuple:
    """K/V projections of an encoder memory (no rope). ctx (B, Sk, d)."""
    B, Sk, _ = ctx.shape
    cdt = ctx.dtype
    k = (ctx @ params["w_k"].to(cdt)).reshape(B, Sk, num_kv_heads, head_dim)
    v = (ctx @ params["w_v"].to(cdt)).reshape(B, Sk, num_kv_heads, head_dim)
    return k, v


def attn_with_kv(params: dict, x, k, v, num_heads: int, head_dim: int):
    """Attention of x onto precomputed K/V (cross-attention): every key is
    visible, through ``sdpa_chunked`` on every device, as in the
    reference (which never takes its kernel here)."""
    B, S, _ = x.shape
    cdt = x.dtype
    q = (x @ params["w_q"].to(cdt)).reshape(B, S, num_heads, head_dim)
    out = sdpa_chunked(q, k, v, causal=False, window=0)
    out = out.reshape(B, S, num_heads * head_dim)
    return out @ params["w_o"].to(cdt)


def attention_block(params: dict, x, *, num_heads: int, num_kv_heads: int,
                    head_dim: int, positions, rope_theta: float,
                    mrope_positions=None,
                    causal: bool = True, window: int = 0,
                    kv_cache: Optional[dict] = None,
                    impl: Optional[str] = None,
                    prob_dtype=torch.float32, kv_ctx=None) -> tuple:
    """Returns (out, kv_cache).

    Modes:
      * kv_cache is None              -> self-attention over x (train/prefill)
      * kv_cache given, x is 1 token  -> cached decode step (ring write)
      * kv_cache given, x longer      -> prefill, writing the cache
      * kv_ctx given                  -> cross-attention onto kv_ctx (no
                                         rope, no cache; returns None)
    kv_cache = {"k": (B,Smax,Hkv,D), "v": ..., "len": (B,) int32,
    "pos": (B,Smax) int32}, updated in place. ``mrope_positions`` (3, B, S)
    rotates q and k by M-RoPE instead of RoPE; the cache's slots and
    validity still come from ``positions``.
    """
    impl = impl or default_impl(x.device)
    B, S, _ = x.shape
    cdt = x.dtype
    if kv_ctx is not None:
        k, v = project_kv(params, kv_ctx, num_kv_heads, head_dim)
        return attn_with_kv(params, x, k, v, num_heads, head_dim), None
    q = (x @ params["w_q"].to(cdt)).reshape(B, S, num_heads, head_dim)
    k = (x @ params["w_k"].to(cdt)).reshape(B, S, num_kv_heads, head_dim)
    v = (x @ params["w_v"].to(cdt)).reshape(B, S, num_kv_heads, head_dim)
    if mrope_positions is not None:
        q = layers.apply_mrope(q, mrope_positions, rope_theta)
        k = layers.apply_mrope(k, mrope_positions, rope_theta)
    else:
        q = layers.apply_rope(q, positions, rope_theta)
        k = layers.apply_rope(k, positions, rope_theta)

    if kv_cache is not None and S == 1:  # decode step (ring write: len % Smax)
        Smax = kv_cache["k"].shape[1]
        slot = (kv_cache["len"] % Smax).long()
        bidx = torch.arange(B, device=x.device)
        # validity from absolute positions: written, and inside the window
        valid = kv_cache["pos"] >= 0
        valid[bidx, slot] = True
        kv_cache["k"][bidx, slot] = k[:, 0].to(kv_cache["k"].dtype)
        kv_cache["v"][bidx, slot] = v[:, 0].to(kv_cache["v"].dtype)
        kv_cache["pos"][bidx, slot] = positions[:, 0].to(torch.int32)
        kv_cache["len"].add_(1)
        cur = positions[:, 0:1]
        valid &= kv_cache["pos"] <= cur
        if window:
            valid &= kv_cache["pos"] > cur - window
        out = sdpa_decode(q, kv_cache["k"], kv_cache["v"], valid)
    else:  # train / prefill
        if impl == "kernel":
            from repro_torch.kernels import ops
            out = ops.flash_attention(q, k, v, causal=causal, window=window)
        elif impl == "plain":
            from repro_torch.kernels.flash_attention import flash_attention_plain
            out = flash_attention_plain(q, k, v, causal=causal, window=window)
        elif impl == "chunked":
            out = sdpa_chunked(q, k, v, causal=causal, window=window,
                               prob_dtype=prob_dtype)
        else:
            raise ValueError(f"unknown attention impl {impl!r}")
        if kv_cache is not None:  # prefill into cache (keep last Smax if S>Smax)
            Smax = kv_cache["k"].shape[1]
            n = min(S, Smax)
            kv_cache["k"][:, :n] = k[:, S - n:]
            kv_cache["v"][:, :n] = v[:, S - n:]
            kv_cache["pos"][:, :n] = positions[:, S - n:].to(torch.int32)
            kv_cache["len"].fill_(S)

    out = out.reshape(B, S, num_heads * head_dim)
    return out @ params["w_o"].to(cdt), kv_cache


def init_kv_cache(batch: int, max_len: int, num_kv_heads: int, head_dim: int,
                  dtype, device=None) -> dict:
    """Ring KV cache. ``pos`` holds the absolute position stored in each
    slot (-1 = empty); windowed caches set max_len == window."""
    return {
        "k": torch.zeros((batch, max_len, num_kv_heads, head_dim),
                         dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, num_kv_heads, head_dim),
                         dtype=dtype, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
        "pos": torch.full((batch, max_len), -1, dtype=torch.int32,
                          device=device),
    }
