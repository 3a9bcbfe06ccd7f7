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

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import is_dtensor
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
    k = _heads(layers.dense(ctx, params["w_k"]), num_kv_heads, head_dim)
    v = _heads(layers.dense(ctx, params["w_v"]), num_kv_heads, head_dim)
    return k, v


def _heads(t, H: int, head_dim: int, model=2):
    """(B, S, H*hd) -> (B, S, H, hd). Under a mesh the heads go over
    "model" when it divides H (``model`` 2), else "model" is gathered
    first (``model`` None, or H not divided): a sharded dim of H*hd
    splits into heads only along whole heads."""
    B, S, _ = t.shape
    if is_dtensor(t):
        from repro_torch.distributed.sharding import (batch_dim,
                                                      dim_placements,
                                                      model_dim)
        mesh = t.device_mesh
        if model is not None:
            model = model_dim(mesh, H, 2)
        t = t.redistribute(mesh, dim_placements(
            mesh, data=batch_dim(mesh, B), model=model))
    return t.reshape(B, S, H, head_dim)


def mesh_head_dims(mesh, num_heads: int, num_kv_heads: int) -> tuple:
    """Under a mesh, which of q's and k/v's head dims go over "model" (2)
    or stay whole (None): all heads where "model" divides the KV heads;
    else the query heads alone where each rank's query heads read a whole
    number of KV heads (k and v then whole on every rank, which reads its
    own); else none, and each "model" rank then attends with its own share
    of the query heads (``_head_share``)."""
    from repro_torch.distributed.sharding import axis_sizes
    m = axis_sizes(mesh)["model"]
    if num_kv_heads % m == 0:
        return 2, 2
    hl, group = num_heads // m, num_heads // max(num_kv_heads, 1)
    if num_heads % m == 0 and (hl % group == 0 or group % hl == 0):
        return 2, None
    return None, None


def _local_kv_heads(mesh, num_heads: int, num_kv_heads: int) -> tuple:
    """[lo, hi) of the KV heads this rank's query heads read, when the
    query heads alone go over "model"."""
    from repro_torch.distributed.sharding import axis_sizes
    m = axis_sizes(mesh)["model"]
    r = mesh.get_local_rank("model")
    hl, group = num_heads // m, num_heads // num_kv_heads
    return r * hl // group, ((r + 1) * hl - 1) // group + 1


def _head_share(mesh, num_heads: int, num_kv_heads: int) -> tuple:
    """(lo, n, per, kv) of this "model" rank where "model" divides neither
    the KV heads nor the query heads in whole groups: the rank attends
    with query heads [lo, lo + n), made up to per = ceil(Hq / model) with
    heads of zero input (the last ranks'), and ``kv`` is the KV head each
    of them reads (a rank's heads may span KV groups unevenly, so B3
    takes Hq == Hkv). A padding head reads the rank's last KV head."""
    from repro_torch.distributed.sharding import axis_sizes
    per = -(-num_heads // axis_sizes(mesh)["model"])
    lo = min(mesh.get_local_rank("model") * per, num_heads)
    n = min(per, num_heads - lo)
    group = num_heads // num_kv_heads
    kv = [(lo + i) // group for i in range(n)]
    return lo, n, per, tuple(kv + [kv[-1] if kv else 0] * (per - n))


def attn_with_kv(params: dict, x, k, v, num_heads: int, head_dim: int):
    """Attention of x onto precomputed K/V (cross-attention): every key is
    visible, through ``sdpa_chunked`` on every device, as in the
    reference (which never takes its kernel here). Under a mesh (DTensor
    operands) it runs under ``local_map``, batch over the data axes and
    heads over "model" where they divide."""
    B, S, _ = x.shape
    q = layers.dense(x, params["w_q"])
    if is_dtensor(q):
        mesh = q.device_mesh
        qd, kd = mesh_head_dims(mesh, num_heads, k.shape[2])
        out = _on_mesh(lambda q, k, v, kv_heads: sdpa_chunked(
            q, *_kv_slice(k, v, kv_heads), causal=False, window=0),
            _heads(q, num_heads, head_dim, qd), k, v, (), (), qd, kd,
            num_heads, k.shape[2])
    else:
        q = q.reshape(B, S, num_heads, head_dim)
        out = sdpa_chunked(q, k, v, causal=False, window=0)
    return layers.dense(_merge_heads(out), params["w_o"])


def _kv_slice(k, v, kv_heads):
    """k and v narrowed to the KV heads ``kv_heads``: a range (lo, hi), as
    views; an index tensor, gathered in its order; None, all of them."""
    if kv_heads is None:
        return k, v
    if isinstance(kv_heads, torch.Tensor):
        return k.index_select(2, kv_heads), v.index_select(2, kv_heads)
    lo, hi = kv_heads
    return k[:, :, lo:hi], v[:, :, lo:hi]


def _on_mesh(fn, q, k, v, extra, extra_placements, qd, kd, num_heads,
             num_kv_heads, cached: bool = False):
    """``fn(q, k, v, *extra, kv_heads=...)`` on each rank's local tensors
    under ``local_map``: q, k, v with the batch over the data axes where
    they divide it and the heads as ``mesh_head_dims`` says; ``extra``
    DTensors with their ``extra_placements`` (``cached``: a KV cache among
    them, written in place). When k and v are whole and the query heads
    are not, ``kv_heads`` is the KV heads this rank reads (``_kv_slice``;
    else None), and the gradients of k and v are partial sums over
    "model". Where "model" divides neither, the work is split over
    "model" all the same: along the batch, where no cache is written and
    the data axes and "model" together divide it (``_rows_over_model``),
    else each rank attends with its share of the query heads
    (``_head_share``)."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding import (axis_sizes, batch_dim,
                                                  dim_placements, dp_size)
    mesh = q.device_mesh
    bd = batch_dim(mesh, q.shape[0])
    qp = dim_placements(mesh, data=bd, model=qd)
    kp = dim_placements(mesh, data=bd, model=kd)
    if qd is None and kd is None:
        if (not cached and bd is not None and q.shape[0] % (
                dp_size(mesh) * axis_sizes(mesh)["model"]) == 0):
            return _rows_over_model(fn, q, k, v, extra, extra_placements, qp)
        return _head_share_map(fn, q, k, v, extra, extra_placements, qp,
                               num_heads, num_kv_heads)
    split = qd is not None and kd is None
    kg = dim_placements(mesh, data=bd, model_partial=True) if split else kp
    kv_heads = (_local_kv_heads(mesh, num_heads, num_kv_heads) if split
                else None)
    return local_map(
        functools.partial(fn, kv_heads=kv_heads), out_placements=qp,
        in_placements=(qp, kp, kp, *extra_placements),
        in_grad_placements=(qp, kg, kg, *extra_placements),
        device_mesh=mesh, redistribute_inputs=True)(q, k, v, *extra)


def _rows_over_model(fn, q, k, v, extra, extra_placements, whole):
    """``_on_mesh`` with q, k, v and ``extra`` split along the batch over
    "model" as well as over the data axes: each rank attends with every
    head for its own rows, and the output comes back gathered over "model"
    to ``whole``'s placements (the gradients are exact on each rank's
    rows)."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding import constrain

    def rows(p):
        """``p`` with "model" splitting the dim the data axes split."""
        d = next(x.dim for x in p if x.is_shard())
        return [x if x.is_shard() else Shard(d) for x in p]
    qr = rows(whole)
    extra_rows = tuple(None if p is None else rows(p)
                       for p in extra_placements)
    out = local_map(
        functools.partial(fn, kv_heads=None), out_placements=qr,
        in_placements=(qr, qr, qr, *extra_rows),
        in_grad_placements=(qr, qr, qr, *extra_rows),
        device_mesh=q.device_mesh, redistribute_inputs=True)(q, k, v, *extra)
    return constrain(out, q.device_mesh, whole, qr)


def _head_share_map(fn, q, k, v, extra, extra_placements, whole, num_heads,
                    num_kv_heads):
    """``_on_mesh`` with q, k, v whole over "model" and each rank attending
    with its own share of the query heads (``_head_share``): the output
    comes back gathered over "model" to the heads that exist, and the
    gradients of q, k and v are partial sums over "model" (each rank's
    covers its own heads)."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding import (batch_dim, constrain,
                                                  dim_placements)
    mesh = q.device_mesh
    bd = batch_dim(mesh, q.shape[0])
    lo, n, per, kv = _head_share(mesh, num_heads, num_kv_heads)

    def share(q, k, v, *rest):
        q = q.narrow(2, lo, n)
        if n < per:
            q = torch.cat([q, q.new_zeros((*q.shape[:2], per - n,
                                           q.shape[3]))], 2)
        # gathered on every rank, a view on none: a rank whose heads read
        # every KV head would otherwise take k whole as a view, and DTensor
        # then hands its gradient back in another placement than the other
        # ranks', whose collectives no longer match
        return fn(q, k, v, *rest, kv_heads=torch.tensor(kv, device=k.device))
    part = dim_placements(mesh, data=bd, model_partial=True)
    out_p = dim_placements(mesh, data=bd, model=2)
    out = local_map(
        share, out_placements=out_p,
        in_placements=(whole, whole, whole, *extra_placements),
        in_grad_placements=(part, part, part, *extra_placements),
        device_mesh=mesh, redistribute_inputs=True)(q, k, v, *extra)
    return constrain(out, mesh, whole, out_p)[:, :, :num_heads]


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

    Under a mesh (x, the params and the cache are DTensors) the
    projections run as DTensor ops and everything between them (rotation,
    attention, the cache's writes) under ``local_map``: q, k, v with the
    batch over the data axes and the heads over "model" as
    ``mesh_head_dims`` says, the cache as it is sharded, so each rank
    writes its own shard in place and the kernel gets plain local
    tensors.
    """
    impl = impl or default_impl(x.device)
    B, S, _ = x.shape
    if kv_ctx is not None:
        k, v = project_kv(params, kv_ctx, num_kv_heads, head_dim)
        return attn_with_kv(params, x, k, v, num_heads, head_dim), None
    q = layers.dense(x, params["w_q"])
    k = layers.dense(x, params["w_k"])
    v = layers.dense(x, params["w_v"])
    kw = dict(rope_theta=rope_theta, causal=causal, window=window,
              impl=impl, prob_dtype=prob_dtype)
    leaves = (None,) * 4 if kv_cache is None else tuple(
        kv_cache[n] for n in _CACHE_KEYS)
    if is_dtensor(q):
        from repro_torch.distributed.sharding import batch_dim, dim_placements
        mesh = q.device_mesh
        qd, kd = mesh_head_dims(mesh, num_heads, num_kv_heads)
        rows = dim_placements(mesh, data=batch_dim(mesh, B))
        mrope = None if mrope_positions is None else dim_placements(
            mesh, data=batch_dim(mesh, B, 1))
        cache = tuple(None if t is None else list(t.placements)
                      for t in leaves)
        out = _on_mesh(functools.partial(_attend, **kw),
                       _heads(q, num_heads, head_dim, qd),
                       _heads(k, num_kv_heads, head_dim, kd),
                       _heads(v, num_kv_heads, head_dim, kd),
                       (positions, mrope_positions, *leaves),
                       (rows, mrope, *cache), qd, kd, num_heads,
                       num_kv_heads, cached=kv_cache is not None)
    else:
        q = q.reshape(B, S, num_heads, head_dim)
        k = k.reshape(B, S, num_kv_heads, head_dim)
        v = v.reshape(B, S, num_kv_heads, head_dim)
        out = _attend(q, k, v, positions, mrope_positions, *leaves, **kw)
    return layers.dense(_merge_heads(out), params["w_o"]), kv_cache


def _merge_heads(out):
    """(B, S, H, hd) -> (B, S, H*hd). Under a mesh the gradient is held to
    the merged heads' placements before the view's backward splits it into
    heads again (a dim sharded along part-heads cannot split)."""
    B, S, H, hd = out.shape
    out = out.reshape(B, S, H * hd)
    if is_dtensor(out):
        from repro_torch.distributed.sharding import constrain
        out = constrain(out, out.device_mesh, out.placements)
    return out


_CACHE_KEYS = ("k", "v", "len", "pos")


def _attend(q, k, v, positions, mrope_positions, ck, cv, clen, cpos, *,
            rope_theta, causal, window, impl, prob_dtype, kv_heads=None):
    """``attention_block`` between its projections: rotate q and k, attend
    (with the cache's leaves ``ck``, ``cv``, ``clen``, ``cpos`` when
    given, writing them in place). Returns (B, S, Hq, D). ``kv_heads``:
    q holds the query heads that read only these KV heads of k, v and the
    cache (which hold all of them; ``_kv_slice``)."""
    B, S = q.shape[:2]
    kv_cache = None if ck is None else {"k": ck, "v": cv, "len": clen,
                                        "pos": cpos}
    if mrope_positions is not None:
        q = layers.apply_mrope(q, mrope_positions, rope_theta)
        k = layers.apply_mrope(k, mrope_positions, rope_theta)
    else:
        q = layers.apply_rope(q, positions, rope_theta)
        k = layers.apply_rope(k, positions, rope_theta)

    if kv_cache is not None and S == 1:  # decode step (ring write: len % Smax)
        Smax = kv_cache["k"].shape[1]
        slot = (kv_cache["len"] % Smax).long()
        bidx = torch.arange(B, device=q.device)
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
        return sdpa_decode(q, *_kv_slice(kv_cache["k"], kv_cache["v"],
                                         kv_heads), valid)
    # train / prefill
    if kv_cache is not None:  # prefill into cache (keep last Smax if S>Smax)
        Smax = kv_cache["k"].shape[1]
        n = min(S, Smax)
        kv_cache["k"][:, :n] = k[:, S - n:]
        kv_cache["v"][:, :n] = v[:, S - n:]
        kv_cache["pos"][:, :n] = positions[:, S - n:].to(torch.int32)
        kv_cache["len"].fill_(S)
    k, v = _kv_slice(k, v, kv_heads)
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
    return out


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
