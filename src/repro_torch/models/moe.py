"""Mixture-of-Experts FFN: top-k routing, shared experts, dense residual
(port of ``repro.models.moe``).

Two execution paths with identical math, as in the reference:
  * ``moe_dense_oracle`` — every expert on every token; O(E) compute; the
    correctness oracle for tests and tiny configs.
  * ``moe_routed``       — capacity dispatch: each (token, expert)
    assignment takes a slot, its stable rank among the assignments to that
    expert in flat (token, k) order; assignments past the capacity are
    dropped. The kept tokens are written into per-expert buffers (E, C, d),
    the experts run as batched products (``torch.bmm``; the reference's
    einsums are plain XLA too, outside any Pallas kernel), and each token
    sums its k expert outputs. Dropless when capacity_factor <= 0.

Both scatters of the reference are written without floating-point
atomics, so a result's bits do not change from run to run on the card:
the kept (expert, slot) pairs are unique, so the buffer fill is a plain
indexed write (the dropped assignments all land in one trash row, which is
discarded), and the combine is a sum over k of a (T, k, d) tensor in a
fixed order (each token's k assignments are consecutive in flat order).

``groups`` routes consecutive equal groups of tokens alone: slots are
ranked and the capacity sized within each group. The serving pool routes
each lane's token so (the reference decodes each lane at batch 1 under
``jax.vmap``), so a request's tokens never depend on its co-residents.

Expert parallelism (``ep_axis``) waits for the distributed slice (ROADMAP
A.10) and raises.

Shared experts (DeepSeek) are one dense SwiGLU FFN of width
n_shared * d_ff; the Arctic dense residual is a separate dense FFN added in
parallel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models import layers

_EP_MESSAGE = ("expert parallelism waits for the distributed slice "
               "(ROADMAP A.10)")

# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_moe(gen: torch.Generator, d_model: int, m: MoEConfig, dtype) -> dict:
    E, dff = m.num_experts, m.expert_d_ff
    p = {
        "router": layers.dense_init(gen, d_model, E, torch.float32),
        "w_gate": torch.stack([layers.dense_init(gen, d_model, dff, dtype)
                               for _ in range(E)]),
        "w_up": torch.stack([layers.dense_init(gen, d_model, dff, dtype)
                             for _ in range(E)]),
        "w_down": torch.stack([layers.dense_init(gen, dff, d_model, dtype)
                               for _ in range(E)]),
    }
    if m.num_shared_experts:
        p["shared"] = layers.init_mlp(
            gen, d_model, m.num_shared_experts * dff, "swiglu", dtype)
    return p


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------

def route(router_w: torch.Tensor, x: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (T,d) -> (weights (T,k) f32 renormalized, idx (T,k) int64, aux
    loss). The k experts of a token come in descending order of their
    probability, as ``lax.top_k`` gives them."""
    logits = x.float() @ router_w.float()                          # (T,E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, top_k, dim=-1, sorted=True)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)                # renorm
    # load-balance aux (Switch): E * sum_e f_e * P_e
    E = router_w.shape[1]
    f = F.one_hot(idx, E).float().sum((0, 1)) / (x.shape[0] * top_k)
    P = probs.mean(0)
    aux = E * torch.sum(f * P)
    return w, idx, aux


# ---------------------------------------------------------------------------
# oracle path
# ---------------------------------------------------------------------------

def moe_dense_oracle(params: dict, x: torch.Tensor, m: MoEConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T,d). All experts computed densely; exact (dropless) combine."""
    w, idx, aux = route(params["router"], x, m.top_k)
    cdt = x.dtype
    g = torch.einsum("td,edf->tef", x, params["w_gate"].to(cdt))
    u = torch.einsum("td,edf->tef", x, params["w_up"].to(cdt))
    h = F.silu(g) * u
    y_all = torch.einsum("tef,efd->ted", h, params["w_down"].to(cdt))
    sel = torch.take_along_dim(y_all, idx[:, :, None], dim=1)      # (T,k,d)
    y = torch.sum(sel * w[:, :, None].to(cdt), dim=1)
    return y, aux


# ---------------------------------------------------------------------------
# capacity-dispatch path
# ---------------------------------------------------------------------------

def _dispatch_compute_combine(x, w, idx, params, m: MoEConfig, e_start: int,
                              e_local: int, capacity: int, groups: int = 1
                              ) -> torch.Tensor:
    """Routed output of experts [e_start, e_start + e_local) for x (T,d);
    w/idx (T,k). Tokens routed elsewhere or past the capacity contribute
    zero. With ``groups`` G, the T tokens are G consecutive groups of T/G,
    each ranked into its own ``capacity`` slots per expert."""
    T, d = x.shape
    k = idx.shape[1]
    cdt = x.dtype
    dev = x.device
    flat_e = idx.reshape(-1)                          # (T*k,) expert ids
    flat_w = w.reshape(-1)
    local = (flat_e >= e_start) & (flat_e < e_start + e_local)
    le = torch.where(local, flat_e - e_start, e_local)   # e_local = trash
    # slot: stable rank among the same (group, expert) assignments, read
    # from a stable sort (the reference's cumsum of a (T*k, E+1) one-hot
    # gives the same ranks; on the card its column scan is slow)
    per_group = T // groups
    flat = torch.arange(T * k, device=dev)
    group = flat // (per_group * k)
    cat = group * (e_local + 1) + le
    order = torch.argsort(cat, stable=True)
    counts = torch.bincount(cat, minlength=groups * (e_local + 1))
    starts = counts.cumsum(0) - counts
    slot = torch.empty_like(flat)
    slot[order] = flat - starts[cat[order]]
    keep = local & (slot < capacity)
    # a slot is below the group's assignment count to its expert, which is
    # at most per_group (a token's k experts are distinct): rows past that
    # would stay empty, so the buffer is cut to them (same result)
    rows = min(capacity, per_group)
    le_s = torch.where(keep, le, e_local)             # overflow -> trash row
    row = torch.where(keep, group * rows + slot, 0)

    buf = x.new_zeros((e_local + 1, groups * rows, d))
    buf[le_s, row] = x.repeat_interleave(k, dim=0)    # kept pairs unique
    buf = buf[:e_local]
    sl = slice(e_start, e_start + e_local)
    g = torch.bmm(buf, params["w_gate"][sl].to(cdt))
    u = torch.bmm(buf, params["w_up"][sl].to(cdt))
    yb = torch.bmm(F.silu(g) * u, params["w_down"][sl].to(cdt))

    vals = yb[le_s.clamp_max(e_local - 1), row] * flat_w[:, None].to(cdt)
    vals = torch.where(keep[:, None], vals, torch.zeros((), dtype=cdt,
                                                        device=dev))
    return vals.reshape(T, k, d).sum(dim=1)


def capacity_for(T: int, m: MoEConfig, num_shards: int = 1) -> int:
    if m.capacity_factor <= 0:
        return T * m.top_k                           # dropless
    cap = int(T * m.top_k * m.capacity_factor / m.num_experts) * num_shards
    return max(cap, 8)


def moe_routed(params: dict, x: torch.Tensor, m: MoEConfig, *,
               capacity: Optional[int] = None,
               ep_axis: Optional[str] = None, groups: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed-experts output for x (T,d) on one device. ``groups`` G routes
    each of G consecutive groups of T/G tokens alone, its capacity
    ``capacity_for(T/G)`` unless ``capacity`` is given; the aux loss is
    over all T tokens."""
    if ep_axis is not None:
        raise NotImplementedError(_EP_MESSAGE)
    T = x.shape[0]
    if T % groups:
        raise ValueError(f"moe_routed: {T} tokens in {groups} groups")
    cap = capacity if capacity is not None else capacity_for(T // groups, m)
    w, idx, aux = route(params["router"], x, m.top_k)
    y = _dispatch_compute_combine(x, w, idx, params, m, 0, m.num_experts,
                                  cap, groups)
    return y, aux


# ---------------------------------------------------------------------------
# full MoE FFN block (shared + routed + optional dense residual)
# ---------------------------------------------------------------------------

def moe_ffn(params: dict, x: torch.Tensor, m: MoEConfig, *,
            dense_params: Optional[dict] = None, oracle: bool = False,
            ep_axis: Optional[str] = None, route_rows: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> (y (B,S,d), aux loss). ``dense_params`` is the Arctic
    parallel dense-residual FFN (cfg.moe.dense_residual). ``route_rows``
    routes each batch row alone (``moe_routed``'s groups = B)."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    if oracle:
        y, aux = moe_dense_oracle(params, xt, m)
    else:
        y, aux = moe_routed(params, xt, m, ep_axis=ep_axis,
                            groups=B if route_rows else 1)
    y = y.reshape(B, S, d)
    if "shared" in params:
        y = y + layers.mlp(params["shared"], x, "swiglu")
    if dense_params is not None:
        y = y + layers.mlp(dense_params, x, "swiglu")
    return y, aux
