"""Transformer stacks of the dense, moe, ssm and cross (encoder-decoder
decoder) kinds, and the zamba2-style hybrid (Mamba2 backbone + one SHARED
attention block applied periodically): port of ``repro.models.transformer``.

Per-layer params and caches are stacked on a leading L axis, as in the
reference; its ``lax.scan`` over that axis becomes a Python loop that takes
views of layer l (``lane_slice``), so a cache written in place by a layer
lands in the stacked buffer.

Remat (``cfg.remat``, the reference's ``jax.checkpoint`` per scanned block)
is ``_Recompute``: an autograd Function that runs a block, keeps only its
inputs, and runs it again inside the backward. It is built the way
``torch.func`` takes a Function (``setup_context`` and a generated vmap
rule), so it works in a lane pool's ``vmap(grad(...))``;
``torch.utils.checkpoint`` does not (saved-tensor hooks, or no
``setup_context``). It applies only where autograd needs the block's
result, so every no-grad path (serving) runs as before. A cross block's
encoder memory rides through it as a tensor input, so its gradient reaches
the encoder; M-RoPE positions ride as an integer input. A moe block's
router loss is the Function's second output, so the loss's gradient reaches
the router through the recompute as well. The hybrid recomputes per
superblock (its ``period`` Mamba2 blocks and the shared block under one
Function, whose recompute rematerializes each Mamba2 block again, as the
reference's nested ``jax.checkpoint``) and its tail block by block.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import spans
from repro_torch.core.packing import (lane_slice, tree_leaves,
                                     tree_map, tree_unflatten)
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models import attention, layers, moe, ssm


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """How the forward pass should specialize.

    attn_impl   — the sequence mixer's prefill/train path, for attention and
                  SSD alike (None picks by device, see
                  ``attention.default_impl``):
                    "kernel"  — the Hopper kernel (``ops.flash_attention``,
                                ``ops.ssd``); the default on ``cuda``
                    "chunked" — the reference's own path (``sdpa_chunked``,
                                ``ssm.ssd_chunked``); the default on ``cpu``
                    "plain"   — the kernel's plain version on any device
    score_bf16  — bf16 softmax probabilities in ``sdpa_chunked``'s PV product
    moe_oracle  — MoE blocks run ``moe.moe_dense_oracle`` (every expert on
                  every token; the reference's tests build their models so)
    mesh        — the ``DeviceMesh`` (named dims, "model" among them) whose
                  DTensors the params and batch are, or None on one device
    ep          — expert parallelism: with a mesh, the routed experts run
                  under ``local_map`` with the expert dim over "model"
                  (``_ep_moe_call``); without one it changes nothing
    ep_bf16     — the EP combine's sum over "model" carries bf16
    constrain   — redistribute activations at block boundaries to batch
                  over the data axes, the rest replicated
                  (``_constrain_act``, the reference's sharding constraint)
    """
    attn_impl: Optional[str] = None
    score_bf16: bool = False
    moe_oracle: bool = False
    mesh: Any = None
    ep: bool = False
    ep_bf16: bool = False
    constrain: bool = True

    def batch_axes(self):
        if self.mesh is None:
            return None
        return tuple(n for n in self.mesh.mesh_dim_names if n != "model")


def act_placements(mesh, batch: int) -> list:
    """Placements of an activation whose dim 0 is a batch of ``batch``:
    over the data axes when they divide it, the rest replicated."""
    from repro_torch.distributed.sharding import batch_dim, dim_placements
    return dim_placements(mesh, data=batch_dim(mesh, batch))


def _constrain_act(x, pctx: ParallelCtx):
    """Activations (B, S, d): batch over the data axes, rest replicated."""
    if pctx.mesh is None or not pctx.constrain or not is_dtensor(x):
        return x
    from repro_torch.distributed.sharding import constrain
    # the backward too: the gradient that comes back from the head's
    # product as partial sums over "model" is summed here
    return constrain(x, pctx.mesh, act_placements(pctx.mesh, x.shape[0]))


def _ep_moe_call(p_moe: dict, xt, cfg: ModelConfig, pctx: ParallelCtx,
                 route_rows: int = 0):
    """Routed experts under expert parallelism: ``local_map`` over the
    mesh with the reference's ``shard_map`` specs, the router replicated,
    the experts over "model", the tokens over the data axes; the router
    loss is averaged over the data axes. ``route_rows`` (the sequence
    length, or 0) routes each batch row alone.

    The gradients' placements say what each rank's local gradient is: the
    tokens' is partial over "model" (each rank's experts add theirs), the
    experts' partial over the data axes (each rank's tokens add theirs),
    the router's partial over every axis. The router loss is the same on
    every "model" rank, so only rank 0 of that axis passes its gradient
    on, and the sum over "model" counts it once."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.collectives import sum_over_group
    from repro_torch.distributed.sharding import dim_placements as pl
    from repro_torch.distributed.sharding import over_data_axes
    mesh, m = pctx.mesh, cfg.moe
    names = mesh.mesh_dim_names
    sizes = dict(zip(names, mesh.shape))
    if m.num_experts % sizes["model"]:
        raise ValueError(f"{m.num_experts} experts do not divide over the "
                         f"mesh's {sizes['model']} \"model\" ranks")
    data = pctx.batch_axes()
    ep_group = mesh.get_group("model")
    data_groups = [mesh.get_group(a) for a in data]
    dp = math.prod(sizes[a] for a in data)
    cdt = torch.bfloat16 if pctx.ep_bf16 else None

    def body(router, wg, wu, wd, xt_l):
        prm = {"router": router, "w_gate": wg, "w_up": wu, "w_down": wd}
        groups = xt_l.shape[0] // route_rows if route_rows else 1
        y, aux = moe.moe_routed(prm, xt_l, m, ep_axis=ep_group,
                                groups=groups, combine_dtype=cdt)
        for g in data_groups:
            aux = sum_over_group(aux, g)
        aux = aux / dp
        if dist.get_rank(ep_group):
            aux = aux.detach()
        return y, aux

    rep, tok, exp = pl(mesh), pl(mesh, data=0), pl(mesh, model=0)
    # the experts whole over the data axes in one gather over their
    # flattened group (``sharding.over_data_axes``): left to local_map,
    # DTensor gathers "data" first and then "pod" on a tensor as many
    # times larger as "data" has ranks; the gradient goes back as one
    # reduce-scatter
    experts = [over_data_axes(p_moe[k], Replicate())
               for k in ("w_gate", "w_up", "w_down")]
    fn = local_map(body, out_placements=(tok, rep),
                   in_placements=(rep, exp, exp, exp, tok),
                   in_grad_placements=(
                       pl(mesh, data_partial=True, model_partial=True),
                       *[pl(mesh, model=0, data_partial=True)] * 3,
                       pl(mesh, data=0, model_partial=True)),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(p_moe["router"], *experts, xt)


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
               dtype) -> dict:
    hd = cfg.resolved_head_dim
    dev = gen.device
    if kind == "ssm":
        return {"ln": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
                "mamba": ssm.init_mamba2(gen, cfg.d_model, cfg.ssm, dtype)}
    p = {
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "attn": attention.init_attention(
            gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, hd, dtype),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    }
    if kind == "dense":
        p["mlp"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type,
                                   dtype)
    elif kind == "cross":  # encoder-decoder decoder block
        p["cross_attn"] = attention.init_attention(
            gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, hd, dtype)
        p["ln_cross"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
        p["mlp"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type,
                                   dtype)
    elif kind == "moe":
        p["moe"] = moe.init_moe(gen, cfg.d_model, cfg.moe, dtype)
        if cfg.moe.dense_residual:
            p["dense_mlp"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff,
                                             cfg.mlp_type, dtype)
    else:
        raise ValueError(kind)
    return p


def init_stack(gen: torch.Generator, cfg: ModelConfig, kind: str, n: int,
               dtype) -> dict:
    """``n`` blocks drawn in order and stacked on a leading L axis. Each is
    written into the stack as it is drawn, so the peak is the stack and one
    block, not two stacks (full-depth DeepSeekMoE-16B's 67.5 GB)."""
    first = init_block(gen, cfg, kind, dtype)
    stack = tree_map(lambda a: a.new_empty((n, *a.shape)), first)
    for i in range(n):
        _write(lane_slice(stack, i),
               first if i == 0 else init_block(gen, cfg, kind, dtype))
    return stack


def attn_block_fwd(p: dict, x, cfg: ModelConfig, *, positions, window: int,
                   causal: bool, cache=None, pctx: ParallelCtx,
                   mrope_positions=None):
    return attention.attention_block(
        p["attn"], layers.rms_norm(x, p["ln1"], cfg.norm_eps),
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, positions=positions,
        rope_theta=cfg.rope_theta, mrope_positions=mrope_positions,
        causal=causal, window=window,
        kv_cache=cache, impl=pctx.attn_impl,
        prob_dtype=torch.bfloat16 if pctx.score_bf16 else torch.float32)


def _write(cache: dict, new: dict) -> None:
    """Copy a layer's new decode state into its (stacked) cache views."""
    tree_map(lambda dst, src: dst.copy_(src), cache, new)


def block_fwd(p: dict, x, cfg: ModelConfig, kind: str, **kw):
    """One block of ``kind`` (``_block``), traced as the span ``model.block``
    (``core.spans``)."""
    with spans.span("model.block", kind=kind):
        return _block(p, x, cfg, kind, **kw)


def _block(p: dict, x, cfg: ModelConfig, kind: str, *, positions,
           window: int = 0, causal: bool = True, cache=None,
           pctx: ParallelCtx, route_rows: bool = False,
           mrope_positions=None, enc_memory=None):
    """One block of ``kind`` ("dense", "moe", "ssm" or "cross"). Returns
    (x, cache, aux): aux is the MoE router loss (0 for the other kinds); a
    given cache is updated in place. ``route_rows``: a moe block routes
    each batch row alone (``moe.moe_ffn``). A cross block's cache is
    {"self": ring KV cache, "cross_k", "cross_v"}: in decode (no
    ``enc_memory``) it attends over the cached cross K/V; in prefill it
    projects ``enc_memory`` and returns a new dict holding the projections
    as fresh leaves of the memory's length (the stacked buffer may be
    another length: ``run_stack`` replaces it)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "ssm":
        h = layers.rms_norm(x, p["ln"], cfg.norm_eps)
        if cache is None:
            y, _ = ssm.mamba2_block(p["mamba"], h, cfg.d_model, cfg.ssm,
                                    impl=pctx.attn_impl)
        elif h.shape[1] == 1:  # decode
            y, new = ssm.mamba2_decode_step(p["mamba"], h[:, 0], cache,
                                            cfg.d_model, cfg.ssm)
            _write(cache, new)
            y = y[:, None]
        else:  # prefill: the full sequence, then the decode state
            y, new = ssm.mamba2_prefill(p["mamba"], h, cfg.d_model, cfg.ssm,
                                        impl=pctx.attn_impl)
            _write(cache, new)
        return _constrain_act(x + y, pctx), cache, aux
    self_cache = cache["self"] if kind == "cross" and cache is not None \
        else cache
    out, _ = attn_block_fwd(p, x, cfg, positions=positions, window=window,
                            causal=causal, cache=self_cache, pctx=pctx,
                            mrope_positions=mrope_positions)
    x = _constrain_act(x + out, pctx)
    if kind == "cross":
        hd = cfg.resolved_head_dim
        if cache is not None and enc_memory is None:      # decode: cached KV
            ck, cv = cache["cross_k"], cache["cross_v"]
        else:                                             # train / prefill
            ck, cv = attention.project_kv(p["cross_attn"], enc_memory,
                                          cfg.num_kv_heads, hd)
            if cache is not None:
                cache = {**cache, "cross_k": ck, "cross_v": cv}
        x = _constrain_act(x + attention.attn_with_kv(
            p["cross_attn"], layers.rms_norm(x, p["ln_cross"], cfg.norm_eps),
            ck, cv, cfg.num_heads, hd), pctx)
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    if kind == "moe" and pctx.ep and pctx.mesh is not None \
            and not pctx.moe_oracle:
        B, S, d = h.shape
        y, aux = _ep_moe_call(p["moe"], h.reshape(B * S, d), cfg, pctx,
                              route_rows=S if route_rows else 0)
        y = y.reshape(B, S, d)
        if "shared" in p["moe"]:
            y = y + layers.mlp(p["moe"]["shared"], h, "swiglu")
        if "dense_mlp" in p:
            y = y + layers.mlp(p["dense_mlp"], h, "swiglu")
    elif kind == "moe":
        y, aux = moe.moe_ffn(p["moe"], h, cfg.moe,
                             dense_params=p.get("dense_mlp"),
                             oracle=pctx.moe_oracle,
                             route_rows=route_rows)
    else:
        y = layers.mlp(p["mlp"], h, cfg.mlp_type)
    return _constrain_act(x + y, pctx), cache, aux


def _per_layer(stack: dict) -> list:
    """The layers of a stacked tree: ``lane_slice`` views of plain tensors.
    Under a mesh each DTensor leaf is unbound once, and each layer's leaf
    is held to its placements in the backward (``sharding.constrain``),
    so the layer's gradient is reduced to its parameter's shards as soon
    as the layer's backward ends, as GSPMD does inside the reference's
    scan. (Counted on meta at 16 of llama3-405b's layers on a 16 x 16
    mesh: a DTensor stack's per-layer select made, in the backward, a
    zero stack holding each layer's gradient, which autograd held until
    it summed them, 225 of a 321 GB peak; unbound, the layers' unreduced
    gradients, partial sums over the data axes, were 172 of 242 GB.) A
    leaf sharded along its layer dim (the specs' fallback rule shards the
    largest dim of an (L, nh) leaf with L > nh, such as Mamba2's
    ``A_log``), which DTensor cannot unbind, is first gathered whole on the
    mesh dims that shard it (``_unbindable``)."""
    n = _depth(stack)
    leaves = tree_leaves(stack)
    if not is_dtensor(leaves[0]):
        return [lane_slice(stack, i) for i in range(n)]
    from repro_torch.distributed.sharding import constrain
    cols = [[constrain(x, x.device_mesh, x.placements)
             for x in torch.unbind(_unbindable(t), 0)] for t in leaves]
    return [tree_unflatten(stack, [c[i] for c in cols]) for i in range(n)]


def _unbindable(t):
    """A stacked DTensor leaf ``t`` with its layer dim (0) whole: the mesh
    dims that shard it replicate it instead, its gradient going back to
    ``t``'s placements (``sharding.constrain``); ``t`` itself where none
    does. Such a leaf is a few KB (an (L, nh) vector stack)."""
    from torch.distributed.tensor import Replicate, Shard
    if Shard(0) not in t.placements:
        return t
    from repro_torch.distributed.sharding import constrain
    return constrain(t, t.device_mesh,
                     [Replicate() if p == Shard(0) else p
                      for p in t.placements], t.placements)


def _depth(tree) -> int:
    """The length of the leading L axis of a stacked tree."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


class _Recompute(torch.autograd.Function):
    """``fn(*ints, *tensors)`` whose backward recomputes ``fn`` from its
    saved inputs (``torch.func.vjp`` over ``tensors``) instead of keeping
    its intermediates. ``ints``, the first ``n_int`` inputs (integer:
    positions, M-RoPE positions), are inputs but get no gradient; ``fn``
    closes over every non-tensor argument. A tensor made inside the
    transforms may not be closed over: the Function's forward runs a level
    below them.

    The backward recomputes from detached inputs: ``torch.func.grad``
    differentiates with ``create_graph=True``, so a recompute from the
    saved tensors themselves would be recorded for a second derivative,
    and every block's recompute would stay alive until the whole backward
    ends, which is what remat is there to avoid. So the Function has a
    first derivative only.

    ``fn`` returns one tensor or a tuple (a moe block's x and router
    loss); the backward takes every output's cotangent into one vjp."""
    generate_vmap_rule = True

    @staticmethod
    def forward(fn, n_int, *inputs):
        return fn(*inputs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn, ctx.n_int = inputs[:2]
        ctx.save_for_backward(*inputs[2:])

    @staticmethod
    def backward(ctx, *grads):
        saved = [t.detach() for t in ctx.saved_tensors]
        ints, tensors = saved[:ctx.n_int], saved[ctx.n_int:]
        gs = tuple(g.detach() for g in grads)
        if any(is_dtensor(t) for t in tensors):
            return (None, None, *([None] * ctx.n_int),
                    *_autograd_vjp(ctx.fn, ints, tensors, gs))
        _, vjp = torch.func.vjp(lambda *t: ctx.fn(*ints, *t), *tensors)
        return (None, None, *([None] * ctx.n_int),
                *vjp(gs if len(gs) > 1 else gs[0]))


def _autograd_vjp(fn, ints, tensors, grads) -> tuple:
    """The vjp of ``fn(*ints, *tensors)`` by ``torch.autograd`` (for
    DTensors: their ``local_map`` regions do not see through
    ``torch.func``'s wrappers); an input that does not reach the output
    gets a zero gradient."""
    inputs = [t.requires_grad_(t.is_floating_point()) for t in tensors]
    with torch.enable_grad():
        out = fn(*ints, *inputs)
        out = out if isinstance(out, tuple) else (out,)
        # an output may not need grad (the router loss on a "model" rank
        # other than 0 of an expert-parallel block)
        pairs = [(o, g) for o, g in zip(out, grads) if o.requires_grad]
        need = [i for i, t in enumerate(inputs) if t.requires_grad]
        got = torch.autograd.grad([o for o, _ in pairs],
                                  [inputs[i] for i in need],
                                  [g for _, g in pairs], allow_unused=True)
    res = [None] * len(inputs)
    for i, g in zip(need, got):
        res[i] = torch.zeros_like(inputs[i]) if g is None else g
    return tuple(res)


def _remat_apply(fn, ints: tuple, x, tensors: tuple, pctx: ParallelCtx):
    """``_Recompute.apply(fn, len(ints), *ints, x, *tensors)``. Under a
    mesh the block's input x, which the Function keeps until its
    backward, is kept sharded over "model" too (``_saved_placements``),
    and gathered back where ``fn`` starts, in the forward and in the
    recompute; the gather's gradient is reduce-scattered to the shard
    there (``sharding.constrain``). A gather is exact: the values do not
    change."""
    saved = _saved_placements(x, pctx)
    if saved is None:
        return _Recompute.apply(fn, len(ints), *ints, x, *tensors)
    from repro_torch.distributed.sharding import constrain
    mesh, whole, n = pctx.mesh, list(x.placements), len(ints)

    def gathered(*args):
        return fn(*args[:n], constrain(args[n], mesh, whole, saved),
                  *args[n + 1:])
    return _Recompute.apply(gathered, n, *ints, constrain(x, mesh, saved),
                            *tensors)


def _saved_placements(x, pctx: ParallelCtx):
    """Placements that keep a block input x (B, S, d), replicated over
    "model", sharded over it along d; None without a mesh, with a "model"
    axis of size 1, or where "model" does not divide d."""
    if pctx.mesh is None or not is_dtensor(x):
        return None
    from torch.distributed.tensor import Replicate, Shard
    m = pctx.mesh.mesh_dim_names.index("model")
    k = pctx.mesh.shape[m]
    if k == 1 or x.placements[m] != Replicate() or x.shape[-1] % k:
        return None
    out = list(x.placements)
    out[m] = Shard(x.ndim - 1)
    return out


def _remat_block(p: dict, x, cfg: ModelConfig, kind: str, *, positions,
                 mrope_positions=None, enc_memory=None, **kw):
    """``block_fwd`` under ``_Recompute``, returning (x, aux): the
    positions (and M-RoPE positions) ride as integer inputs, x (and the
    encoder memory) and the block's params as a flat tuple of tensors,
    window, impl and the rest in the closure. A moe block's router loss is
    the Function's second output; the other kinds' aux is 0."""
    ints = (positions,) if mrope_positions is None else (positions,
                                                         mrope_positions)
    mems = () if enc_memory is None else (enc_memory,)

    def fn(*args):
        n = len(ints)
        x, rest = args[n], args[n + 1:]
        out, _, aux = block_fwd(
            tree_unflatten(p, rest[len(mems):]), x, cfg, kind,
            positions=args[0], mrope_positions=args[1] if n == 2 else None,
            enc_memory=rest[0] if mems else None, **kw)
        return (out, aux) if kind == "moe" else out
    out = _remat_apply(fn, ints, x, (*mems, *tree_leaves(p)), kw["pctx"])
    if kind == "moe":
        return out
    return out, torch.zeros((), dtype=torch.float32, device=x.device)


def run_stack(params_stack: dict, x, cfg: ModelConfig, kind: str, *,
              positions, window: int = 0, causal: bool = True,
              caches: Any = None, pctx: ParallelCtx,
              route_rows: bool = False, mrope_positions=None,
              enc_memory=None):
    """Run the L stacked layers in order. Returns (x, caches, aux): aux is
    the sum of the blocks' router losses; ``caches`` (stacked on L) is
    updated in place; ``route_rows`` as in ``block_fwd``. A cross stack's
    prefill (``enc_memory`` and caches given) replaces the caches'
    "cross_k"/"cross_v" with the layers' projections of the memory,
    stacked (L, B, Se, Hkv, D), as the reference's scan returns them: a
    decode step attends over exactly those Se rows. With ``cfg.remat`` and no caches, a block whose
    result autograd needs runs under ``_Recompute``; a Mamba2 block there
    takes the scan autograd takes ("chunked", as the reference's model
    always does) in its forward too, where grad mode is off."""
    remat = _remat(cfg, caches, x, params_stack)
    if remat and kind == "ssm":
        pctx = _ssm_grad_pctx(pctx, x.device)
    kw = dict(positions=positions, window=window, causal=causal, pctx=pctx,
              route_rows=route_rows, mrope_positions=mrope_positions,
              enc_memory=enc_memory)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cross = []
    for i, layer in enumerate(_per_layer(params_stack)):
        if remat:
            x, a = _remat_block(layer, x, cfg, kind, **kw)
            aux = aux + a
            continue
        cache_l = None if caches is None else lane_slice(caches, i)
        x, cache_l, a = block_fwd(layer, x, cfg, kind, cache=cache_l, **kw)
        aux = aux + a
        if kind == "cross" and caches is not None and enc_memory is not None:
            cross.append((cache_l["cross_k"], cache_l["cross_v"]))
    if cross:
        caches["cross_k"] = torch.stack([k for k, _ in cross])
        caches["cross_v"] = torch.stack([v for _, v in cross])
    return x, caches, aux


def _remat(cfg: ModelConfig, caches, x, params) -> bool:
    """Whether remat applies: ``cfg.remat``, no caches, and autograd needs
    the result."""
    return (cfg.remat and caches is None
            and ssm.needs_grad(x, *tree_leaves(params)))


def _ssm_grad_pctx(pctx: ParallelCtx, device) -> ParallelCtx:
    """``pctx`` for Mamba2 blocks under remat: with no impl given, the scan
    autograd takes ("chunked"), so a recompute Function's forward, which
    runs with grad off, takes it too."""
    if pctx.attn_impl is not None:
        return pctx
    return dataclasses.replace(pctx, attn_impl=ssm.scan_impl(device, True))


# ---------------------------------------------------------------------------
# hybrid (zamba2): superblocks of (period x Mamba2) + the shared attn block
# ---------------------------------------------------------------------------

def hybrid_layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_super, period, n_tail): num_layers = n_super*period + n_tail."""
    period = cfg.hybrid_attn_period
    n_super = cfg.num_layers // period
    return n_super, period, cfg.num_layers - n_super * period


def init_hybrid(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    """The Mamba2 blocks stacked (n_super, period, ...), the one shared
    attention+MLP block unstacked, and the tail stacked (n_tail, ...)."""
    n_super, period, n_tail = hybrid_layout(cfg)
    scanned = init_stack(gen, cfg, "ssm", n_super * period, dtype)
    p = {"blocks": tree_map(
        lambda a: a.reshape(n_super, period, *a.shape[1:]), scanned),
        "shared": init_block(gen, cfg, "dense", dtype)}
    if n_tail:
        p["tail"] = init_stack(gen, cfg, "ssm", n_tail, dtype)
    return p


def run_hybrid(params: dict, x, cfg: ModelConfig, *, positions,
               window: int = 0, caches: Any = None, pctx: ParallelCtx):
    """Each superblock runs its ``period`` Mamba2 blocks, then the shared
    block; then the tail. caches = {"ssm": (n_super, period, B, ...),
    "attn": (n_super, B, ...), "tail": (n_tail, B, ...)} or None, updated
    in place. Returns (x, caches, aux).

    With ``cfg.remat`` and autograd needing the result, each superblock
    runs under ``_Recompute`` (the shared block's params an input of every
    one, so their gradient sums over the superblocks) and the tail block by
    block (``run_stack``). Inside, the Mamba2 blocks take the chunked scan
    in both passes (``_ssm_grad_pctx``); the shared attention keeps
    ``pctx``'s path (B3 on ``cuda``). No block of the hybrid has a router,
    so its aux is 0 and the Function has one output."""
    n_super, period, n_tail = hybrid_layout(cfg)
    kw = dict(positions=positions, window=window, pctx=pctx)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    supers = _per_layer(params["blocks"])
    if _remat(cfg, caches, x, params):
        for s in range(n_super):
            x = _remat_superblock(supers[s], params["shared"], x, cfg, **kw)
        if n_tail:
            x, _, aux = run_stack(params["tail"], x, cfg, "ssm", **kw)
        return x, None, aux
    for s in range(n_super):
        ssm_c = None if caches is None else lane_slice(caches["ssm"], s)
        x, _, a = run_stack(supers[s], x, cfg, "ssm",
                            caches=ssm_c, **kw)
        attn_c = None if caches is None else lane_slice(caches["attn"], s)
        x, _, a2 = block_fwd(params["shared"], x, cfg, "dense",
                             causal=True, cache=attn_c, **kw)
        aux = aux + a + a2
    if n_tail:
        x, _, a = run_stack(params["tail"], x, cfg, "ssm",
                            caches=None if caches is None
                            else caches["tail"], **kw)
        aux = aux + a
    return x, caches, aux


def _remat_superblock(blocks: dict, shared: dict, x, cfg: ModelConfig, *,
                      positions, window: int, pctx: ParallelCtx):
    """One superblock (its ``period`` Mamba2 blocks, then the shared block)
    under ``_Recompute``: positions as the integer input, x, the blocks'
    and the shared block's params as tensors."""
    n = len(tree_leaves(blocks))
    ssm_pctx = _ssm_grad_pctx(pctx, x.device)

    def fn(pos, h, *leaves):
        h, _, _ = run_stack(tree_unflatten(blocks, leaves[:n]), h, cfg, "ssm",
                            positions=pos, window=window, pctx=ssm_pctx)
        h, _, _ = block_fwd(tree_unflatten(shared, leaves[n:]), h, cfg,
                            "dense", positions=pos, window=window,
                            causal=True, pctx=pctx)
        return h
    return _remat_apply(fn, (positions,), x, (*tree_leaves(blocks),
                                              *tree_leaves(shared)), pctx)
