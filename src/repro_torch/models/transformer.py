"""Decoder-only stacks of the dense, moe and ssm kinds, and the zamba2-style
hybrid (Mamba2 backbone + one SHARED attention block applied periodically):
port of those branches of ``repro.models.transformer``.

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
result, so every no-grad path (serving) runs as before. Remat with grad
on a moe block or a hybrid stack raises: ``_Recompute`` carries a block's x
and not its router loss, so the loss's gradient into the router would be
lost (the moe and hybrid training path, ROADMAP A.12).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.packing import (lane_slice, tree_leaves,
                                     tree_map, tree_unflatten)
from repro_torch.models import attention, layers, moe, ssm

_TRAINING_MESSAGE = ("remat with grad on the {} family waits for the moe and "
                     "hybrid training path (ROADMAP A.12); build the config "
                     "with remat=False")


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
    ep          — expert parallelism; waits for ROADMAP A.10 and raises
    """
    attn_impl: Optional[str] = None
    score_bf16: bool = False
    moe_oracle: bool = False
    ep: bool = False

    def __post_init__(self):
        if self.ep:
            raise NotImplementedError(moe._EP_MESSAGE)


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
                   causal: bool, cache=None, pctx: ParallelCtx):
    return attention.attention_block(
        p["attn"], layers.rms_norm(x, p["ln1"], cfg.norm_eps),
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, positions=positions,
        rope_theta=cfg.rope_theta, causal=causal, window=window,
        kv_cache=cache, impl=pctx.attn_impl,
        prob_dtype=torch.bfloat16 if pctx.score_bf16 else torch.float32)


def _write(cache: dict, new: dict) -> None:
    """Copy a layer's new decode state into its (stacked) cache views."""
    tree_map(lambda dst, src: dst.copy_(src), cache, new)


def block_fwd(p: dict, x, cfg: ModelConfig, kind: str, *, positions,
              window: int = 0, causal: bool = True, cache=None,
              pctx: ParallelCtx, route_rows: bool = False):
    """One block of ``kind`` ("dense", "moe" or "ssm"). Returns (x, cache,
    aux): aux is the MoE router loss (0 for the other kinds); a given cache
    is updated in place. ``route_rows``: a moe block routes each batch row
    alone (``moe.moe_ffn``)."""
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
        return x + y, cache, aux
    out, cache = attn_block_fwd(p, x, cfg, positions=positions, window=window,
                                causal=causal, cache=cache, pctx=pctx)
    x = x + out
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    if kind == "moe":
        y, aux = moe.moe_ffn(p["moe"], h, cfg.moe,
                             dense_params=p.get("dense_mlp"),
                             oracle=pctx.moe_oracle,
                             route_rows=route_rows)
    else:
        y = layers.mlp(p["mlp"], h, cfg.mlp_type)
    return x + y, cache, aux


def _depth(tree) -> int:
    """The length of the leading L axis of a stacked tree."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


class _Recompute(torch.autograd.Function):
    """``fn(positions, *tensors)`` whose backward recomputes ``fn`` from its
    saved inputs (``torch.func.vjp`` over ``tensors``) instead of keeping
    its intermediates. ``positions`` (integer) is an input but gets no
    gradient; ``fn`` closes over every non-tensor argument. A tensor made
    inside the transforms may not be closed over: the Function's forward
    runs a level below them.

    The backward recomputes from detached inputs: ``torch.func.grad``
    differentiates with ``create_graph=True``, so a recompute from the
    saved tensors themselves would be recorded for a second derivative,
    and every block's recompute would stay alive until the whole backward
    ends, which is what remat is there to avoid. So the Function has a
    first derivative only."""
    generate_vmap_rule = True

    @staticmethod
    def forward(fn, positions, *tensors):
        return fn(positions, *tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, g):
        positions, *tensors = (t.detach() for t in ctx.saved_tensors)
        _, vjp = torch.func.vjp(lambda *t: ctx.fn(positions, *t), *tensors)
        return (None, None, *vjp(g.detach()))


def _remat_block(p: dict, x, cfg: ModelConfig, kind: str, *, positions,
                 **kw):
    """``block_fwd``'s x under ``_Recompute``: the block's params ride as a
    flat tuple of tensors, window, impl and the rest in the closure."""
    def fn(positions, x, *leaves):
        out, _, _ = block_fwd(tree_unflatten(p, leaves), x, cfg, kind,
                              positions=positions, **kw)
        return out
    return _Recompute.apply(fn, positions, x, *tree_leaves(p))


def run_stack(params_stack: dict, x, cfg: ModelConfig, kind: str, *,
              positions, window: int = 0, causal: bool = True,
              caches: Any = None, pctx: ParallelCtx,
              route_rows: bool = False):
    """Run the L stacked layers in order. Returns (x, caches, aux): aux is
    the sum of the blocks' router losses; ``caches`` (stacked on L) is
    updated in place; ``route_rows`` as in ``block_fwd``. With ``cfg.remat`` and no caches, a block whose
    result autograd needs runs under ``_Recompute``; a Mamba2 block there
    takes the scan autograd takes ("chunked", as the reference's model
    always does) in its forward too, where grad mode is off."""
    remat = _remat(cfg, caches, x, params_stack)
    if remat and kind == "moe":
        raise NotImplementedError(_TRAINING_MESSAGE.format("moe"))
    if remat and kind == "ssm" and pctx.attn_impl is None:
        pctx = dataclasses.replace(pctx,
                                   attn_impl=ssm.scan_impl(x.device, True))
    kw = dict(positions=positions, window=window, causal=causal, pctx=pctx,
              route_rows=route_rows)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(_depth(params_stack)):
        if remat:
            x = _remat_block(lane_slice(params_stack, i), x, cfg, kind, **kw)
            continue
        cache_l = None if caches is None else lane_slice(caches, i)
        x, _, a = block_fwd(lane_slice(params_stack, i), x, cfg, kind,
                            cache=cache_l, **kw)
        aux = aux + a
    return x, caches, aux


def _remat(cfg: ModelConfig, caches, x, params) -> bool:
    """Whether remat applies: ``cfg.remat``, no caches, and autograd needs
    the result."""
    return (cfg.remat and caches is None
            and ssm.needs_grad(x, *tree_leaves(params)))


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
    in place. Returns (x, caches, aux)."""
    if _remat(cfg, caches, x, params):
        raise NotImplementedError(_TRAINING_MESSAGE.format("hybrid"))
    n_super, period, n_tail = hybrid_layout(cfg)
    kw = dict(positions=positions, window=window, pctx=pctx)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for s in range(n_super):
        ssm_c = None if caches is None else lane_slice(caches["ssm"], s)
        x, _, a = run_stack(lane_slice(params["blocks"], s), x, cfg, "ssm",
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
