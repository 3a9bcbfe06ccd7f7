"""Decoder-only stacks of the dense and ssm kinds (port of those branches
of ``repro.models.transformer``).

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
result, so every no-grad path (serving) runs as before.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.packing import (lane_slice, stack_trees, tree_leaves,
                                     tree_map, tree_unflatten)
from repro_torch.models import attention, layers, ssm


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
    """
    attn_impl: Optional[str] = None
    score_bf16: bool = False


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
               dtype) -> dict:
    hd = cfg.resolved_head_dim
    dev = gen.device
    if kind == "ssm":
        return {"ln": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
                "mamba": ssm.init_mamba2(gen, cfg.d_model, cfg.ssm, dtype)}
    if kind != "dense":
        raise ValueError(kind)
    return {
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "attn": attention.init_attention(
            gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, hd, dtype),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype),
    }


def init_stack(gen: torch.Generator, cfg: ModelConfig, kind: str, n: int,
               dtype) -> dict:
    return stack_trees([init_block(gen, cfg, kind, dtype) for _ in range(n)])


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
              pctx: ParallelCtx):
    """One block of ``kind`` ("dense" or "ssm"). Returns (x, cache); a
    given cache is updated in place."""
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
        return x + y, cache
    out, cache = attn_block_fwd(p, x, cfg, positions=positions, window=window,
                                causal=causal, cache=cache, pctx=pctx)
    x = x + out
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + layers.mlp(p["mlp"], h, cfg.mlp_type), cache


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
        out, _ = block_fwd(tree_unflatten(p, leaves), x, cfg, kind,
                           positions=positions, **kw)
        return out
    return _Recompute.apply(fn, positions, x, *tree_leaves(p))


def run_stack(params_stack: dict, x, cfg: ModelConfig, kind: str, *,
              positions, window: int = 0, causal: bool = True,
              caches: Any = None, pctx: ParallelCtx):
    """Run the L stacked layers in order. Returns (x, caches); ``caches``
    (stacked on L) is updated in place. With ``cfg.remat`` and no caches, a
    block whose result autograd needs runs under ``_Recompute``; a Mamba2
    block there takes the scan autograd takes ("chunked", as the reference's
    model always does) in its forward too, where grad mode is off."""
    remat = (cfg.remat and caches is None
             and ssm.needs_grad(x, *tree_leaves(params_stack)))
    if remat and kind == "ssm" and pctx.attn_impl is None:
        pctx = dataclasses.replace(pctx,
                                   attn_impl=ssm.scan_impl(x.device, True))
    kw = dict(positions=positions, window=window, causal=causal, pctx=pctx)
    for i in range(_depth(params_stack)):
        if remat:
            x = _remat_block(lane_slice(params_stack, i), x, cfg, kind, **kw)
            continue
        cache_l = None if caches is None else lane_slice(caches, i)
        x, _ = block_fwd(lane_slice(params_stack, i), x, cfg, kind,
                         cache=cache_l, **kw)
    return x, caches
