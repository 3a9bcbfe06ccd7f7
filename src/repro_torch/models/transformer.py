"""Decoder-only transformer stack, dense kind (port of the dense branches of
``repro.models.transformer``).

Per-layer params and caches are stacked on a leading L axis, as in the
reference; its ``lax.scan`` over that axis becomes a Python loop that takes
views of layer l (``lane_slice``), so a cache written in place by a layer
lands in the stacked buffer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.packing import lane_slice, stack_trees
from repro_torch.models import attention, layers


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """How the forward pass should specialize.

    attn_impl   — prefill/train attention path ("kernel"|"chunked"|"plain";
                  None picks by device, see ``attention.default_impl``)
    score_bf16  — bf16 softmax probabilities in ``sdpa_chunked``'s PV product
    """
    attn_impl: Optional[str] = None
    score_bf16: bool = False


def init_block(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    hd = cfg.resolved_head_dim
    dev = gen.device
    return {
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "attn": attention.init_attention(
            gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, hd, dtype),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype),
    }


def init_stack(gen: torch.Generator, cfg: ModelConfig, n: int, dtype) -> dict:
    return stack_trees([init_block(gen, cfg, dtype) for _ in range(n)])


def attn_block_fwd(p: dict, x, cfg: ModelConfig, *, positions, window: int,
                   causal: bool, cache=None, pctx: ParallelCtx):
    return attention.attention_block(
        p["attn"], layers.rms_norm(x, p["ln1"], cfg.norm_eps),
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, positions=positions,
        rope_theta=cfg.rope_theta, causal=causal, window=window,
        kv_cache=cache, impl=pctx.attn_impl,
        prob_dtype=torch.bfloat16 if pctx.score_bf16 else torch.float32)


def block_fwd(p: dict, x, cfg: ModelConfig, *, positions, window: int = 0,
              causal: bool = True, cache=None, pctx: ParallelCtx):
    """Dense block. Returns (x, cache)."""
    out, cache = attn_block_fwd(p, x, cfg, positions=positions, window=window,
                                causal=causal, cache=cache, pctx=pctx)
    x = x + out
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + layers.mlp(p["mlp"], h, cfg.mlp_type), cache


def run_stack(params_stack: dict, x, cfg: ModelConfig, *, positions,
              window: int = 0, causal: bool = True, caches: Any = None,
              pctx: ParallelCtx):
    """Run the L stacked layers in order. Returns (x, caches); ``caches``
    (stacked on L) is updated in place."""
    for i in range(params_stack["ln1"].shape[0]):
        cache_l = None if caches is None else lane_slice(caches, i)
        x, _ = block_fwd(lane_slice(params_stack, i), x, cfg,
                         positions=positions, window=window, causal=causal,
                         cache=cache_l, pctx=pctx)
    return x, caches
