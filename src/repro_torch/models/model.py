"""Public model API for the decoder LM families: dense, moe, ssm and hybrid
(port of ``repro.models.model``; the encdec and vlm families raise
``NotImplementedError``, ROADMAP A.7).

Batch layouts (integer tensors):
  train    {"tokens": (B,S), "labels": (B,S)}
  prefill  {"tokens": (B,S)}
  decode   {"tokens": (B,1), "pos": (B,)}

The decode cache is stacked on a leading L axis with the batch (the serving
pool's lanes) on axis 1: per layer a ring KV cache for dense and moe, and
for ssm the Mamba2 decode state {"conv": (L,B,w-1,ch) compute dtype, "ssm":
(L,B,nh,hd,N) f32}. The hybrid's keeps the reference's nested layout,
{"ssm": (n_super, period, B, ...), "attn": (n_super, B, ...), "tail":
(n_tail, B, ...)}, so its Mamba2 states have the batch on axis 2
(``cache_lane_axes``). An ssm or hybrid prefill needs S % min(chunk, S) ==
0, as in the reference.

A moe model routes the whole batch of a call jointly, as the reference's
does; ``decode_step(..., route_rows=True)`` routes each row alone, as the
reference's server does by decoding each lane at batch 1 under vmap.

``Model`` runs on ``cuda`` unless it is given another device; it raises when
no card is present and the caller asked for none.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers, ssm, transformer
from repro_torch.models.transformer import ParallelCtx

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, ``cuda`` when None; raises when CUDA is
    asked for (or defaulted to) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


class Model:
    def __init__(self, cfg: ModelConfig, pctx: Optional[ParallelCtx] = None,
                 window: Optional[int] = None, device=None):
        if cfg.family not in _FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r}: only the dense, moe, ssm and "
                f"hybrid families are ported (ROADMAP A.7)")
        self.cfg = cfg
        self.pctx = pctx or ParallelCtx()
        self.window = cfg.sliding_window if window is None else window
        self.pdt = _DTYPES[cfg.param_dtype]
        self.cdt = _DTYPES[cfg.compute_dtype]
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Random params drawn from ``generator``, which must live on the
        model's device (``torch.Generator(device=...).manual_seed(s)``)."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        cfg = self.cfg
        V = cfg.padded_vocab
        p: Dict[str, Any] = {
            "embed": layers.embed_init(generator, V, cfg.d_model, self.pdt),
            "final_ln": torch.ones((cfg.d_model,), dtype=self.pdt,
                                   device=generator.device),
        }
        if not cfg.tie_embeddings:
            p["unembed"] = layers.dense_init(generator, cfg.d_model, V,
                                             self.pdt)
        if cfg.family == "hybrid":
            p["hybrid"] = transformer.init_hybrid(generator, cfg, self.pdt)
        else:
            p["blocks"] = transformer.init_stack(generator, cfg, cfg.family,
                                                 cfg.num_layers, self.pdt)
        return p

    # ------------------------------------------------------------- backbone
    def _embed_in(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (h, positions)."""
        tok = batch["tokens"]
        B, S = tok.shape
        h = params["embed"][tok].to(self.cdt)
        steps = torch.arange(S, device=tok.device)
        if "pos" in batch:
            positions = batch["pos"][:, None] + steps[None, :]
        else:
            positions = steps.expand(B, S)
        return h, positions

    def _head(self, params, h) -> torch.Tensor:
        h = layers.rms_norm(h, params["final_ln"], self.cfg.norm_eps)
        w = (params["embed"].T if self.cfg.tie_embeddings
             else params["unembed"]).to(self.cdt)
        return (h @ w).float()

    def _backbone(self, params, h, positions, caches=None,
                  route_rows: bool = False):
        """Returns (h, caches, aux)."""
        if self.cfg.family == "hybrid":
            return transformer.run_hybrid(
                params["hybrid"], h, self.cfg, positions=positions,
                window=self.window, caches=caches, pctx=self.pctx)
        return transformer.run_stack(
            params["blocks"], h, self.cfg, self.cfg.family,
            positions=positions, window=self.window, causal=True,
            caches=caches, pctx=self.pctx, route_rows=route_rows)

    # ----------------------------------------------------------------- loss
    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """(total, {"loss", "ce", "aux"}): mean token cross-entropy over
        the labels. ``aux`` is the sum of the MoE blocks' router losses, 0
        for the other families; the total is ce + router_aux_coef * aux."""
        h, positions = self._embed_in(params, batch)
        h, _, aux = self._backbone(params, h, positions)
        logits = self._head(params, h)
        ce = layers.cross_entropy_loss(logits, batch["labels"])
        coef = self.cfg.moe.router_aux_coef if self.cfg.moe else 0.0
        total = ce + coef * aux
        return total, {"loss": total, "ce": ce, "aux": aux}

    # ------------------------------------------------------------- serving
    def make_cache(self, batch_size: int, max_len: int) -> Dict[str, Any]:
        """Decode cache, every leaf stacked on leading layer axes."""
        cfg = self.cfg
        attn_len = min(max_len, self.window) if self.window else max_len

        def stack(one, *prefix):
            return {name: leaf.expand(*prefix, *leaf.shape).clone()
                    for name, leaf in one.items()}

        def kv(*prefix):
            return stack(attention.init_kv_cache(
                batch_size, attn_len, cfg.num_kv_heads,
                cfg.resolved_head_dim, self.cdt, self.device), *prefix)

        def states(*prefix):
            return stack(ssm.init_decode_state(
                batch_size, cfg.d_model, cfg.ssm, self.cdt, self.device),
                *prefix)

        if cfg.family == "ssm":
            return states(cfg.num_layers)
        if cfg.family == "hybrid":
            n_super, period, n_tail = transformer.hybrid_layout(cfg)
            c = {"ssm": states(n_super, period), "attn": kv(n_super)}
            if n_tail:
                c["tail"] = states(n_tail)
            return c
        return kv(cfg.num_layers)

    def cache_lane_axes(self) -> Dict[str, Any]:
        """The batch (lane) axis of each leaf of ``make_cache``'s tree, as a
        tree of ints: 2 under the hybrid's "ssm" (its leaves are stacked
        (n_super, period, B, ...)), 1 everywhere else."""
        cfg = self.cfg
        kv = dict.fromkeys(("k", "v", "len", "pos"), 1)
        states = dict.fromkeys(("conv", "ssm"), 1)
        if cfg.family == "ssm":
            return states
        if cfg.family == "hybrid":
            c = {"ssm": dict.fromkeys(states, 2), "attn": kv}
            if transformer.hybrid_layout(cfg)[2]:
                c["tail"] = states
            return c
        return kv

    def prefill(self, params, batch, max_len: int):
        """Full-sequence forward filling a fresh cache. Returns
        (last_logits (B,V) f32, cache)."""
        h, positions = self._embed_in(params, batch)
        cache = self.make_cache(h.shape[0], max_len)
        h, cache, _ = self._backbone(params, h, positions, caches=cache)
        logits = self._head(params, h[:, -1:])
        return logits[:, 0], cache

    def decode_step(self, params, batch, cache, route_rows: bool = False):
        """One-token step. Returns (logits (B,V) f32, cache); ``cache`` is
        updated in place. ``route_rows`` routes each row's token through
        the MoE blocks alone (capacity sized for one token), so a row's
        result does not depend on the other rows; by default the batch is
        routed jointly, as the reference's ``decode_step``."""
        tok = batch["tokens"]                              # (B,1)
        h = params["embed"][tok].to(self.cdt)
        positions = batch["pos"][:, None]                  # (B,1)
        h, cache, _ = self._backbone(params, h, positions, caches=cache,
                                     route_rows=route_rows)
        logits = self._head(params, h)
        return logits[:, 0], cache


def build_model(cfg: ModelConfig, pctx: Optional[ParallelCtx] = None,
                window: Optional[int] = None, device=None) -> Model:
    return Model(cfg, pctx=pctx, window=window, device=device)
