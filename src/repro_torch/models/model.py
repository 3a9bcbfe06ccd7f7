"""Public model API for the dense and ssm families (port of
``repro.models.model``; the other families raise ``NotImplementedError``).

Batch layouts (integer tensors):
  train    {"tokens": (B,S), "labels": (B,S)}
  prefill  {"tokens": (B,S)}
  decode   {"tokens": (B,1), "pos": (B,)}

The decode cache is stacked on a leading L axis with the batch (the serving
pool's lanes) on axis 1: per layer a ring KV cache for dense, and for ssm
the Mamba2 decode state {"conv": (L,B,w-1,ch) compute dtype, "ssm":
(L,B,nh,hd,N) f32}. An ssm prefill needs S % min(chunk, S) == 0, as in the
reference.

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
        if cfg.family not in ("dense", "ssm"):
            raise NotImplementedError(
                f"family {cfg.family!r}: only the dense and ssm families "
                f"are ported")
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

    def _backbone(self, params, h, positions, caches=None):
        return transformer.run_stack(
            params["blocks"], h, self.cfg, self.cfg.family,
            positions=positions, window=self.window, causal=True,
            caches=caches, pctx=self.pctx)

    # ----------------------------------------------------------------- loss
    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """(total, {"loss", "ce", "aux"}): mean token cross-entropy over
        the labels. ``aux`` is the MoE router loss of the reference, 0 for
        the dense and ssm families."""
        h, positions = self._embed_in(params, batch)
        h, _ = self._backbone(params, h, positions)
        logits = self._head(params, h)
        ce = layers.cross_entropy_loss(logits, batch["labels"])
        aux = torch.zeros((), dtype=torch.float32, device=ce.device)
        coef = self.cfg.moe.router_aux_coef if self.cfg.moe else 0.0
        total = ce + coef * aux
        return total, {"loss": total, "ce": ce, "aux": aux}

    # ------------------------------------------------------------- serving
    def make_cache(self, batch_size: int, max_len: int) -> Dict[str, Any]:
        """Decode cache, every leaf stacked on a leading L axis."""
        cfg = self.cfg
        if cfg.family == "ssm":
            one = ssm.init_decode_state(batch_size, cfg.d_model, cfg.ssm,
                                        self.cdt, self.device)
            return {name: leaf.expand(cfg.num_layers, *leaf.shape).clone()
                    for name, leaf in one.items()}
        attn_len = min(max_len, self.window) if self.window else max_len
        one = attention.init_kv_cache(
            batch_size, attn_len, cfg.num_kv_heads, cfg.resolved_head_dim,
            self.cdt, self.device)
        return {name: leaf.expand(cfg.num_layers, *leaf.shape).clone()
                for name, leaf in one.items()}

    def prefill(self, params, batch, max_len: int):
        """Full-sequence forward filling a fresh cache. Returns
        (last_logits (B,V) f32, cache)."""
        h, positions = self._embed_in(params, batch)
        cache = self.make_cache(h.shape[0], max_len)
        h, cache = self._backbone(params, h, positions, caches=cache)
        logits = self._head(params, h[:, -1:])
        return logits[:, 0], cache

    def decode_step(self, params, batch, cache):
        """One-token step. Returns (logits (B,V) f32, cache); ``cache`` is
        updated in place."""
        tok = batch["tokens"]                              # (B,1)
        h = params["embed"][tok].to(self.cdt)
        positions = batch["pos"][:, None]                  # (B,1)
        h, cache = self._backbone(params, h, positions, caches=cache)
        logits = self._head(params, h)
        return logits[:, 0], cache


def build_model(cfg: ModelConfig, pctx: Optional[ParallelCtx] = None,
                window: Optional[int] = None, device=None) -> Model:
    return Model(cfg, pctx=pctx, window=window, device=device)
