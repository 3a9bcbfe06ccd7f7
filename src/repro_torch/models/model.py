"""Public model API for every family: dense, moe, ssm, hybrid, vlm and
encdec (port of ``repro.models.model``).

Batch layouts (integer tensors):
  train   LM      {"tokens": (B,S), "labels": (B,S)}
          vlm     {"embeds": (B,S,d) compute dtype, "mrope_pos": (3,B,S),
                   "labels": (B,S)}
          encdec  {"enc_embeds": (B,Se,d) compute dtype, "tokens": (B,S),
                   "labels": (B,S)}
  prefill         same minus labels
  decode  LM      {"tokens": (B,1), "pos": (B,)}
          vlm     + {"mrope_pos": (3,B,1)}
          encdec  {"tokens": (B,1), "pos": (B,)} (cross K/V cached)

The vlm's "embeds" stand for its vision frontend's output (text rows are
embedding rows), and "mrope_pos" holds its (t, h, w) position streams;
encdec's "enc_embeds" stand for its speech frontend's frames.

The decode cache is stacked on a leading L axis with the batch (the serving
pool's lanes) on axis 1: per layer a ring KV cache for dense, moe and vlm,
and for ssm the Mamba2 decode state {"conv": (L,B,w-1,ch) compute dtype,
"ssm": (L,B,nh,hd,N) f32}. The encdec cache is {"self": ring KV caches,
"cross_k", "cross_v": (L,B,max_len,Hkv,D)}; its prefill replaces the
cross leaves with the encoder memory's projections, (L,B,Se,Hkv,D), which
decode attends over. The hybrid's keeps the reference's nested layout,
{"ssm": (n_super, period, B, ...), "attn": (n_super, B, ...), "tail":
(n_tail, B, ...)}, so its Mamba2 states have the batch on axis 2
(``cache_lane_axes``). An ssm or hybrid prefill needs S % min(chunk, S) ==
0, as in the reference.

A moe model routes the whole batch of a call jointly, as the reference's
does; ``decode_step(..., route_rows=True)`` routes each row alone, as the
reference's server does by decoding each lane at batch 1 under vmap.

``Model`` runs on ``cuda`` unless it is given another device; it raises when
no card is present and the caller asked for none. On ``meta`` (the
dry-run) it computes shapes only.

Under a mesh (``ParallelCtx(mesh=...)``) the params, the batch and the
cache are DTensors (``distributed.sharding``'s placements): the model's
ops run as DTensor ops, and the regions without a sharding rule (the
attention between its projections, the scan, the routed experts, the
head's product and the loss) run under ``local_map``. ``make_cache``
then makes the cache sharded as ``batch_shardings`` says.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core import spans
from repro_torch.models import attention, layers, ssm, transformer
from repro_torch.models.transformer import ParallelCtx

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
# the block kind each family's (decoder) stack runs
_KINDS = {"dense": "dense", "vlm": "dense", "moe": "moe", "ssm": "ssm",
          "encdec": "cross", "hybrid": None}


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, ``cuda`` when None; raises when CUDA is
    asked for (or defaulted to) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


class Model:
    def __init__(self, cfg: ModelConfig, pctx: Optional[ParallelCtx] = None,
                 window: Optional[int] = None, device=None):
        if cfg.family not in _KINDS:
            raise ValueError(f"unknown family {cfg.family!r}")
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
            return p
        if cfg.family == "encdec":
            p["encoder"] = transformer.init_stack(
                generator, cfg, "dense", cfg.num_encoder_layers, self.pdt)
            p["enc_ln"] = torch.ones((cfg.d_model,), dtype=self.pdt,
                                     device=generator.device)
        p["blocks"] = transformer.init_stack(generator, cfg, self._kind(),
                                             cfg.num_layers, self.pdt)
        return p

    # ------------------------------------------------------------- backbone
    def _kind(self) -> str:
        return _KINDS[self.cfg.family]

    def _steps(self, S: int, like, B: int = 0):
        """arange(S) on ``like``'s device, or with ``B`` the (B, S)
        positions of a batch. Under a mesh (``like`` a DTensor) a DTensor:
        the steps replicated, the positions with the batch over the data
        axes where they divide it."""
        if not transformer.is_dtensor(like):
            steps = torch.arange(S, device=like.device)
            return steps.expand(B, S) if B else steps
        from torch.distributed.tensor import DTensor
        from repro_torch.distributed.sharding import (batch_dim,
                                                      dim_placements, dp_size)
        mesh = self.pctx.mesh
        steps = torch.arange(S, device=like.to_local().device)
        if not B:
            return DTensor.from_local(steps, mesh, dim_placements(mesh),
                                      run_check=False)
        rows = B if batch_dim(mesh, B) is None else B // dp_size(mesh)
        return DTensor.from_local(steps.expand(rows, S), mesh,
                                  transformer.act_placements(mesh, B),
                                  run_check=False, shape=(B, S),
                                  stride=(0, 1))

    def _encode(self, params, enc_embeds) -> torch.Tensor:
        """Bidirectional encoder over precomputed frame embeddings, then
        the final ``enc_ln`` RMSNorm."""
        B, Se, _ = enc_embeds.shape
        pos = self._steps(Se, enc_embeds, B)
        h, _, _ = transformer.run_stack(
            params["encoder"], enc_embeds.to(self.cdt), self.cfg, "dense",
            positions=pos, causal=False, pctx=self.pctx)
        return layers.rms_norm(h, params["enc_ln"], self.cfg.norm_eps)

    def _embed(self, params, tok) -> torch.Tensor:
        """Embedding rows of ``tok`` (``F.embedding``: the reference's
        indexing, whose DTensor rule, unlike indexing's, keeps a
        vocab-sharded table sharded under a mesh: each rank looks up the
        rows it holds and the lookups are summed; one op on both paths, so
        a step on one rank's mesh and the same step unsharded run the same
        backward)."""
        h = torch.nn.functional.embedding(tok, params["embed"]).to(self.cdt)
        return transformer._constrain_act(h, self.pctx)

    def _embed_in(self, params, batch) -> Tuple[torch.Tensor, ...]:
        """Returns (h, positions, mrope_positions or None)."""
        if "embeds" in batch:  # vlm stub frontend
            h = batch["embeds"].to(self.cdt)
            B, S, _ = h.shape
        else:
            tok = batch["tokens"]
            B, S = tok.shape
            h = self._embed(params, tok)
        if "pos" in batch:
            positions = batch["pos"][:, None] + self._steps(S, h)[None, :]
        else:
            positions = self._steps(S, h, B)
        return h, positions, batch.get("mrope_pos")

    def _head(self, params, h) -> torch.Tensor:
        """Final norm and the logits (f32). Under a mesh the product runs
        under ``local_map``, the vocab over "model" and the batch over the
        data axes where they divide it, as the reference's ``shard_map``
        head: GSPMD's dot partitioner made full-vocab (B, S, V) f32
        tensors there. A rank's gradient of h is its vocab shard's share
        (partial over "model"); its gradient of the weight is its rows'
        share (partial over the data axes when they split the batch).
        The weight's cast to the compute dtype is counted in
        ``cast_bytes`` (``core.spans``), as ``layers.at_use`` counts."""
        h = layers.rms_norm(h, params["final_ln"], self.cfg.norm_eps)
        w = params["embed"].T if self.cfg.tie_embeddings \
            else params["unembed"]
        if w.dtype != self.cdt:
            spans.count("cast_bytes", w.numel() * w.element_size())
        w = w.to(self.cdt)
        if self.pctx.mesh is not None and transformer.is_dtensor(h):
            from torch.distributed.tensor.experimental import local_map

            from repro_torch.distributed.sharding import (batch_dim,
                                                          dim_placements)
            mesh = self.pctx.mesh
            bd = batch_dim(mesh, h.shape[0])
            fn = local_map(
                lambda hl, wl: hl @ wl,
                out_placements=dim_placements(mesh, data=bd, model=2),
                in_placements=(dim_placements(mesh, data=bd),
                               dim_placements(mesh, model=1)),
                in_grad_placements=(
                    dim_placements(mesh, data=bd, model_partial=True),
                    dim_placements(mesh, model=1,
                                   data_partial=bd is not None)),
                device_mesh=mesh, redistribute_inputs=True)
            return fn(h, w).float()
        return (h @ w).float()

    def _backbone(self, params, h, positions, caches=None,
                  route_rows: bool = False, mrope_positions=None,
                  enc_memory=None):
        """Returns (h, caches, aux)."""
        if self.cfg.family == "hybrid":
            return transformer.run_hybrid(
                params["hybrid"], h, self.cfg, positions=positions,
                window=self.window, caches=caches, pctx=self.pctx)
        return transformer.run_stack(
            params["blocks"], h, self.cfg, self._kind(),
            positions=positions, window=self.window, causal=True,
            caches=caches, pctx=self.pctx, route_rows=route_rows,
            mrope_positions=mrope_positions, enc_memory=enc_memory)

    # ----------------------------------------------------------------- loss
    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """(total, {"loss", "ce", "aux"}): mean token cross-entropy over
        the labels. ``aux`` is the sum of the MoE blocks' router losses, 0
        for the other families; the total is ce + router_aux_coef * aux."""
        h, positions, mrope = self._embed_in(params, batch)
        enc_memory = (self._encode(params, batch["enc_embeds"])
                      if self.cfg.is_encdec else None)
        h, _, aux = self._backbone(params, h, positions,
                                   mrope_positions=mrope,
                                   enc_memory=enc_memory)
        logits = self._head(params, h)
        ce = layers.cross_entropy_loss(logits, batch["labels"])
        coef = self.cfg.moe.router_aux_coef if self.cfg.moe else 0.0
        total = ce + coef * aux
        return total, {"loss": total, "ce": ce, "aux": aux}

    # ------------------------------------------------------------- serving
    def make_cache(self, batch_size: int, max_len: int,
                   device=None) -> Dict[str, Any]:
        """Decode cache, every leaf stacked on leading layer axes, on
        ``device`` (the model's by default; ``meta`` allocates nothing)."""
        device = self.device if device is None else torch.device(device)
        mesh = self.pctx.mesh
        if mesh is None:
            return self._cache(batch_size, max_len, device)
        # under a mesh the whole cache is laid out on meta, shapes only and
        # unseen by the dispatch modes that count a step, and each rank
        # makes only its own shard
        from torch.utils._python_dispatch import _disable_current_modes
        with _disable_current_modes():
            layout = self._cache(batch_size, max_len, torch.device("meta"))
        return _sharded_cache(layout, mesh, batch_size, device)

    def _cache(self, batch_size: int, max_len: int, device) -> Dict[str, Any]:
        cfg = self.cfg
        attn_len = min(max_len, self.window) if self.window else max_len

        def stack(one, *prefix):
            return {name: leaf.expand(*prefix, *leaf.shape).clone()
                    for name, leaf in one.items()}

        def kv(*prefix):
            return stack(attention.init_kv_cache(
                batch_size, attn_len, cfg.num_kv_heads,
                cfg.resolved_head_dim, self.cdt, device), *prefix)

        def states(*prefix):
            return stack(ssm.init_decode_state(
                batch_size, cfg.d_model, cfg.ssm, self.cdt, device),
                *prefix)

        if cfg.family == "ssm":
            return states(cfg.num_layers)
        if cfg.family == "hybrid":
            n_super, period, n_tail = transformer.hybrid_layout(cfg)
            c = {"ssm": states(n_super, period), "attn": kv(n_super)}
            if n_tail:
                c["tail"] = states(n_tail)
            return c
        if cfg.family == "encdec":
            cross = lambda: torch.zeros(
                (cfg.num_layers, batch_size, max_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim), dtype=self.cdt, device=device)
            return {"self": kv(cfg.num_layers), "cross_k": cross(),
                    "cross_v": cross()}
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
        if cfg.family == "encdec":
            return {"self": kv, "cross_k": 1, "cross_v": 1}
        return kv

    def prefill(self, params, batch, max_len: int):
        """Full-sequence forward filling a fresh cache. Returns
        (last_logits (B,V) f32, cache)."""
        h, positions, mrope = self._embed_in(params, batch)
        cache = self.make_cache(h.shape[0], max_len)
        enc_memory = (self._encode(params, batch["enc_embeds"])
                      if self.cfg.is_encdec else None)
        h, cache, _ = self._backbone(params, h, positions, caches=cache,
                                     mrope_positions=mrope,
                                     enc_memory=enc_memory)
        logits = self._head(params, h[:, -1:])
        return logits[:, 0], cache

    def decode_step(self, params, batch, cache, route_rows: bool = False):
        """One-token step. Returns (logits (B,V) f32, cache); ``cache`` is
        updated in place. ``route_rows`` routes each row's token through
        the MoE blocks alone (capacity sized for one token), so a row's
        result does not depend on the other rows; by default the batch is
        routed jointly, as the reference's ``decode_step``."""
        tok = batch["tokens"]                              # (B,1)
        h = self._embed(params, tok)
        positions = batch["pos"][:, None]                  # (B,1)
        h, cache, _ = self._backbone(params, h, positions, caches=cache,
                                     route_rows=route_rows,
                                     mrope_positions=batch.get("mrope_pos"))
        logits = self._head(params, h)
        return logits[:, 0], cache

    # --------------------------------------------------------- input specs
    def input_specs(self, shape: ShapeSpec) -> Dict[str, Any]:
        """Stand-ins for the batch of a shape cell: tensors on the ``meta``
        device (the reference's ``jax.ShapeDtypeStruct``), so nothing is
        allocated. For decode shapes, also the cache under "_cache"
        (``make_cache`` on ``meta``)."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        i32, d = torch.int32, cfg.d_model
        sds = lambda shp, dtype: torch.empty(shp, dtype=dtype, device="meta")
        if shape.kind in ("train", "prefill"):
            b = {"tokens": sds((B, S), i32), "labels": sds((B, S), i32)}
            if cfg.family == "vlm":
                b = {"embeds": sds((B, S, d), self.cdt),
                     "mrope_pos": sds((3, B, S), i32),
                     "labels": sds((B, S), i32)}
            if cfg.is_encdec:
                b = {"enc_embeds": sds((B, S, d), self.cdt),
                     "tokens": sds((B, S), i32), "labels": sds((B, S), i32)}
            if shape.kind == "prefill":
                b.pop("labels")
            return b
        # decode: one token + pre-filled cache
        b = {"tokens": sds((B, 1), i32), "pos": sds((B,), i32)}
        if cfg.family == "vlm":
            b["mrope_pos"] = sds((3, B, 1), i32)
        b["_cache"] = self.make_cache(B, S, device="meta")
        return b


def _sharded_cache(c, mesh, batch_size: int, device):
    """The cache ``c`` (built on ``meta``, shapes only) as DTensors placed
    by ``batch_shardings``, each rank making only its own shard on
    ``device`` (the whole cache is never made on one rank): "pos" slots
    start at -1, every other leaf at 0, as ``make_cache`` fills them."""
    from torch.distributed.tensor import DTensor

    from repro_torch.core.packing import tree_unflatten
    from repro_torch.distributed import sharding
    placements = sharding.flatten_with_path(
        sharding.batch_shardings(mesh, c, batch_size))
    leaves = []
    for (path, t), (_, p) in zip(sharding.flatten_with_path(c), placements):
        fill = -1 if path[-1] == "pos" else 0
        leaves.append(DTensor.from_local(
            torch.full(sharding.shard_shape(t.shape, mesh, p), fill,
                       dtype=t.dtype, device=device),
            mesh, p, run_check=False, shape=t.shape, stride=t.stride()))
    return tree_unflatten(c, leaves)


def build_model(cfg: ModelConfig, pctx: Optional[ParallelCtx] = None,
                window: Optional[int] = None, device=None) -> Model:
    return Model(cfg, pctx=pctx, window=window, device=device)
