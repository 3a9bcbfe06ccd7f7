"""Serving: prefill + continuously-batched decode on a lane pool.

Port of ``repro.launch.serve``. It is TRUE continuous batching:

  * the decode state is a fixed-capacity pool — per-lane decode caches (a
    KV cache per layer for attention, the conv and SSM state per layer for
    Mamba2) stacked on a lane axis — and a step decodes every lane in one
    call;
  * a request joins MID-DECODE the moment a lane frees: its prompt is
    prefilled at batch 1 and its cache copied into the free lane, other
    lanes undisturbed;
  * a finished lane stops burning decode budget — its request is retired
    immediately and the next queued request takes the lane, so total active
    lane-steps equal the sum of per-request ``max_new``.

The reference vmaps a batch-1 decode over a leading lane axis. Here the
lane axis is written out as the batch dimension of one ``decode_step``:
tokens (C,1), pos (C,), and every cache leaf has its lanes on its batch
axis (``Model.cache_lane_axes``: 1 under a leading L axis, 2 under the
hybrid's (n_super, period) Mamba2 states); each lane still carries its own
``len``/``pos``. The step routes each lane's token through the MoE blocks
alone (``decode_step(route_rows=True)``), as the reference's batch-1 decode
does, so an expert's capacity never couples co-resident requests.
Prompts are left-padded with token 0 to one length per ``run``, and the
padding is attended (or scanned), as in the reference; for Mamba2 that
length must be a multiple of the SSD chunk, or at most one chunk.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import packing, spans
from repro_torch.models.model import Model


def make_prefill(model: Model, max_len: int):
    """(params, batch) -> (last logits, cache)."""
    def prefill(params, batch):
        return model.prefill(params, batch, max_len=max_len)
    return prefill


def make_serve_step(model: Model):
    """(params, batch{tokens,pos[,mrope_pos]}, cache) -> (logits, cache)."""
    def serve_step(params, batch, cache):
        return model.decode_step(params, batch, cache)
    return serve_step


@dataclasses.dataclass
class Request:
    id: int
    prompt: np.ndarray            # (S,) int
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class ServeStats:
    """Decode accounting for the last ``BatchServer.run``."""
    global_steps: int = 0         # batched decode invocations
    lane_steps: int = 0           # tokens produced (invariant: Σ max_new)
    lane_slots: int = 0           # lane-slots stepped (Σ pool width/step)
    prefills: int = 0
    n_requests: int = 0
    resizes: int = 0              # adaptive lane-pool rebuilds
    lane_trace: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)     # (global_step, lane count) per resize
    prefill_s: float = 0.0        # host seconds in prefills, first token read
    decode_s: float = 0.0         # host seconds in decode steps, tokens read

    @property
    def occupancy(self) -> float:
        if not self.global_steps:
            return 0.0
        return self.lane_steps / self.global_steps

    @property
    def step_efficiency(self) -> float:
        """Fraction of stepped lane-slots that produced a kept token."""
        if not self.lane_slots:
            return 0.0
        return self.lane_steps / self.lane_slots


class BatchServer:
    """Greedy-decode server over a persistent lane pool.

    With ``adaptive_lanes`` the pool RESIZES to queue depth between decode
    steps: as the request tail drains, live lanes are compacted into a
    smaller pool (lane counts rounded to powers of two) so the step stops
    paying for dead lanes. Per-request tokens are unchanged.

    Traced (``core.spans``), each loop is a ``serve.iteration`` span
    holding ``serve.emit`` (emit and retire), ``serve.decode_step`` (and in
    it ``serve.read``, the tokens' read on the host), ``serve.resize``, and
    per request (``req``) ``serve.prefill``, at the bounds of
    ``ServeStats.prefill_s``, and ``serve.attach``, the lane write.
    """

    def __init__(self, model: Model, params, batch_lanes: int, max_len: int,
                 adaptive_lanes: bool = False):
        self.model = model
        self.params = params
        self.lanes = batch_lanes
        self.max_len = max_len
        self.adaptive_lanes = adaptive_lanes
        self.stats = ServeStats()

    @torch.inference_mode()
    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        queue = [r for r in list(requests) if r.max_new > 0]
        for r in requests:
            if r.max_new <= 0:
                r.done = True
        results: Dict[int, List[int]] = {r.id: r.out for r in requests}
        self.stats = ServeStats(n_requests=len(queue))
        if not queue:
            return results
        S_pad = max(len(r.prompt) for r in queue)
        # enqueue-time length guard: decode runs positions S_pad .. S_pad +
        # max_new - 2 (the first token comes from prefill), so a KV cache
        # must hold S_pad + max_new - 1 positions. The reference applies
        # it to every family, the SSM's fixed-size state included.
        for r in queue:
            if S_pad + r.max_new - 1 > self.max_len:
                raise ValueError(
                    f"request {r.id}: padded prompt ({S_pad}) + max_new "
                    f"({r.max_new}) needs {S_pad + r.max_new - 1} "
                    f"positions > max_len ({self.max_len}); shorten the "
                    f"prompt or raise max_len")
        C = min(self.lanes, len(queue))
        dev = self.model.device
        stats = self.stats
        axes = self.model.cache_lane_axes()

        def prefill_one(r: Request):
            toks = np.zeros((1, S_pad), np.int64)
            toks[0, S_pad - len(r.prompt):] = r.prompt   # left-pad
            with spans.span("serve.prefill", req=r.id):
                t0 = time.perf_counter()
                logits, cache = self.model.prefill(
                    self.params, {"tokens": torch.from_numpy(toks).to(dev)},
                    max_len=self.max_len)
                first = int(logits.argmax(-1)[0])
                stats.prefill_s += time.perf_counter() - t0
            stats.prefills += 1
            return first, packing.tree_get_lane(cache, 0, axes)

        # seed the pool from the first prefill so every leaf has its lane
        # axis before any swap (shapes fixed until an adaptive resize)
        first0, lane0 = prefill_one(queue[0])
        pool_cache = packing.stack_trees([lane0] * C, axes)
        cur = np.zeros((C,), np.int64)
        pos = np.full((C,), S_pad, np.int64)
        lane_req: List[Optional[Request]] = [None] * C

        def attach(lane: int, r: Request, first=None, cache=None):
            if first is None:
                first, cache = prefill_one(r)
            with spans.span("serve.attach", req=r.id):
                packing.tree_set_lane(pool_cache, lane, cache, axes)
            cur[lane] = first
            pos[lane] = S_pad
            lane_req[lane] = r

        def resize(new_c: int):
            """Compact live lanes into a pool of ``new_c`` lanes (per-lane
            state is copied unchanged)."""
            nonlocal pool_cache, cur, pos, lane_req, C
            live = [l for l, r in enumerate(lane_req) if r is not None]
            caches = [packing.tree_get_lane(pool_cache, l, axes)
                      for l in live]
            template = caches[0] if caches \
                else packing.tree_get_lane(pool_cache, 0, axes)
            new_cache = packing.stack_trees(
                caches + [template] * (new_c - len(caches)), axes)
            new_cur = np.zeros((new_c,), np.int64)
            new_pos = np.full((new_c,), S_pad, np.int64)
            new_req: List[Optional[Request]] = [None] * new_c
            for i, l in enumerate(live):
                new_cur[i] = cur[l]
                new_pos[i] = pos[l]
                new_req[i] = lane_req[l]
            pool_cache, cur, pos, lane_req, C = \
                new_cache, new_cur, new_pos, new_req, new_c
            stats.resizes += 1
            stats.lane_trace.append((stats.global_steps, new_c))

        attach(0, queue.pop(0), first0, lane0)
        for lane in range(1, C):
            if queue:
                attach(lane, queue.pop(0))

        while True:
            with spans.span("serve.iteration", step=stats.global_steps):
                # emit + retire phase: the token each active lane carries
                # came from the PREVIOUS step (or its prefill). Record it,
                # and retire lanes whose budget is now exhausted BEFORE
                # stepping.
                with spans.span("serve.emit"):
                    for lane, r in enumerate(lane_req):
                        if r is None:
                            continue
                        r.out.append(int(cur[lane]))
                        stats.lane_steps += 1
                        if len(r.out) >= r.max_new:
                            r.done = True    # lane frees NOW — no barrier
                            lane_req[lane] = None
                n_live = sum(1 for r in lane_req if r is not None)
                if n_live == 0 and not queue:
                    break
                if self.adaptive_lanes:
                    demand = n_live + len(queue)
                    desired = 1 << (max(1, demand) - 1).bit_length()
                    desired = min(self.lanes, max(desired, n_live, 1))
                    if desired < C:
                        with spans.span("serve.resize", lanes=desired):
                            resize(desired)
                if n_live:
                    active = np.array([r is not None for r in lane_req])
                    with spans.span("serve.decode_step", lanes=C):
                        t0 = time.perf_counter()
                        logits, pool_cache = self.model.decode_step(
                            self.params,
                            {"tokens": torch.from_numpy(cur[:, None]).to(dev),
                             "pos": torch.from_numpy(pos).to(dev)},
                            pool_cache, route_rows=True)
                        with spans.span("serve.read"):
                            nxt = logits.argmax(-1).cpu().numpy()    # (C,)
                        stats.decode_s += time.perf_counter() - t0
                    stats.global_steps += 1
                    stats.lane_slots += C
                    cur[active] = nxt[active]
                    pos[active] += 1     # inactive lanes stay frozen
                # refill phase — strictly AFTER the step: a joiner's first
                # token (from its prefill) sits in ``cur`` and must be
                # emitted next iteration before the lane is ever stepped
                for lane, r in enumerate(lane_req):
                    if r is None and queue:  # a waiting request joins
                        attach(lane, queue.pop(0))
        return results
