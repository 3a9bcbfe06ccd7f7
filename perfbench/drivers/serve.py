"""Serving: ``launch/serve.py::BatchServer.run`` over the mix's requests.

Set-up makes the weights from the seed and starts one ``run`` over every
request of the mix: the pool fills (one prefill a lane) and decodes. The
window opens when the tokens of decode step ``open_after_steps`` are
emitted, and closes ``seconds`` later at the next emission, which stops
the run (held open, where the requests finished in the window hold fewer
than ``sample_tokens`` tokens, until they do; at the cell's length they
hold many times more). Each emitted token is stamped on the host clock as the server
appends it to its request (``Request.out`` is a list that records the
time of each append), so the gaps between a request's tokens are the
ones its client would see. Decode steps are counted by the server's own
``ServeStats.global_steps``.

Correctness: once the window has closed and the server is gone, a sample
of the requests that finished inside the window (the one with most
tokens first, the rest drawn from the seed, at least ``sample_tokens``
served tokens) is run through the family's reference over its padded
prompt and served tokens, and the widest gap by which a served token's
logit lies below the reference's best is held to the cell's limit.
"""
from __future__ import annotations

import gc
import sys
import time
from typing import List

import numpy as np
import torch

from perfbench import counts, reference, traffic, weights
from perfbench.common import check, port_config, sub_seed
from perfbench.trace import Tracer, op_ranges


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class WindowClosed(Exception):
    pass


class _Clock:
    """The window's state, shared by every request's token list."""

    def __init__(self, steps, open_after: int, seconds: float,
                 trace_s: float, want_tokens: int, on_open, on_trace_end):
        self.steps = steps              # () -> decode steps returned so far
        self.open_after = open_after
        self.seconds = seconds
        self.want_tokens = want_tokens
        self.done_tokens = 0            # of requests finished in the window
        self.held = False
        self.trace_s = trace_s
        self.t_open = self.t_close = None
        self.on_open, self.on_trace_end = on_open, on_trace_end
        self.traced = False

    def stamp(self) -> float:
        now = time.perf_counter()
        if self.t_open is None:
            if self.steps() >= self.open_after:
                self.t_open = now
                self.on_open()
            return now
        if self.traced is False and now >= self.t_open + self.trace_s:
            self.traced = True
            self.on_trace_end()
        if now >= self.t_open + self.seconds:
            if self.done_tokens < self.want_tokens:
                self.held = True
                return now
            self.t_close = now if self.held else self.t_open + self.seconds
            if not self.traced:
                self.traced = True
                self.on_trace_end()
            raise WindowClosed()
        return now


class TimedTokens(list):
    """A request's output tokens, each append stamped with the host time
    and the number of decode steps that had returned."""

    def __init__(self, clock: _Clock, max_new: int):
        super().__init__()
        self.clock = clock
        self.max_new = max_new
        self.times: List[float] = []
        self.steps: List[int] = []

    def append(self, tok):
        t = self.clock.stamp()
        self.times.append(t)
        self.steps.append(self.clock.steps())
        super().append(tok)
        if (len(self) == self.max_new
                and self.steps[-1] > self.clock.open_after):
            self.clock.done_tokens += len(self)


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        plant=None) -> dict:
    """One run of a serving cell; ``plant(model)``, where given, breaks
    the port's model before the run (the tests' and the calibration's
    faults)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import BatchServer, Request
    from repro_torch.models.model import Model

    port, tr = cell["config"]["port"], cell["traffic"]
    fam = reference.family(port["family"])
    model = Model(port_config(cell["config"]), device=device)
    if plant is not None:
        plant(model)
    params = weights.make(fam.layout(port), sub_seed(seed, "weights"),
                          device)
    spec = traffic.requests(tr, port["vocab_size"], seed)
    s_pad = max(len(p) for p, _ in spec)

    tracer = Tracer() if trace else None
    op_calls: dict = {}
    ranges = op_ranges(ops, ["flash_attention"],
                       {"flash_attention": _attn_work}, op_calls)
    at_open: dict = {}
    server = BatchServer(model, params, batch_lanes=tr["lanes"],
                         max_len=tr["max_len"])

    def on_open():
        at_open.update(_stats(server.stats))
        if tracer:
            ranges.__enter__()
            tracer.start()

    def on_trace_end():
        if tracer:
            tracer.stop()
            ranges.__exit__(None, None, None)

    clock = _Clock(lambda: server.stats.global_steps,
                   tr["open_after_steps"], seconds,
                   tr.get("trace_seconds", seconds), tr["sample_tokens"],
                   on_open, on_trace_end)
    reqs = [Request(id=i, prompt=p, max_new=n) for i, (p, n) in
            enumerate(spec)]
    for r in reqs:
        r.out = TimedTokens(clock, r.max_new)
    t_built = time.perf_counter()
    try:
        server.run(reqs)
        raise RuntimeError("the mix ran dry before the window closed: "
                           "give it more requests")
    except WindowClosed:
        pass
    at_close = _stats(server.stats)
    del server
    gc.collect()
    mem = _peak(device)

    # the window's tokens: emitted after decode step k returned and before
    # the close; each one's gap to the request's previous token; and the
    # FLOPs the work needs (a first token is its prompt's prefill, a later
    # one a decode step at its context: the prompt and earlier tokens)
    t_open, t_close = clock.t_open, clock.t_close
    k = clock.open_after
    gaps, emitted, flops, finished = [], 0, 0, []
    for r in reqs:
        ts, st = r.out.times, r.out.steps
        for i, (t, s) in enumerate(zip(ts, st)):
            if s > k and t < t_close:
                emitted += 1
                if i:
                    gaps.append(t - ts[i - 1])
                flops += (counts.decode_flops(port, len(r.prompt) + i) if i
                          else counts.prefill_flops(port, len(r.prompt)))
        if len(r.out) >= r.max_new and ts and ts[-1] < t_close:
            finished.append(r)
    window = t_close - t_open
    if not gaps:
        raise RuntimeError(f"no token followed another in the {window} s "
                           "window: lengthen it")
    in_window = [r for r in finished if r.out.steps[-1] > k]
    summary = tracer.summary() if tracer else None

    log(f"[serve] s_pad {s_pad}, {len(in_window)} requests finished and "
        f"{emitted} tokens in {window:.3f} s; opened after "
        f"{t_open - t_built:.2f} s of serving; peak {mem / 1e9:.2f} GB")
    t_ref = time.perf_counter()
    checks = compare(fam, port, params, reqs, in_window, s_pad, seed,
                     tr["sample_tokens"], cell["limits"], device)
    log(f"[serve] reference {time.perf_counter() - t_ref:.2f} s")
    d = {k2: at_close[k2] - at_open[k2] for k2 in at_close}
    return {
        "t_open": t_open, "window_s": window,
        "attempted": len(in_window), "failed": 0,
        "e2e": {"serve_tokens_per_s": emitted / window},
        "ctx": {"serve": {"window_s": window, "flops": flops,
                          "gap_p95_ms": 1e3 * float(np.percentile(gaps, 95)),
                          "prefill_s": d["prefill_s"],
                          "prefills": d["prefills"],
                          "decode_s": d["decode_s"],
                          "global_steps": d["global_steps"],
                          "op_calls": op_calls},
                "trace": summary},
        "checks": checks, "memory_peak_bytes": mem,
        "compared": {"fam": fam, "port": port, "params": params,
                     "picked": sample(in_window, seed, tr["sample_tokens"]),
                     "served": reqs, "s_pad": s_pad},
    }


def _stats(st) -> dict:
    return {"prefill_s": st.prefill_s, "prefills": st.prefills,
            "decode_s": st.decode_s, "global_steps": st.global_steps}


def _peak(device) -> int:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        return int(torch.cuda.max_memory_allocated())
    return 0


def _attn_work(q, k, v, causal=True, window=0, **_):
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    return counts.attention_work(B, Sq, Sk, Hq, Hkv, D, causal, window,
                                 q.element_size())


def sample(finished: list, seed: int, want_tokens: int) -> list:
    """The finished request with most tokens, then others drawn from the
    seed until ``want_tokens`` served tokens are held."""
    if not finished:
        return []
    ordered = sorted(finished, key=lambda r: r.id)
    first = max(ordered, key=lambda r: (len(r.out), len(r.prompt)))
    rest = [r for r in ordered if r is not first]
    rng = np.random.default_rng(sub_seed(seed, "sample"))
    picked, total = [first], len(first.out)
    for i in rng.permutation(len(rest)):
        if total >= want_tokens:
            break
        picked.append(rest[i])
        total += len(rest[i].out)
    return picked


def served_sequence(r, s_pad: int) -> np.ndarray:
    """The tokens the reference reads: the prompt left-padded with 0 to
    ``s_pad`` (as the server pads it) and every served token but the
    last."""
    pad = np.zeros(s_pad - len(r.prompt), np.int64)
    return np.concatenate([pad, np.asarray(r.prompt, np.int64),
                           np.asarray(list(r.out)[:-1], np.int64)])


def logit_gaps(fam, port, params, r, s_pad: int, device,
               precision: str = "f32", pick: str = "served") -> float:
    """The widest gap, over request ``r``'s served positions, between the
    reference's best logit and its logit of the token judged: the served
    token, or with ``pick="control"`` the token the ``precision``
    reference puts first."""
    seq = torch.as_tensor(served_sequence(r, s_pad), device=device)
    with torch.no_grad():
        ref = fam.serve_logits(params, seq, port, "f32", s_pad - 1)
        if pick == "served":
            toks = torch.as_tensor(list(r.out), device=device)
        else:
            low = fam.serve_logits(params, seq, port, precision,
                                   s_pad - 1)
            toks = low.argmax(-1)
            del low
        best = ref.max(-1).values
        chosen = ref.gather(-1, toks.long()[:, None])[:, 0]
    return float((best - chosen).max())


def compare(fam, port, params, reqs, finished, s_pad, seed, want_tokens,
            limits, device) -> list:
    """The cell's compared numbers, each beside its limit."""
    picked = sample(finished, seed, want_tokens)
    vocab = params["unembed"].shape[-1]
    out_of_range = sum(1 for r in reqs for t in r.out if not 0 <= t < vocab)
    gap = max((logit_gaps(fam, port, params, r, s_pad, device)
               for r in picked), default=float("inf"))
    have = sum(len(r.out) for r in finished)
    return [check("logit_gap", gap, limits["logit_gap"]),
            check("tokens_compared", sum(len(r.out) for r in picked),
                  max(1, min(want_tokens, have)), "min"),
            check("tokens_out_of_vocab", out_of_range, 0)]

