"""The one generator of every traffic mix, driven by the mix's data file.

Training mixes ("driver": "sweep"): next-token batches of ``rows`` ×
``seq`` tokens a lane step, drawn uniformly from the vocabulary with a
motif of ``motif_len`` tokens repeated every ``motif_every`` positions
(so the loss can fall), a pure function of (task seed, step); and the
sweep's task list, the same set of (budget, learning rate) pairs in every
run, in an order and with task seeds drawn from the run's seed.

Serving mixes ("driver": "serve"): ``requests`` requests in blocks of
``block``. Prompt and output lengths follow the log-normal distributions
the mix's file gives (``median`` and ``sigma`` of the log, held to
[``min``, ``max``]), as its ``source`` publishes them: every block holds
the ``block`` lengths at the distribution's quantiles (i + 1/2) / block,
so every block and every run serves the same set of lengths, and the
seed draws each block's order of prompts and, apart, of outputs, and the
prompt tokens. The longest prompt of the mix is in every block, so every
run pads its prompts to the same length.
"""
from __future__ import annotations

from statistics import NormalDist
from typing import Dict, List, Tuple

import numpy as np

from perfbench.common import sub_seed


def lm_batch(traffic: dict, vocab: int, seed: int, step: int
             ) -> Dict[str, np.ndarray]:
    rows, seq = traffic["rows"], traffic["seq"]
    rng = np.random.Generator(np.random.Philox(
        key=sub_seed(seed, "batch"), counter=[step, 0, 0, 0]))
    raw = rng.integers(0, vocab, size=(rows, seq + 1), dtype=np.int64)
    every, width = traffic["motif_every"], traffic["motif_len"]
    motif = rng.integers(0, vocab, size=(rows, width))
    for i in range(0, seq + 1, every):
        w = min(width, seq + 1 - i)
        raw[:, i:i + w] = motif[:, :w]
    return {"tokens": raw[:, :-1].astype(np.int32),
            "labels": raw[:, 1:].astype(np.int32)}


def sweep_tasks(traffic: dict, seed: int) -> List[Tuple[int, float, int]]:
    """(task seed, learning rate, step budget) of each task in queue
    order: ``tasks`` tasks cycling through the budgets (scaled by
    ``budget_scale``) against ``n_lr`` learning rates spread
    geometrically over ``lr``; each block of ``len(budgets)`` tasks is
    shuffled by the seed."""
    budgets = [b * traffic["budget_scale"] for b in traffic["budgets"]]
    lrs = np.geomspace(*traffic["lr"], traffic["n_lr"]).tolist()
    rng = np.random.default_rng(sub_seed(seed, "tasks"))
    out = []
    n = len(budgets)
    while len(out) < traffic["tasks"]:
        order = rng.permutation(n)
        for i in order:
            out.append((sub_seed(seed, "task", len(out)),
                        float(lrs[i % len(lrs)]), int(budgets[i])))
    return out[:traffic["tasks"]]


def lengths(dist: dict, n: int) -> np.ndarray:
    """The ``n`` lengths at the quantiles (i + 1/2) / n of the log-normal
    with median ``dist["median"]`` and log-scale ``dist["sigma"]``,
    rounded and held to [``dist["min"]``, ``dist["max"]``]."""
    z = [NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]
    raw = np.round(dist["median"] * np.exp(dist["sigma"] * np.array(z)))
    return np.clip(raw, dist["min"], dist["max"]).astype(np.int64)


def requests(traffic: dict, vocab: int, seed: int
             ) -> List[Tuple[np.ndarray, int]]:
    """(prompt tokens, output length) of each request in queue order:
    blocks of ``block`` requests, each holding the same prompt and output
    lengths (``lengths``) in orders drawn from the seed, so that the
    stretch of the queue a window serves holds the same work for every
    seed; the seed also draws the tokens."""
    n, b = traffic["requests"], traffic["block"]
    rng = np.random.default_rng(sub_seed(seed, "requests"))
    prompts, outputs = (lengths(traffic[k], b) for k in ("prompt", "output"))
    out = []
    while len(out) < n:
        for p, o in zip(prompts[rng.permutation(b)],
                        outputs[rng.permutation(b)]):
            out.append((rng.integers(1, vocab, size=int(p), dtype=np.int64),
                        int(o)))
    return out[:n]
