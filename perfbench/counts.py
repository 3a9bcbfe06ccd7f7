"""Operations and bytes the benchmark counts from shapes: the work a model
needs (for ``mfu.*``) and the work of one call of the port's attention
entry (for its roofline share).

``attention_pairs`` and ``attention_work`` are copies of
``repro_torch/roofline/counting.py``'s, so that the yardstick stays with
the benchmark.

A model's FLOPs count the products it needs and nothing a particular
implementation adds: the projections, the MLP, the head where its logits
are used, and attention over the causal (query, key) pairs. A training
step is the forward and twice its products for the backward;
recomputation is not counted. Elementwise work is not counted.
"""
from __future__ import annotations

import numpy as np

from perfbench.common import PEAK_BF16_FLOPS, PEAK_BYTES_S


def attention_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the causal and window masks leave, positions
    counted from 0 in both."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention_work(B, Sq, Sk, Hq, Hkv, D, causal, window, itemsize) -> tuple:
    """(FLOPs, bytes) of flash attention: QKᵀ and PV over the unmasked
    pairs; q, k, v read once and o written once."""
    flops = 4 * B * Hq * D * attention_pairs(Sq, Sk, causal, window)
    nbytes = (2 * B * Sq * Hq + 2 * B * Sk * Hkv) * D * itemsize
    return flops, nbytes


def bound_s(flops: float, nbytes: float) -> float:
    """The least time for the work on the card: the larger of the
    operations at the bf16 peak and the bytes at the memory peak."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S)


def _head_dim(port: dict) -> int:
    return port.get("head_dim") or port["d_model"] // port["num_heads"]


def _attn_layer_flops(port: dict, n_tokens: int, pairs: int) -> int:
    """One attention block: q, k, v and o projections of ``n_tokens``
    tokens and the scores and mix over ``pairs`` (query, key) pairs."""
    d, H, Hkv = port["d_model"], port["num_heads"], port["num_kv_heads"]
    D = _head_dim(port)
    proj = 2 * n_tokens * d * D * (2 * H + 2 * Hkv)
    return proj + 4 * H * D * pairs


def _mlp_flops(port: dict, n_tokens: int) -> int:
    return 2 * n_tokens * 3 * port["d_model"] * port["d_ff"]


def _head_flops(port: dict, n_logits: int) -> int:
    return 2 * n_logits * port["d_model"] * port["vocab_size"]


def forward_flops(port: dict, n_tokens: int, pairs: int,
                  n_logits: int) -> int:
    """A forward pass of ``n_tokens`` tokens whose attention covers
    ``pairs`` (query, key) pairs, with logits at ``n_logits`` positions."""
    if port["family"] != "dense":
        raise ValueError(f"no count for family {port['family']!r}")
    body = port["num_layers"] * (_attn_layer_flops(port, n_tokens, pairs)
                                 + _mlp_flops(port, n_tokens))
    return body + _head_flops(port, n_logits)


def train_step_flops(port: dict, rows: int, seq: int) -> int:
    """One lane's training step on ``rows`` sequences of ``seq`` tokens:
    the forward and its backward (twice its products)."""
    pairs = rows * attention_pairs(seq, seq, True, 0)
    return 3 * forward_flops(port, rows * seq, pairs, rows * seq)


def prefill_flops(port: dict, prompt_len: int) -> int:
    """A prompt's prefill: the forward over its tokens, logits at its
    last position."""
    return forward_flops(port, prompt_len,
                         attention_pairs(prompt_len, prompt_len, True, 0), 1)


def decode_flops(port: dict, context: int) -> int:
    """One decoded token attending over ``context`` keys (itself
    included)."""
    return forward_flops(port, 1, context, 1)
