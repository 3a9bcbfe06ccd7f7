"""Optimizers as pure functions on nested dicts and lists of tensors (port
of ``repro.optim.optimizers``).

API as the reference's (optax-like): ``opt.init(params) -> state``;
``opt.update(grads, state, params, lr) -> (updates, state)``. Nothing is
updated in place, so a step can run under ``torch.func.vmap`` with one lane
per task; ``lr`` is a tensor, so a per-lane learning rate rides the lane
axis. The update math is f32 whatever the moment dtype, as in the
reference.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple]    # (grads, state, params, lr) -> (upd, state)


def _map(fn: Callable, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in _leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return _map(lambda x: x * scale.to(x.dtype), tree), norm


def apply_updates(params, updates):
    return _map(lambda p, u: p + u.to(p.dtype), params, updates)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, grad_clip: float = 1.0,
          moment_dtype=torch.float32) -> Optimizer:
    """AdamW with decoupled weight decay + global-norm clipping.

    ``moment_dtype=torch.bfloat16`` stores the moments in bf16; the update
    math stays f32 (load-convert-store)."""

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=moment_dtype)
        return {"mu": _map(zeros, params), "nu": _map(zeros, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=_leaves(params)[0].device)}

    def update(grads, state, params, lr):
        # clipping scales each gradient leaf where it is used: the same
        # values as ``clip_by_global_norm`` first, without a second copy
        # of every gradient alive beside the new moments
        scale = None
        if grad_clip:
            norm = global_norm(grads)
            scale = torch.clamp(grad_clip / torch.clamp(norm, min=1e-9),
                                max=1.0)
        count = state["count"] + 1
        b1c = 1 - b1 ** count.float()
        b2c = 1 - b2 ** count.float()

        def upd(g, m, n, p):
            if scale is not None:
                g = g * scale.to(g.dtype)
            g = g.float()
            m32 = b1 * m.float() + (1 - b1) * g
            n32 = b2 * n.float() + (1 - b2) * torch.square(g)
            mh = m32 / b1c
            nh = n32 / b2c
            step = mh / (torch.sqrt(nh) + eps) + weight_decay * p.float()
            return -lr * step, m32.to(moment_dtype), n32.to(moment_dtype)

        out = _map(upd, grads, state["mu"], state["nu"], params)
        pick = lambda i: _map(lambda o: o[i], out)
        return pick(0), {"mu": pick(1), "nu": pick(2), "count": count}

    return Optimizer(init, update)


def sgd(momentum: float = 0.9, grad_clip: float = 0.0) -> Optimizer:
    def init(params):
        return {"v": _map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                          params)}

    def update(grads, state, params, lr):
        if grad_clip:
            grads, _ = clip_by_global_norm(grads, grad_clip)

        def upd(g, v):
            v = momentum * v + g.float()
            return -lr * v, v

        out = _map(upd, grads, state["v"])
        return (_map(lambda o: o[0], out), {"v": _map(lambda o: o[1], out)})

    return Optimizer(init, update)
