"""Parameters made by the benchmark from a seed, on the device, in one
normal draw for every drawn matrix, each leaf a view of it scaled in
place. The layout (paths, shapes, kinds) is the family reference's, which
is the port's tree; the same seed gives the same tensors to the program
and to the reference."""
from __future__ import annotations

import math

import torch

SCALE = {"dense": lambda fan_in: 1.0 / math.sqrt(max(fan_in, 1)),
         "embed": lambda _: 0.02}


def _kind(init: str):
    name, _, arg = init.partition(":")
    return name, (int(arg) if arg else 0)


def make(layout: list, seed: int, device) -> dict:
    """The f32 parameter tree of ``layout`` drawn from ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n_drawn = sum(math.prod(shape) for _, shape, init in layout
                  if _kind(init)[0] in SCALE)
    normal = torch.randn(n_drawn, generator=gen, device=device,
                         dtype=torch.float32)
    at = 0
    tree: dict = {}
    for path, shape, init in layout:
        kind, arg = _kind(init)
        if kind in SCALE:
            n = math.prod(shape)
            leaf = normal[at:at + n].view(shape).mul_(SCALE[kind](arg))
            at += n
        elif kind == "ones":
            leaf = torch.ones(shape, device=device, dtype=torch.float32)
        else:
            raise ValueError(f"unknown init {init!r}")
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree
