"""Load the reference's parameters into the port.

``params_from_numpy`` takes the JAX package's ``Model.init`` pytree as numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)``) and returns the
port's params. The port keeps the reference's layout, so nothing is
transposed: matrices stay folded (d_in, d_out) and the per-layer blocks stay
stacked on a leading L axis.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes.bfloat16: reinterpret bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree: Any, device) -> Any:
    """Nested dicts and lists of numpy arrays -> the same tree of tensors on
    ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_from_numpy(v, device) for v in tree]
    return _to_tensor(tree, device)
