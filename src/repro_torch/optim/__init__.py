"""Optimizers on nested dicts of tensors (port of ``repro.optim``)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adamw, sgd, apply_updates, global_norm, clip_by_global_norm)
