"""Optimizers on nested dicts of tensors and learning-rate schedules (port
of ``repro.optim``)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adamw, sgd, apply_updates, global_norm, clip_by_global_norm)
from repro_torch.optim.schedule import (  # noqa: F401
    constant, cosine_decay, linear_warmup_cosine)
