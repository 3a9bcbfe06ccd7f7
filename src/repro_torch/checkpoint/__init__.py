"""Atomic checkpoints of tensor trees (port of ``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpointer import (  # noqa: F401
    save_checkpoint, load_checkpoint, load_extra, latest_step, Checkpointer)
