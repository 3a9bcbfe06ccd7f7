"""LLload analogue: resource monitoring for triples jobs (port of the
profile and runtime half of ``repro.core.monitor``).

  * static  — ``profile_fn`` measures one call of a step: its FLOPs and the
    bytes it keeps resident. The reference reads both from XLA's compiled
    program without running it; the port has no compiled program, so it
    runs the step once on the example arguments.
  * runtime — per-step wall time and live device bytes; produces the
    LLload-style summary and flags stragglers.

The per-tenant gauges of the reference arrive with the policy layer.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode


# ---------------------------------------------------------------------------
# static profile of one step
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StaticProfile:
    """What LLload would show once the job is resident, measured pre-run."""
    argument_bytes: int
    temp_bytes: int
    output_bytes: int
    flops: float
    bytes_accessed: float

    @property
    def resident_bytes(self) -> int:
        return self.argument_bytes + self.temp_bytes + self.output_bytes

    def fits(self, hbm_budget: float, headroom: float = 0.95) -> bool:
        return self.resident_bytes <= hbm_budget * headroom

    def load_proxy(self, peak_flops: float, step_time_s: float) -> float:
        """GPU-load analogue: achieved FLOP/s over peak (the paper's
        'GPU load' y-axis, Figs 2/7)."""
        return self.flops / step_time_s / peak_flops


def _tensors(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _nbytes(tree: Any) -> int:
    return int(sum(t.numel() * t.element_size() for t in _tensors(tree)))


def profile_fn(fn, *example_args) -> StaticProfile:
    """Run ``fn(*example_args)`` once and profile it.

    ``flops`` is ``torch.utils.flop_counter.FlopCounterMode``'s count (the
    matmul, convolution and attention ops it knows). ``argument_bytes`` and
    ``output_bytes`` are the bytes of the tensors passed in and returned;
    ``bytes_accessed`` is their sum (each input read once, each output
    written once). ``temp_bytes`` depends on the device of the arguments:
    on CUDA it is the peak of ``torch.cuda.max_memory_allocated`` during
    the call above what was allocated before it, less the outputs; on the
    CPU nothing tracks allocations, so it is 0 and ``resident_bytes``
    counts arguments and outputs only."""
    arg_tensors = _tensors(example_args)
    on_cuda = any(t.is_cuda for t in arg_tensors)
    if on_cuda:
        device = next(t.device for t in arg_tensors if t.is_cuda)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        before = torch.cuda.memory_allocated(device)
    with FlopCounterMode(display=False) as counter:
        out = fn(*example_args)
    out_bytes = _nbytes(out)
    temp = 0
    if on_cuda:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
        temp = max(0, peak - before - out_bytes)
    arg_bytes = _nbytes(example_args)
    return StaticProfile(argument_bytes=arg_bytes, temp_bytes=int(temp),
                         output_bytes=out_bytes,
                         flops=float(counter.get_total_flops()),
                         bytes_accessed=float(arg_bytes + out_bytes))


def memory_per_lane(step_fn, *one_lane_args) -> int:
    """Bytes one lane needs (arguments + temporaries + outputs), from a
    profiled single-lane step: the per-task entry of the LLload table."""
    return profile_fn(step_fn, *one_lane_args).resident_bytes


# ---------------------------------------------------------------------------
# runtime monitor
# ---------------------------------------------------------------------------

def live_device_bytes() -> int:
    """Bytes PyTorch holds allocated on the current CUDA device (the 'GPU
    memory used' column); 0 on a machine without a card."""
    if not torch.cuda.is_available():
        return 0
    return int(torch.cuda.memory_allocated())


@dataclasses.dataclass
class StepRecord:
    step: int
    wall_s: float
    live_bytes: int
    lane_times: Optional[np.ndarray] = None


@dataclasses.dataclass
class RunMonitor:
    """Collects per-step timing/memory; flags stragglers.

    A lane whose EWMA step time exceeds ``straggler_ratio`` × the median
    lane EWMA is reported (the paper's motivation for watching LLload
    while the sweep runs).
    """
    straggler_ratio: float = 1.5
    history: List[StepRecord] = dataclasses.field(default_factory=list)
    _ewma: Optional[np.ndarray] = None
    _t0: Optional[float] = None

    def start_step(self):
        self._t0 = time.perf_counter()

    def end_step(self, step: int, lane_times: Optional[np.ndarray] = None):
        wall = time.perf_counter() - self._t0
        self.history.append(StepRecord(step, wall, live_device_bytes(),
                                       lane_times))
        if lane_times is not None:
            lt = np.asarray(lane_times, dtype=np.float64)
            self._ewma = lt if self._ewma is None else 0.7 * self._ewma + 0.3 * lt
        return wall

    def stragglers(self) -> List[int]:
        if self._ewma is None or len(self._ewma) < 2:
            return []
        med = float(np.median(self._ewma))
        if med <= 0:
            return []
        return [i for i, t in enumerate(self._ewma)
                if t > self.straggler_ratio * med]

    def summary(self) -> Dict[str, float]:
        if not self.history:
            return {}
        walls = np.array([r.wall_s for r in self.history])
        return {"steps": len(walls), "mean_s": float(walls.mean()),
                "p50_s": float(np.median(walls)), "max_s": float(walls.max()),
                "last_live_bytes": self.history[-1].live_bytes}
