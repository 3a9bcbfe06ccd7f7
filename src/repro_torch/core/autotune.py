"""auto_nppn: replace the paper's human LLload feedback loop with a search
for the largest safe packing factor (port of ``repro.core.autotune``).

The paper: users watch GPU memory while increasing NPPN; their 48-job run
lost 21 tasks to CUDA OOM. The reference compiles the packed step at
candidate packing factors and reads XLA's memory analysis without running
anything, so a probe can never run out of memory. PyTorch has no such
analysis: ``measure_packed`` RUNS the k-lane step once and reads the
allocator (``monitor.profile_fn``). On the card a probe at a factor that
does not fit would be a real OOM, so ``auto_nppn`` runs a probe only when
a prediction from the steps it has measured says it fits the budget, and
otherwise takes the prediction as the probe's profile (``predicted``). The
search itself (exponential probe, then bisection) is the reference's, line
for line; the footprint is affine in the factor (the lanes' state and
temporaries, plus what the step holds once), so the prediction is
k · bytes(1) until k = 2 has been measured, then bytes(1) + (k − 1) ·
(bytes(2) − bytes(1)).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core.monitor import StaticProfile, profile_fn


@dataclasses.dataclass(frozen=True)
class PackingDecision:
    nppn_per_chip: int                  # lanes per chip (pack factor)
    profile: StaticProfile              # at the chosen factor
    rejected: Optional[int] = None      # first factor that did NOT fit
    reason: str = ""
    profile_single: Optional[StaticProfile] = None   # the k=1 probe (the
                                        # per-lane admission footprint)
    measured: Tuple[int, ...] = ()      # factors whose step ran, in order
    predicted: Tuple[int, ...] = ()     # factors decided by prediction


def measure_packed(make_packed: Callable[[int], Callable], k: int,
                   example_args_fn: Callable[[int], tuple]) -> StaticProfile:
    """Run the k-lane packed step once on example arguments and profile
    it."""
    fn = make_packed(k)
    return profile_fn(fn, *example_args_fn(k))


def _affine(p1: StaticProfile, p2: Optional[StaticProfile],
            k: int) -> StaticProfile:
    """The profile at factor k extrapolated from the measured ones."""
    def at(field: str) -> float:
        a = getattr(p1, field)
        if p2 is None:
            return k * a
        return a + (k - 1) * (getattr(p2, field) - a)
    ints = {f: int(at(f)) for f in ("argument_bytes", "temp_bytes",
                                    "output_bytes")}
    return StaticProfile(**ints, flops=at("flops"),
                         bytes_accessed=at("bytes_accessed"),
                         predicted=True)


class _Prober:
    """The probe the search calls: runs the step at k when the prediction
    fits the budget, and records which factors ran and which were
    predicted."""

    def __init__(self, make_packed, example_args_fn, limit: float):
        self.make_packed = make_packed
        self.example_args_fn = example_args_fn
        self.limit = limit
        self.measured: Dict[int, StaticProfile] = {}
        self.predicted: Dict[int, StaticProfile] = {}

    def __call__(self, k: int) -> StaticProfile:
        if k > 1:
            guess = _affine(self.measured[1], self.measured.get(2), k)
            if guess.resident_bytes > self.limit:
                self.predicted[k] = guess
                return guess
        prof = measure_packed(self.make_packed, k, self.example_args_fn)
        self.measured[k] = prof
        return prof


def auto_nppn(make_packed: Callable[[int], Callable],
              example_args_fn: Callable[[int], tuple],
              hbm_budget: float, *, max_factor: int = 64,
              headroom: float = 0.95) -> PackingDecision:
    """Largest k in [1, max_factor] whose packed step fits the HBM budget.

    Exponential probe then bisection; raises if even k=1 does not fit
    (the task needs NTPP > 1, i.e. more chips — paper's multi-GPU case).
    """
    probe = _Prober(make_packed, example_args_fn, hbm_budget * headroom)

    def decision(k, prof, **kw) -> PackingDecision:
        return PackingDecision(k, prof, profile_single=prof1,
                               measured=tuple(probe.measured),
                               predicted=tuple(probe.predicted), **kw)

    prof1 = probe(1)
    if not prof1.fits(hbm_budget, headroom):
        raise MemoryError(
            f"single task needs {prof1.resident_bytes/1e9:.2f} GB > budget "
            f"{hbm_budget*headroom/1e9:.2f} GB; increase NTPP (chips/task)")

    # exponential probe
    lo, lo_prof = 1, prof1
    hi = None
    k = 2
    while k <= max_factor:
        prof = probe(k)
        if prof.fits(hbm_budget, headroom):
            lo, lo_prof = k, prof
            k *= 2
        else:
            hi = k
            break
    if hi is None:
        # The doubling loop stopped because 2*lo > max_factor, so every
        # factor in (lo, max_factor] is still UNPROBED — returning lo here
        # silently packs at the last power of two (e.g. 4 when max_factor
        # is an admission-derived 6). Probe max_factor itself: if it fits
        # the frontier is exactly the cap; otherwise bisect (lo, max_factor).
        if lo >= max_factor:
            return decision(max_factor, lo_prof,
                            reason="hit max_factor, all fit")
        prof = probe(max_factor)
        if prof.fits(hbm_budget, headroom):
            return decision(max_factor, prof,
                            reason="hit max_factor, all fit")
        hi = max_factor

    # bisect (lo fits, hi doesn't)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        prof = probe(mid)
        if prof.fits(hbm_budget, headroom):
            lo, lo_prof = mid, prof
        else:
            hi = mid
    return decision(lo, lo_prof, rejected=hi, reason=f"k={hi} exceeds budget")


def predict_oom(profile: StaticProfile, hbm_budget: float,
                headroom: float = 0.95) -> bool:
    """True if launching this program would OOM (the 48-job experiment)."""
    return not profile.fits(hbm_budget, headroom)
