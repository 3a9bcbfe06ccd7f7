"""Lint configuration: which files are decision-path, which kernels owe the
lane-mask contract, and the CUDA kernels' registered budgets.

This is the one place a contributor registers new surface area:

  * a new module whose outputs feed scheduling decisions goes into
    ``decision_modules`` (the DET family then bans wall-clock reads,
    unseeded RNG, set-order dependence, id() ordering and float ``==``
    gates in it);
  * a new packed/lane-batched kernel entrypoint goes into
    ``mask_entrypoints`` (MASK then enforces ``active=None`` + the
    passthrough branch);
  * a new paired monitor counter goes into ``acc_pairs``;
  * a new ``__global__`` kernel that takes the lane predicate goes into
    ``masked_kernels`` with the outputs it zeroes, and every kernel gets
    a budget in ``roofline.budgets.KERNEL_BUDGETS``.

The reference's ``DONATING_FACTORIES`` has no counterpart: nothing in the
port donates a buffer (see the package docstring).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Mapping, Tuple

#: Modules whose control flow decides *what runs where, when* — replays
#: are only bit-identical while these stay pure functions of recorded
#: inputs.
DECISION_MODULES = (
    "src/repro_torch/core/simulate.py",
    "src/repro_torch/core/tenancy.py",
    "src/repro_torch/core/traces.py",
    "src/repro_torch/core/spatial.py",
    "src/repro_torch/core/triples.py",
    "src/repro_torch/core/scheduler.py",
    "src/repro_torch/core/monitor.py",
    "src/repro_torch/core/eventlog.py",
    "src/repro_torch/core/controlplane.py",
)

#: Packed / lane-batched kernel entrypoints owing the lane-mask
#: contract: accept ``active=`` defaulting to None, with an explicit
#: None passthrough or a forward of the mask.
MASK_ENTRYPOINTS: Mapping[str, Tuple[str, ...]] = {
    "src/repro_torch/kernels/ops.py": (
        "packed_matmul", "packed_norm", "flash_attention", "ssd"),
    "src/repro_torch/kernels/packed_gemm.py": ("packed_gemm",),
    "src/repro_torch/kernels/fused_rmsnorm.py": ("packed_rmsnorm",),
    "src/repro_torch/kernels/flash_attention.py": ("flash_attention_fwd",),
    "src/repro_torch/kernels/ssd_scan.py": ("ssd_scan",),
}

#: The masked-execution dispatcher must branch on every registered mode.
MASK_DISPATCH = {
    "module": "src/repro_torch/core/packing.py",
    "modes_const": "MASKED_MODES",
    "dispatcher": "masked_pool_step",
    "param": "mode",
}

#: Monitor counters that must be incremented in matched pairs at the
#: call-site layer.
ACC_PAIRS = (
    ("on_dispatch", "on_release"),
    ("on_preempt", "on_resume"),
    ("on_slice_alloc", "on_slice_release"),
)

#: Modules whose call sites the ACC family audits.
ACC_MODULES = (
    "src/repro_torch/core/scheduler.py",
    "src/repro_torch/core/simulate.py",
)

#: ``__global__`` kernels that take the lane predicate, keyed by source:
#: each must test ``active != nullptr && active[...] == 0`` and leave
#: before its first global load (CUD403), writing exact zeros to the
#: user-visible outputs named here (CUD404; ``ssd_chunk_kernel`` writes
#: only scratch).
MASKED_KERNELS: Mapping[str, Mapping[str, Tuple[str, ...]]] = {
    "src/repro_torch/kernels/csrc/flash_attention.cu": {
        "fa_fwd_simt_kernel": ("o",), "fa_fwd_wgmma_kernel": ("o",)},
    "src/repro_torch/kernels/csrc/packed_gemm.cu": {
        "gemm_simt_kernel": ("o",), "gemm_wgmma_kernel": ("o",)},
    "src/repro_torch/kernels/csrc/rmsnorm.cu": {
        "packed_rmsnorm_kernel": ("o",)},
    "src/repro_torch/kernels/csrc/ssd_scan.cu": {
        "ssd_chunk_kernel": (), "ssd_state_kernel": ("out",),
        "ssd_out_kernel": ("y",)},
}

#: Sources whose kernels owe a fixed reduction order (the parity rule
#: "Fixed reduction order in kernels"): no atomics in their device code
#: (CUD405).
FIXED_ORDER_SOURCES: Tuple[str, ...] = (
    "src/repro_torch/kernels/csrc/flash_attention.cu",
    "src/repro_torch/kernels/csrc/packed_gemm.cu",
    "src/repro_torch/kernels/csrc/rmsnorm.cu",
    "src/repro_torch/kernels/csrc/ssd_scan.cu",
)


@dataclasses.dataclass(frozen=True)
class LintConfig:
    root: str
    paths: Tuple[str, ...] = ("src/repro_torch",)
    decision_modules: Tuple[str, ...] = DECISION_MODULES
    mask_entrypoints: Mapping[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: dict(MASK_ENTRYPOINTS))
    mask_dispatch: Dict = dataclasses.field(
        default_factory=lambda: dict(MASK_DISPATCH))
    acc_pairs: Tuple[Tuple[str, str], ...] = ACC_PAIRS
    acc_modules: Tuple[str, ...] = ACC_MODULES
    masked_kernels: Mapping[str, Mapping[str, Tuple[str, ...]]] = \
        dataclasses.field(default_factory=lambda: dict(MASKED_KERNELS))
    fixed_order_sources: Tuple[str, ...] = FIXED_ORDER_SOURCES
    kernel_budgets: Mapping[str, Dict] = dataclasses.field(
        default_factory=lambda: dict(_budgets().KERNEL_BUDGETS))
    smem_tolerance: float = dataclasses.field(
        default_factory=lambda: _budgets().SMEM_TOLERANCE)
    baseline_path: str = "LINT_BASELINE_TORCH.json"

    def is_decision(self, relpath: str) -> bool:
        return relpath in self.decision_modules

    def abs_baseline(self) -> str:
        if os.path.isabs(self.baseline_path):
            return self.baseline_path
        return os.path.join(self.root, self.baseline_path)


def _budgets():
    """CUD406's budgets and tolerance live next to the roofline, so a tile
    change updates both in one review."""
    from repro_torch.roofline import budgets
    return budgets


def repo_root() -> str:
    """The checkout root, derived from this file's location
    (src/repro_torch/analysis/config.py -> three levels up)."""
    here = os.path.abspath(os.path.dirname(__file__))
    return os.path.abspath(os.path.join(here, "..", "..", ".."))


def default_config(root: str | None = None, **overrides) -> LintConfig:
    return LintConfig(root=root or repo_root(), **overrides)
