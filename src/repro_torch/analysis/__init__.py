"""The port's contract lint (port of ``repro.analysis``).

Replays are only trustworthy while scheduling decisions stay a pure
function of recorded inputs, every masked entrypoint honours the
lane-mask contract, and the hand-written kernels keep theirs. These
invariants are cross-layer and easy to break silently; this package checks
them with AST rules over the Python sources and a token model over the
CUDA sources (``kernels/csrc/*.cu``).

Entry points: ``python -m repro_torch.analysis.lint`` (``--check`` is the
gate; the baseline is ``LINT_BASELINE_TORCH.json``) and
``python -m repro_torch.analysis.kernel_report`` (the kernels' static
contract, and with ``--libs`` their registers, local memory and shared
memory read from the built libraries). Rule families: DET (determinism on
the decision path), MASK (lane-mask contract), ACC (monitor counter
symmetry), CUD (the CUDA kernels' contract, in place of the reference's
PAL rules on ``pallas_call`` sites).

The reference's JAX family has no counterpart, and neither has PAL402:

  * JAX101 (use after donate): nothing in the port donates a buffer, and
    its step factories return fresh tensors;
  * JAX102 (jit in a loop): the port compiles no graph (no TorchDynamo,
    no CUDA graphs); a counterpart comes with the first that does;
  * JAX103 (a Python branch on a traced value): under ``torch.func`` such
    a branch raises at once instead of going wrong silently;
  * PAL402 (affine index maps for scalar-prefetch pruning): a TPU grid
    mechanism; a CUDA CTA of an inactive lane ends on its own (CUD403).

``--list-rules`` prints these reasons beside the rules that run.
"""
from repro_torch.analysis.config import LintConfig, default_config
from repro_torch.analysis.core import Finding, SourceModule, run_rules
from repro_torch.analysis.driver import LintResult, run_lint

__all__ = [
    "Finding",
    "LintConfig",
    "LintResult",
    "SourceModule",
    "default_config",
    "run_lint",
    "run_rules",
]
