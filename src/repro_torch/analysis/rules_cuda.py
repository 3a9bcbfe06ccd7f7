"""CUD rule family: kernel-contract checks on the CUDA sources.

The counterpart of the reference's PAL family (``pallas_call`` sites) for
the port's hand-written sm_90a kernels, read through
``analysis.cuda_model``:

  CUD401  (PAL401's arity drift) every ``blockIdx`` axis a kernel reads is
          set by the grid of each of its launches: a kernel that reads
          ``blockIdx.z`` under a 2-D launch silently sees 0.
  CUD403  (PAL403) every ``masked_kernels`` kernel tests the lane
          predicate (``active != nullptr && active[...] == 0``) and
          returns under it BEFORE its first global load, TMA issue,
          ``cp.async`` or MMA; zeroing after the work does not count.
  CUD404  (in place of PAL404) on an inactive lane, a masked kernel writes
          exact zeros to each user-visible output the config names for
          it. PAL404's accumulator init guard has no counterpart: a CTA's
          accumulators live in its registers and die with it.
  CUD405  (PAL405's sequential axis) no atomics in the device code of a
          kernel that owes a fixed reduction order.
  CUD406  (PAL406) a kernel's shared memory per CTA, from its tile
          constants at the nominal dims, stays within ``smem_tolerance``
          of its budget in ``roofline.budgets.KERNEL_BUDGETS``.

PAL402 (index maps kept affine for scalar-prefetch pruning) has no
counterpart: pruning by a prefetched index vector is a TPU grid mechanism,
and a CUDA CTA of an inactive lane already ends on its own (CUD403).
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.analysis import cuda_model as cm
from repro_torch.analysis.core import SourceModule, register

_AXES = ("x", "y", "z")


def _cuda(modules) -> List[SourceModule]:
    return [m for m in modules if m.cuda is not None]


@register("CUD401", "cuda-grid-arity",
          "every blockIdx axis a kernel reads is set by each launch's grid")
def rule_cud401(modules, config):
    out = []
    for mod in _cuda(modules):
        for k in mod.cuda.kernels:
            for launch in k.launches:
                if launch.grid_rank is None:
                    out.append(mod.finding(
                        "CUD401", "cuda-grid-arity", launch.line,
                        f"launch of `{k.name}`: the grid's rank is not "
                        "statically readable — pass a `dim3` declared in "
                        "the launching function", context=k.name))
                    continue
                for axis in k.block_axes:
                    if _AXES.index(axis) >= launch.grid_rank:
                        out.append(mod.finding(
                            "CUD401", "cuda-grid-arity", launch.line,
                            f"`{k.name}` reads blockIdx.{axis} but this "
                            f"launch's grid has rank {launch.grid_rank} — "
                            f"the axis is always 0", context=k.name))
    return out


def _masked(modules, config):
    """(module, kernel name, outputs, model or None) of every registered
    masked kernel whose source is in this run."""
    by_rel: Dict[str, SourceModule] = {m.relpath: m for m in modules}
    for relpath in sorted(config.masked_kernels):
        mod = by_rel.get(relpath)
        if mod is None or mod.cuda is None:
            continue
        kernels = {k.name: k for k in mod.cuda.kernels}
        for name, outputs in sorted(config.masked_kernels[relpath].items()):
            yield mod, name, outputs, kernels.get(name)


@register("CUD403", "cuda-lane-mask-native",
          "masked kernels test the lane predicate and return before their "
          "first global load, TMA issue, cp.async or MMA")
def rule_cud403(modules, config):
    out = []
    for mod, name, _, k in _masked(modules, config):
        if k is None:
            out.append(mod.finding(
                "CUD403", "cuda-lane-mask-native", 1,
                f"masked_kernels registers `{name}` but no __global__ "
                "function of that name is in this file — update "
                "repro_torch.analysis.config", context=name))
        elif k.gate_line is None:
            out.append(mod.finding(
                "CUD403", "cuda-lane-mask-native", k.line,
                f"`{name}` never tests the lane predicate "
                "(`active != nullptr && active[...] == 0`) — an inactive "
                "lane's CTAs do all the work", context=name))
        elif not k.gate_exits:
            out.append(mod.finding(
                "CUD403", "cuda-lane-mask-native", k.gate_line,
                f"`{name}` tests the lane predicate but does not return "
                "under it — the inactive lane goes on to the work",
                context=name))
        elif not k.gated_before_load:
            out.append(mod.finding(
                "CUD403", "cuda-lane-mask-native", k.gate_line,
                f"`{name}` tests the lane predicate after its first global "
                f"load (`{k.first_load_what}`, line {k.first_load_line}) — "
                "an inactive lane still reads its operands; move the test "
                "above it", context=name))
    return out


@register("CUD404", "cuda-lane-zero-outputs",
          "an inactive lane's user-visible outputs are written exact zeros")
def rule_cud404(modules, config):
    out = []
    for mod, name, outputs, k in _masked(modules, config):
        if k is None or k.gate_line is None:
            continue                                 # CUD403's finding
        missing = [o for o in outputs if o not in k.gate_writes]
        if missing:
            out.append(mod.finding(
                "CUD404", "cuda-lane-zero-outputs", k.gate_line,
                f"`{name}`: on an inactive lane the branch under the lane "
                f"predicate writes no zeros to {', '.join(missing)} — the "
                "output keeps whatever the buffer held", context=name))
    return out


@register("CUD405", "cuda-no-atomics",
          "no atomics in kernels that owe a fixed reduction order")
def rule_cud405(modules, config):
    out = []
    for mod in _cuda(modules):
        if mod.relpath not in config.fixed_order_sources:
            continue
        for k in mod.cuda.kernels:
            for line, what in k.atomics:
                out.append(mod.finding(
                    "CUD405", "cuda-no-atomics", line,
                    f"`{k.name}` reaches `{what}` — an atomic makes the "
                    "order of a sum depend on scheduling, and the kernels "
                    "owe a fixed reduction order (masked == dense bit for "
                    "bit)", context=k.name))
    return out


@register("CUD406", "cuda-smem-budget",
          "shared memory per CTA at nominal dims matches the registered "
          "budget within tolerance")
def rule_cud406(modules, config):
    out = []
    for mod in _cuda(modules):
        for k in mod.cuda.kernels:
            key = f"{mod.relpath}::{k.name}"
            budget = config.kernel_budgets.get(key)
            if budget is None:
                out.append(mod.finding(
                    "CUD406", "cuda-smem-budget", k.line,
                    f"`{k.name}`: no budget registered — add \"{key}\" to "
                    "roofline.budgets.KERNEL_BUDGETS", context=k.name))
                continue
            try:
                got = mod.cuda.shared_bytes(k, budget.get("nominal", {}))
            except (cm.Unresolved, ValueError) as e:
                out.append(mod.finding(
                    "CUD406", "cuda-smem-budget", k.line,
                    f"`{k.name}`: shared memory is not statically "
                    f"resolvable ({e}) — bind the missing name in the "
                    "budget's nominal dims", context=k.name))
                continue
            want = budget["smem_bytes"]
            tol = config.smem_tolerance
            if abs(got - want) > tol * want:
                out.append(mod.finding(
                    "CUD406", "cuda-smem-budget", k.line,
                    f"`{k.name}`: modelled shared memory {got} B/CTA "
                    f"drifts from the registered budget {want} B/CTA by "
                    f"more than {tol:.0%} — update KERNEL_BUDGETS "
                    "alongside the tile change", context=k.name))
    return out
