"""MASK — lane-mask contract rules.

The lane pool attaches/detaches jobs without recompiling; at partial
occupancy, packed kernels see dead lanes. The contract every
packed/lane-batched entrypoint owes:

  MASK201  the entrypoint accepts ``active=`` defaulting to None and
           branches on it (None fast path / mask passthrough) — an
           entrypoint without it silently computes garbage lanes when
           the pool hands it a partially-occupied batch. A passthrough
           is an ``active=`` keyword or, in the port, the bare name
           ``active`` as a positional argument of a call
           (``_lane_predicate(active, q)``; ``autograd.Function.apply``
           takes no keywords);
  MASK202  every mode in ``packing.MASKED_MODES`` has a dispatcher arm
           in ``masked_pool_step`` — a registered mode with no arm is
           an unreachable execution path that tests cannot cover.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional

from repro_torch.analysis.core import Finding, SourceModule, register


def _find_toplevel_def(tree: ast.Module, name: str
                       ) -> Optional[ast.FunctionDef]:
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    return None


def _has_active_param(fn: ast.FunctionDef) -> bool:
    """``active`` must be keyword-accepting with a default of None."""
    args = fn.args
    # positional-or-keyword with default
    pos = args.posonlyargs + args.args
    n_def = len(args.defaults)
    for i, a in enumerate(pos):
        if a.arg == "active":
            d_idx = i - (len(pos) - n_def)
            if d_idx >= 0:
                d = args.defaults[d_idx]
                return isinstance(d, ast.Constant) and d.value is None
            return False
    for a, d in zip(args.kwonlyargs, args.kw_defaults):
        if a.arg == "active":
            return isinstance(d, ast.Constant) and d.value is None
    return False


def _honors_active(fn: ast.FunctionDef) -> bool:
    """The body must actually branch on / forward the mask: an
    ``active is (not) None`` test, an ``active=...`` keyword pass-
    through to a downstream masked call, or ``active`` itself passed
    positionally to a call. A parameter read only some other way (an
    assignment, an expression) does not count."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Compare):
            if (isinstance(node.left, ast.Name)
                    and node.left.id == "active"
                    and all(isinstance(op, (ast.Is, ast.IsNot))
                            for op in node.ops)
                    and all(isinstance(c, ast.Constant)
                            and c.value is None
                            for c in node.comparators)):
                return True
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg == "active":
                    return True
            if any(isinstance(a, ast.Name) and a.id == "active"
                   for a in node.args):
                return True
    return False


@register("MASK201", "active-contract",
          "packed entrypoints accept active= with an active=None "
          "passthrough")
def check_active_contract(modules, config) -> List[Finding]:
    out: List[Finding] = []
    by_rel: Dict[str, SourceModule] = {m.relpath: m for m in modules}
    for relpath, fn_names in sorted(config.mask_entrypoints.items()):
        mod = by_rel.get(relpath)
        if mod is None:
            continue   # path filters excluded it from this run
        for fn_name in fn_names:
            fn = _find_toplevel_def(mod.tree, fn_name)
            if fn is None:
                out.append(mod.finding(
                    "MASK201", "active-contract", 1,
                    f"configured packed entrypoint `{fn_name}` not "
                    f"found at module top level — update the lint "
                    f"config if it moved"))
                continue
            if not _has_active_param(fn):
                out.append(mod.finding(
                    "MASK201", "active-contract", fn,
                    f"packed entrypoint `{fn_name}` must accept "
                    f"`active=None` (per-lane predicate; the lane-mask "
                    f"contract) so the pool can hand it "
                    f"partially-occupied batches"))
            elif not _honors_active(fn):
                out.append(mod.finding(
                    "MASK201", "active-contract", fn,
                    f"`{fn_name}` takes `active=` but never branches "
                    f"on it (no `active is None` fast path, no "
                    f"`active=` passthrough) — the mask is ignored"))
    return out


@register("MASK202", "mode-dispatch",
          "every MASKED_MODES member has a dispatcher branch")
def check_mode_dispatch(modules, config) -> List[Finding]:
    out: List[Finding] = []
    spec = config.mask_dispatch
    if not spec:
        return out
    mod = next((m for m in modules if m.relpath == spec["module"]), None)
    if mod is None:
        return out

    modes = None
    const_node = None
    for node in mod.tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Name)
                        and t.id == spec["modes_const"]):
                    const_node = node
                    if isinstance(node.value, (ast.Tuple, ast.List)):
                        vals = []
                        for el in node.value.elts:
                            if (isinstance(el, ast.Constant)
                                    and isinstance(el.value, str)):
                                vals.append(el.value)
                        modes = vals
    if modes is None:
        out.append(mod.finding(
            "MASK202", "mode-dispatch", 1,
            f"could not statically read {spec['modes_const']} (must be "
            f"a literal tuple of strings)"))
        return out

    fn = _find_toplevel_def(mod.tree, spec["dispatcher"])
    if fn is None:
        out.append(mod.finding(
            "MASK202", "mode-dispatch", const_node,
            f"dispatcher `{spec['dispatcher']}` not found"))
        return out

    param = spec["param"]
    handled = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Compare):
            continue
        sides = [node.left] + list(node.comparators)
        names = [s for s in sides if isinstance(s, ast.Name)]
        consts = [s for s in sides if isinstance(s, ast.Constant)
                  and isinstance(s.value, str)]
        if any(n.id == param for n in names):
            for c in consts:
                handled.add(c.value)
    for mode in modes:
        if mode not in handled:
            out.append(mod.finding(
                "MASK202", "mode-dispatch", fn,
                f"mode {mode!r} is registered in "
                f"{spec['modes_const']} but `{spec['dispatcher']}` has "
                f"no `{param} == {mode!r}` branch — unreachable "
                f"execution mode"))
    return out
