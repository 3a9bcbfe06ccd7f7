"""ACC — monitor-counter symmetry at call sites.

TenantGauges counters come in matched pairs: what on_dispatch adds,
on_release subtracts; every on_preempt expects an eventual on_resume;
every on_slice_alloc an on_slice_release. A call-site layer (the
scheduler's dispatch loop, the simulator) that invokes one member of a
pair and never the other leaks holdings monotonically — the LLload
table then lies to the operator and to the RepackController that feeds
on it (DESIGN.md §4, §9).

  ACC301  a module configured in ``acc_modules`` calls one member of an
          ``acc_pairs`` pair but never its partner.
"""
from __future__ import annotations

import ast
from typing import Dict, List

from repro_torch.analysis.core import Finding, context_of, register


@register("ACC301", "counter-symmetry",
          "monitor counter pairs must both be called where either is")
def check_counter_symmetry(modules, config) -> List[Finding]:
    out: List[Finding] = []
    members = {m for pair in config.acc_pairs for m in pair}
    for mod in modules:
        if mod.relpath not in config.acc_modules:
            continue
        # first call site per callback name (attribute calls only:
        # `<gauges>.on_dispatch(...)`)
        sites: Dict[str, ast.Call] = {}
        for node in ast.walk(mod.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in members):
                sites.setdefault(node.func.attr, node)
        for a, b in config.acc_pairs:
            for present, absent in ((a, b), (b, a)):
                if present in sites and absent not in sites:
                    node = sites[present]
                    out.append(mod.finding(
                        "ACC301", "counter-symmetry", node,
                        f"module calls .{present}() but never "
                        f".{absent}() — the pair's gauges drift "
                        f"monotonically; call the partner on the "
                        f"matching lifecycle edge (or pragma if this "
                        f"layer genuinely only sees one edge)",
                        context_of(mod, node)))
    return out
