"""Human and machine rendering of a lint run."""
from __future__ import annotations

import collections
import json
from typing import List, Sequence

from repro_torch.analysis.core import Finding


def format_findings(findings: Sequence[Finding]) -> str:
    return "\n".join(f.render() for f in findings)


def summary_line(active: Sequence[Finding], suppressed: Sequence[Finding],
                 n_files: int) -> str:
    by_rule = collections.Counter(f.rule for f in active)
    detail = ", ".join(f"{r}×{n}" for r, n in sorted(by_rule.items()))
    head = (f"{len(active)} finding(s) in {n_files} file(s)"
            if active else f"clean: 0 findings in {n_files} file(s)")
    if detail:
        head += f" [{detail}]"
    if suppressed:
        head += f" ({len(suppressed)} suppressed by pragma)"
    return head


def to_json(active: Sequence[Finding], suppressed: Sequence[Finding],
            new: Sequence[Finding], stale: Sequence[str],
            n_files: int) -> str:
    def row(f: Finding) -> dict:
        return {"rule": f.rule, "name": f.name, "path": f.path,
                "line": f.line, "context": f.context,
                "message": f.message, "fingerprint": f.fingerprint}
    return json.dumps({
        "files": n_files,
        "active": [row(f) for f in active],
        "suppressed": [row(f) for f in suppressed],
        "new": [row(f) for f in new],
        "stale_baseline": list(stale),
    }, indent=1)


#: The reference's rules with no counterpart here, and why.
NOT_PORTED = {
    "JAX101": "use after donate: nothing in the port donates a buffer, and "
              "its step factories return fresh tensors",
    "JAX102": "jit in a loop: the port compiles no graph (no TorchDynamo, "
              "no CUDA graphs); a counterpart comes with the first that does",
    "JAX103": "a Python branch on a traced value: under torch.func such a "
              "branch raises at once instead of going wrong silently",
    "PAL402": "affine index maps for scalar-prefetch pruning: a TPU grid "
              "mechanism; a CUDA CTA of an inactive lane ends on its own "
              "(CUD403)",
}


def rule_catalog(rules) -> str:
    lines: List[str] = []
    for rule in sorted(rules.values(), key=lambda r: r.id):
        lines.append(f"{rule.id}  {rule.name:24s} {rule.doc}")
    lines.append("LNT001  malformed-pragma         pragmas need "
                 "`RULE(reason)` with a non-empty reason")
    lines.append("LNT002  unused-pragma            pragmas that suppress "
                 "nothing must be deleted")
    for rid, why in sorted(NOT_PORTED.items()):
        lines.append(f"{rid}  {'(not ported)':24s} {why}")
    return "\n".join(lines)
