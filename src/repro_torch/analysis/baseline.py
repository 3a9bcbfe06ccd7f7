"""Zero-drift baseline: the committed ledger of tolerated findings.

The baseline maps finding fingerprints (line-number-free; see
``Finding.fingerprint``) to counts. ``--check`` fails on EITHER
direction of drift:

  * a finding not covered by the baseline (new violation), or
  * a baseline entry with no matching finding (the violation was fixed
    but the shrink was not committed — a stale baseline would mask the
    next regression at the same fingerprint).

The repo lands with an EMPTY baseline: every real finding is either
fixed or pragma-suppressed with a reason at the line. The baseline
exists for ratcheting future rules in over a dirty codebase, not as a
dumping ground.
"""
from __future__ import annotations

import collections
import json
import os
from typing import Dict, List, Sequence, Tuple

from repro_torch.analysis.core import Finding

VERSION = 1


def count_findings(findings: Sequence[Finding]) -> Dict[str, int]:
    counts: Dict[str, int] = collections.Counter()
    for f in findings:
        counts[f.fingerprint] += 1
    return dict(counts)


def load_baseline(path: str) -> Dict[str, int]:
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    if data.get("version") != VERSION:
        raise ValueError(
            f"baseline {path} has version {data.get('version')!r}; "
            f"this linter writes version {VERSION} — regenerate with "
            f"--update-baseline")
    findings = data.get("findings", {})
    if not isinstance(findings, dict):
        raise ValueError(f"baseline {path}: 'findings' must be a mapping")
    return {str(k): int(v) for k, v in findings.items()}


def save_baseline(path: str, findings: Sequence[Finding]) -> None:
    payload = {
        "version": VERSION,
        "findings": dict(sorted(count_findings(findings).items())),
    }
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)


def diff_baseline(findings: Sequence[Finding], baseline: Dict[str, int]
                  ) -> Tuple[List[Finding], List[str]]:
    """Returns ``(new, stale)``: findings beyond their baselined count,
    and baseline fingerprints whose counted findings shrank."""
    current = count_findings(findings)
    budget = dict(baseline)
    new: List[Finding] = []
    for f in findings:
        if budget.get(f.fingerprint, 0) > 0:
            budget[f.fingerprint] -= 1
        else:
            new.append(f)
    stale = sorted(fp for fp, n in budget.items()
                   if n > 0 and current.get(fp, 0) < baseline[fp])
    return new, stale
