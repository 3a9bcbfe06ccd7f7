"""Lint driver: walk configured paths (Python and CUDA sources, in sorted
order), parse, run rules, diff baseline."""
from __future__ import annotations

import dataclasses
import os
from typing import List

from repro_torch.analysis import baseline as bl
from repro_torch.analysis.config import LintConfig
from repro_torch.analysis.core import (CUDA_SUFFIXES, Finding, SourceModule,
                                       all_rule_ids, run_rules)

SUFFIXES = (".py",) + CUDA_SUFFIXES


@dataclasses.dataclass
class LintResult:
    modules: List[SourceModule]
    active: List[Finding]        # findings not suppressed by pragma
    suppressed: List[Finding]
    new: List[Finding]           # active findings beyond the baseline
    stale: List[str]             # baseline fingerprints no longer found

    @property
    def ok(self) -> bool:
        return not self.new and not self.stale


def collect_files(config: LintConfig) -> List[str]:
    files: List[str] = []
    for rel in config.paths:
        path = os.path.join(config.root, rel)
        if os.path.isfile(path):
            files.append(path)
            continue
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames.sort()
            for fn in sorted(filenames):
                if fn.endswith(SUFFIXES):
                    files.append(os.path.join(dirpath, fn))
    return files


def run_lint(config: LintConfig) -> LintResult:
    known = all_rule_ids()
    modules = [SourceModule.load(p, config.root, known)
               for p in collect_files(config)]
    active, suppressed, _ = run_rules(modules, config)
    base = bl.load_baseline(config.abs_baseline())
    new, stale = bl.diff_baseline(active, base)
    return LintResult(modules=modules, active=active,
                      suppressed=suppressed, new=new, stale=stale)
