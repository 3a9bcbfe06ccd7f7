"""The contract of every ``__global__`` kernel of the port, and what the
built libraries say of each (port of ``repro.analysis.kernel_report``).

    PYTHONPATH=src python -m repro_torch.analysis.kernel_report           # table
    PYTHONPATH=src python -m repro_torch.analysis.kernel_report --json
    PYTHONPATH=src python -m repro_torch.analysis.kernel_report --check   # gate
    PYTHONPATH=src python -m repro_torch.analysis.kernel_report --check --libs

Without ``--libs`` it gives one static row per kernel, from
``cuda_model``: the lane predicate and whether it comes before the first
global load, the ``blockIdx`` axes read and each launch's grid rank, the
launch bounds, and the shared memory per CTA modelled at the budget's
nominal dims beside the budget.

With ``--libs`` it also reads each library under ``build/kernels/``
(``kernels._build.library_path``; a missing one is built first, which
needs ``nvcc``) with ``cuobjdump --dump-resource-usage``: registers,
stack, local and shared memory per instantiation. That holds on a cached
build too. Where this run compiled a library, the spill stores and loads
come from the ``-Xptxas -v`` log ``_build.build`` returns.

``--check`` fails (exit 1) on any CUD finding of the lint that the
baseline does not tolerate, on a masked kernel not gated before its first
load, and with ``--libs`` on: a kernel of the sources with no
instantiation in the libraries; an instantiation over its register
ceiling or its local-memory budget, or with spills in the log; a
library's static shared memory that differs from the model's (plus the
runtime's reserved 1 KB in a module that uses shared memory). Exit status
2 on usage errors.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.analysis import cuda_model as cm
from repro_torch.analysis.config import LintConfig, default_config
from repro_torch.analysis.driver import collect_files, run_lint
from repro_torch.roofline.budgets import RESERVED_SMEM

REPORT_VERSION = 1


def _cuda_home() -> str:
    return os.environ.get("CUDA_HOME", "/usr/local/cuda")


def cuobjdump() -> str:
    """The toolkit's cuobjdump: on PATH, under CUDA_HOME, or the copy in
    Triton's package."""
    cands = [shutil.which("cuobjdump"),
             os.path.join(_cuda_home(), "bin", "cuobjdump")]
    for cand in cands:
        if cand and os.path.exists(cand):
            return cand
    try:
        import triton
    except ImportError:
        triton = None
    if triton is not None:
        cand = Path(triton.__file__).parent / "backends/nvidia/bin/cuobjdump"
        if cand.exists():
            return str(cand)
    raise RuntimeError("cuobjdump not found: reading the libraries needs "
                       "the CUDA toolkit (set CUDA_HOME)")


_ANONYMOUS = re.compile(r"(?:\(anonymous namespace\)|<unnamed>)::")
_ARG_CAST = re.compile(r"\((?:unsigned |signed )?(?:int|long|short|char|bool"
                       r"|long long)\)(?=-?\d)")


def normalize(name: str) -> str:
    """One spelling for both demanglers: cu++filt's ``<unnamed>::`` and
    ``(int)128`` read as c++filt's ``(anonymous namespace)::`` and ``128``,
    and the anonymous namespace dropped."""
    return _ARG_CAST.sub("", _ANONYMOUS.sub("", name))


def demangle(names: Sequence[str]) -> List[str]:
    """``names`` demangled by the toolkit's cu++filt (or c++filt) and
    ``normalize``d; unchanged where neither tool is found."""
    filt = os.path.join(_cuda_home(), "bin", "cu++filt")
    if not os.path.exists(filt):
        filt = shutil.which("c++filt") or ""
    if not names or not filt:
        return list(names)
    out = subprocess.run([filt], input="\n".join(names), capture_output=True,
                         text=True, timeout=60)
    pretty = out.stdout.splitlines()
    if out.returncode != 0 or len(pretty) != len(names):
        return list(names)
    return [normalize(p) for p in pretty]


def kernel_resources(ptxas_log: str,
                     demangler: Callable = demangle) -> list:
    """(kernel, registers, spill-store bytes, spill-load bytes) of each
    entry function in an ``nvcc -Xptxas -v`` log, names demangled."""
    rows, name, spills = [], None, ("?", "?")
    for line in ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spills = m.group(1), ("?", "?")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = tuple(int(x) for x in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            rows.append([name, int(m.group(1)), *spills])
            name = None
    for row, pretty in zip(rows, demangler([r[0] for r in rows])):
        row[0] = pretty
    return [tuple(r) for r in rows]


_FUNCTION = re.compile(r"^\s*Function\s+(\S+?):\s*$")
_FIELD = re.compile(r"([A-Z]+(?:\[\d+\])?):(\d+)")


def parse_resource_usage(text: str, demangler: Callable = demangle
                         ) -> List[Dict]:
    """The functions of a ``cuobjdump --dump-resource-usage`` listing:
    mangled and demangled name, registers, stack, shared and local bytes."""
    rows: List[Dict] = []
    pending = None
    for line in text.splitlines():
        m = _FUNCTION.match(line)
        if m:
            pending = m.group(1)
            continue
        if pending is not None and "REG:" in line:
            f = dict(_FIELD.findall(line))
            rows.append({"mangled": pending, "registers": int(f["REG"]),
                         "stack": int(f.get("STACK", 0)),
                         "shared": int(f.get("SHARED", 0)),
                         "local": int(f.get("LOCAL", 0))})
            pending = None
    for row, pretty in zip(rows, demangler([r["mangled"] for r in rows])):
        row["name"] = _signature_free(normalize(pretty))
    return rows


def _signature_free(name: str) -> str:
    """``void ns::k<float, 64>(Params)`` -> ``ns::k<float, 64>``."""
    name = name.strip()
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, c in enumerate(name):
        if c == "<":
            depth += 1
        elif c == ">":
            depth -= 1
        elif c == "(" and depth == 0:
            return name[:i].strip()
    return name


def base_name(instance: str) -> str:
    """``simt::gemm_simt_kernel<simt::Tile<...> >`` -> ``gemm_simt_kernel``."""
    head = instance.split("<", 1)[0]
    return head.split("::")[-1].strip()


def template_args(instance: str) -> List[str]:
    if "<" not in instance:
        return []
    inner = instance[instance.index("<") + 1:instance.rindex(">")]
    parts, depth, cur = [], 0, ""
    for c in inner:
        if c == "<":
            depth += 1
        elif c == ">":
            depth -= 1
        if c == "," and depth == 0:
            parts.append(cur.strip())
            cur = ""
        else:
            cur += c
    parts.append(cur.strip())
    return [p for p in parts if p]


# ---------------------------------------------------------------------------
# the static report
# ---------------------------------------------------------------------------

def load_sources(config: LintConfig) -> List[cm.CudaSource]:
    """The CUDA sources under the configured paths, in the lint's order."""
    out = []
    for path in collect_files(config):
        if path.endswith(".cu"):
            rel = os.path.relpath(path, config.root).replace(os.sep, "/")
            out.append(cm.load(path, rel))
    return out


def _kernel_entry(src: cm.CudaSource, k: cm.Kernel,
                  config: LintConfig) -> Dict:
    key = f"{src.relpath}::{k.name}"
    budget = config.kernel_budgets.get(key) or {}
    masked = k.name in config.masked_kernels.get(src.relpath, {})
    try:
        smem: Optional[int] = src.shared_bytes(k, budget.get("nominal", {}))
    except (cm.Unresolved, ValueError):
        smem = None
    return {
        "path": src.relpath,
        "kernel": k.name,
        "line": k.line,
        "template": [f"{kind} {name}" for kind, name in k.template],
        "launch_bounds": list(k.launch_bounds),
        "block_axes": list(k.block_axes),
        "launches": [{"line": ln.line, "grid_rank": ln.grid_rank}
                     for ln in k.launches],
        "masked": masked,
        "lane_predicate": k.gate_line is not None,
        "gate_line": k.gate_line,
        "first_load_line": k.first_load_line,
        "gated_before_load": k.gated_before_load,
        "atomics": len(k.atomics),
        "smem_bytes": smem,
        "smem_budget": budget.get("smem_bytes"),
        "registers_budget": budget.get("registers"),
    }


def build_report(config: LintConfig) -> Dict:
    """The static report as a JSON-serialisable dict; deterministic (the
    lint's sorted walk, kernels in source order within a file)."""
    kernels: List[Dict] = []
    for src in load_sources(config):
        kernels.extend(_kernel_entry(src, k, config) for k in src.kernels)
    return {
        "version": REPORT_VERSION,
        "paths": list(config.paths),
        "kernels": kernels,
        "n_kernels": len(kernels),
        "n_masked": sum(1 for k in kernels if k["masked"]),
        "n_gated": sum(1 for k in kernels
                       if k["masked"] and k["gated_before_load"]),
    }


def _format_table(rep: Dict) -> str:
    lines = []
    for k in rep["kernels"]:
        grids = ",".join(str(ln["grid_rank"]) for ln in k["launches"])
        lines.append(
            f"{k['path']}:{k['line']}: {k['kernel']} "
            f"axes={''.join(k['block_axes']) or '-'} grids={grids or '-'} "
            f"bounds=({', '.join(k['launch_bounds'])}) "
            f"lane_predicate={k['lane_predicate']} "
            f"gated_before_load={k['gated_before_load']} "
            f"smem={k['smem_bytes']}/{k['smem_budget']} B")
    lines.append(f"kernel_report: {rep['n_kernels']} kernel(s), "
                 f"{rep['n_masked']} masked, {rep['n_gated']} gated before "
                 f"their first load")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the libraries
# ---------------------------------------------------------------------------

def read_libraries(logs: Optional[Dict[str, str]] = None,
                   demangler: Callable = demangle) -> List[Dict]:
    """One row per kernel instantiation in the built libraries: library,
    instance, registers, stack/local/shared bytes, and spill bytes from
    ``logs`` (``_build.build``'s output for the libraries it compiled; None
    to build what is missing now and use its logs)."""
    from repro_torch.kernels import _build
    if logs is None:
        logs = _build.build()
    tool = cuobjdump()
    rows = []
    for lib in _build.SOURCES:
        text = subprocess.run(
            [tool, "--dump-resource-usage", str(_build.library_path(lib))],
            check=True, capture_output=True, text=True, timeout=120).stdout
        rows.extend(library_rows(lib, text, logs.get(lib), demangler))
    return rows


def library_rows(lib: str, usage: str, log: Optional[str],
                 demangler: Callable = demangle) -> List[Dict]:
    """The rows of one library from its resource listing and, where it was
    compiled in this run, its ``ptxas`` log."""
    spills = {}
    if log:
        for name, _, st, ld in kernel_resources(log, demangler):
            spills[_signature_free(normalize(name))] = (st, ld)
    out = []
    for r in parse_resource_usage(usage, demangler):
        st, ld = spills.get(r["name"], (None, None))
        out.append({"library": lib, "instance": r["name"],
                    "kernel": base_name(r["name"]),
                    "registers": r["registers"], "stack": r["stack"],
                    "local": r["local"], "shared": r["shared"],
                    "spill_stores": st, "spill_loads": ld})
    return out


def check_libraries(rows: Sequence[Dict], sources: Sequence[cm.CudaSource],
                    config: LintConfig) -> List[str]:
    """The failures of ``rows`` against the sources and budgets; each row
    gains ``budget_registers``, ``model_shared`` and ``ok``."""
    problems: List[str] = []
    by_kernel: Dict[str, tuple] = {}
    for src in sources:
        lib = Path(src.relpath).stem
        for k in src.kernels:
            by_kernel[(lib, k.name)] = (src, k)
    seen = set()
    for row in rows:
        hit = by_kernel.get((row["library"], row["kernel"]))
        row["ok"] = True
        if hit is None:
            problems.append(f"{row['library']}: {row['instance']} has no "
                            f"__global__ kernel in the sources")
            row["ok"] = False
            continue
        src, k = hit
        seen.add((row["library"], row["kernel"]))
        budget = config.kernel_budgets.get(f"{src.relpath}::{k.name}", {})
        bad = []
        ceiling = budget.get("registers")
        row["budget_registers"] = ceiling
        if ceiling is None or row["registers"] > ceiling:
            bad.append(f"{row['registers']} registers over the ceiling "
                       f"{ceiling}")
        if row["local"] > budget.get("local_bytes", 0):
            bad.append(f"{row['local']} B of local memory over its budget "
                       f"{budget.get('local_bytes', 0)}")
        spill = [x for x in (row["spill_stores"], row["spill_loads"])
                 if isinstance(x, int)]
        if sum(spill) > budget.get("spill_bytes", 0):
            bad.append(f"spills {row['spill_stores']}/{row['spill_loads']} "
                       f"B (stores/loads)")
        try:
            env = src.kernel_env(k, ())
            targs = [src.ev.template_arg(cm.tokenize(a), env)
                     for a in template_args(row["instance"])]
            model = src.static_shared_bytes(k, targs)
            model += RESERVED_SMEM if src.uses_shared() else 0
        except (cm.Unresolved, ValueError) as e:
            model = None
            bad.append(f"static shared memory not modelled ({e})")
        row["model_shared"] = model
        if model is not None and model != row["shared"]:
            bad.append(f"static shared memory {row['shared']} B, the model "
                       f"says {model} B")
        if bad:
            row["ok"] = False
            problems.append(f"{row['library']}: {row['instance']}: "
                            + "; ".join(bad))
    for (lib, name), (src, k) in sorted(by_kernel.items()):
        if (lib, name) not in seen:
            problems.append(f"{src.relpath}:{k.line}: {name} has no "
                            f"instantiation in the {lib} library")
    return problems


def format_rows(rows: Sequence[Dict]) -> List[str]:
    out = []
    for r in rows:
        spill = ("not read (cached build)" if r["spill_stores"] is None
                 else f"{r['spill_stores']}/{r['spill_loads']} B")
        out.append(f"{r['library']}: {r['instance']}: {r['registers']} "
                   f"registers (ceiling {r.get('budget_registers')}), "
                   f"spills {spill}, local {r['local']} B, shared "
                   f"{r['shared']} B (model {r.get('model_shared')})")
    return out


def check_static(rep: Dict, result) -> List[str]:
    """The CUD findings of the lint's ``result`` that the baseline does not
    tolerate, and every masked kernel not gated before its first load."""
    out = [f.render() for f in result.new if f.rule.startswith("CUD")]
    out += [f"stale baseline entry (fixed but shrink not committed): {fp}"
            for fp in result.stale if fp.startswith("CUD")]
    for k in rep["kernels"]:
        if k["masked"] and not k["gated_before_load"]:
            out.append(f"{k['path']}:{k['line']}: {k['kernel']} is not "
                       f"gated before its first load")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.kernel_report",
        description="the contract of every __global__ kernel of the port, "
                    "and with --libs what the built libraries say of each")
    ap.add_argument("--root", default=None,
                    help="checkout root (default: derived from the "
                         "package location)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable report on stdout")
    ap.add_argument("--out", default=None,
                    help="also write the JSON report to this file")
    ap.add_argument("--check", action="store_true",
                    help="gate mode: exit 1 on a CUD finding, an ungated "
                         "masked kernel, or (with --libs) a library "
                         "outside its budgets")
    ap.add_argument("--libs", action="store_true",
                    help="read registers, local and shared memory of every "
                         "instantiation from the built libraries")
    args = ap.parse_args(argv)

    try:
        config = default_config(root=args.root)
        rep = build_report(config)
        problems = (check_static(rep, run_lint(config)) if args.check
                    else [])
        if args.libs:
            rows = read_libraries()
            problems += check_libraries(rows, load_sources(config), config)
            rep["instances"] = rows
    except (OSError, SyntaxError, ValueError, RuntimeError,
            subprocess.SubprocessError) as e:
        print(f"kernel_report: error: {e}", file=sys.stderr)
        return 2

    text = json.dumps(rep, indent=2, sort_keys=True)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    if args.as_json:
        print(text)
    else:
        print(_format_table(rep))
        if args.libs:
            print("\n".join(format_rows(rep["instances"])))
    if args.check:
        for p in problems:
            print(f"kernel_report: {p}")
        print(f"kernel_report: {rep['n_kernels']} kernel(s), "
              f"{len(rep.get('instances', []))} instantiation(s) read, "
              f"{len(problems)} problem(s)" + ("" if problems else
                                               " — clean"))
        return 1 if problems else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
