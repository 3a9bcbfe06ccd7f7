"""Run one cell of ``BENCHMARK.json`` once and print its result.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its limit
(also the last lines of standard error). Without a CUDA card, with fewer
cards than the cell asks for, or when JAX or the JAX package was loaded,
it prints no result and exits with a code other than 0.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def forbidden_modules(names=None) -> list:
    """Top-level names (whole, before the first dot) of the loaded modules
    (or of ``names``) that the port's benchmark must not load."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)


def _metric_reader(name: str):
    path = ROOT / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _reports(metric: dict, workload: str, e2e_names: set) -> bool:
    """Whether ``workload`` reports ``metric``: listed in its
    ``workloads``, or, without that key, every cell that reports the
    metric it moves (every cell for an end-to-end metric)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_names


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float = None, cell: dict = None,
             bench: dict = None, plant=None) -> dict:
    """One run of ``workload``: the result object, ``checks`` last.
    ``cell`` replaces the cell's files (the tests' small cells) and
    ``plant`` breaks the port before the run (the tests' faults)."""
    import torch

    from perfbench import common
    t_start = T_START if t_start is None else t_start
    bench = bench or common.benchmark()
    cell = cell or common.cell(workload, bench)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = importlib.import_module(
        f"perfbench.drivers.{cell['traffic']['driver']}")
    out = driver.run(cell, seed, seconds, bool(trace), device, plant)
    setup_s = out["t_open"] - t_start

    e2e = {m["name"]: m for m in bench["end_to_end"]
           if _reports(m, workload, set())}
    metrics = {}
    if not trace:
        values = dict(out["e2e"], setup_s=setup_s)
        for name, m in e2e.items():
            metrics[name] = {"value": values[name], "unit": m["unit"]}
    else:
        ctx = dict(out["ctx"], workload=workload,
                   port=cell["config"]["port"], traffic=cell["traffic"])
        for m in bench["per_layer"]:
            if _reports(m, workload, set(e2e)):
                value = _metric_reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    device_info = {
        "platform": "gpu" if on_card else dev.type,
        "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
        "count": 1,
        "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": all(c["ok"] for c in out["checks"]),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_info}
    if trace and out["ctx"]["trace"]:
        tr = out["ctx"]["trace"]
        device_info["busy_s"] = tr["busy_s"]
        device_info["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"],
                                    "rule": c["rule"]}
                        for c in out["checks"]}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # build and kernel caches at fixed places inside the checkout (the
    # port's own CUDA libraries go to build/kernels/ there)
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")

    import torch

    from perfbench import common
    bench = common.benchmark()
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < entry["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell needs {entry['chips']} CUDA card(s); {have} present",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, args.trace,
                      bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        op = "<=" if c["rule"] == "max" else ">="
        print(f"check {name}: {c['value']!r} {op} {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
