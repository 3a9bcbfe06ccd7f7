"""Small cells for the CPU tests: the cell's files replaced by the tiny
configurations, mixes and limits under ``perfbench/tests/data``."""
from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from perfbench import common  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"
SEED = 2 ** 40 + 17          # above 32 bits, as the driver's are
# a serve window long enough to finish requests on a loaded CPU (a sweep
# window stays open until its compared tasks have run)
SERVE_S = 1.5
SWEEP_S = 0.3


def tiny_cell(kind: str) -> dict:
    cfg, mix = {"sweep": ("tiny-dense", "tiny-sweep"),
                "serve": ("tiny-dense", "tiny-serve")}[kind]
    return {"entry": {"name": f"tiny-{kind}"},
            "config": common.load_json(DATA / f"{cfg}.json"),
            "traffic": common.load_json(DATA / f"{mix}.json"),
            "limits": common.load_json(DATA / f"tiny-{kind}-limits.json")}


def run_tiny(kind: str, seconds: float = SERVE_S, trace: int = 0, plant=None,
             seed: int = SEED) -> dict:
    """One run of the real cell's harness on the CPU, on the tiny cell."""
    import time

    from perfbench.run import run_cell
    workload = {"sweep": "sweep-stablelm-4L",
                "serve": "serve-stablelm-code"}[kind]
    return run_cell(workload, seed, seconds, trace, device="cpu",
                    t_start=time.perf_counter(), cell=tiny_cell(kind),
                    plant=plant)


def env() -> dict:
    e = dict(os.environ)
    e["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    return e
