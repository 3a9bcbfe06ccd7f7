"""What every part of the harness shares: where its files are, the cell's
settings read from them, seeds, and the card's published peaks."""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12


def load_json(path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(workload: str, bench: dict = None) -> dict:
    """The settings of one cell: its ``BENCHMARK.json`` entry, with the
    configuration file (``config``), the traffic file (``traffic``) and
    the limits file (``limits``) read in."""
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return {"entry": entry,
            "config": load_json(ROOT / conf["file"]),
            "traffic": load_json(HERE / "traffic" /
                                 f"{entry['traffic']}.json"),
            "limits": load_json(HERE / "limits" / f"{workload}.json")}


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed derived from the run's seed and ``tags`` (ints or
    strings), the same on every machine."""
    words = [int(seed) % (1 << 64), int(seed) >> 64]
    for t in tags:
        words.extend(t.encode() if isinstance(t, str) else [int(t)])
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def port_config(cfg_file: dict):
    """The port's ``ModelConfig`` from the configuration file's ``port``
    group."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**cfg_file["port"])


def padded_vocab(port: dict) -> int:
    p = port.get("vocab_pad_to", 256)
    return int(math.ceil(port["vocab_size"] / p) * p)


def check(name: str, value, limit, rule: str = "max") -> dict:
    """A compared number: it passes when at most (``rule="max"``) or at
    least (``"min"``) its limit."""
    ok = value <= limit if rule == "max" else value >= limit
    return {"name": name, "value": value, "limit": limit, "rule": rule,
            "ok": bool(ok)}
