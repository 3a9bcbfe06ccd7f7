"""Count the train cells whose query heads the 16-wide "model" axis does not
divide, with their attention split over "model" each way the port can split it.

    PYTHONPATH=src python3 dryrun_attention_split.py [--out DIR] [--jobs N]

The cells: qwen2-vl-7b (28 query heads on 4 KV heads) and arctic-480b (56 on
8) at train_4k on the 16x16 mesh. The ways:

- ``program``: as the port splits it (``attention._on_mesh``): each rank
  attends with every head for its own rows (``attention._rows_over_model``);
- ``head_shares``: each rank attends with its share of ceil(Hq / 16) query
  heads, padded with heads of zero input (``attention._head_share_map``, what
  the port does where it writes a cache or the batch does not divide).

Each (cell, way) is counted by ``repro_torch.launch.dryrun.run_cell`` on
``meta`` tensors in a fake group of 256 ranks, in a child process of its own,
``--jobs`` at a time (default 4), and its row is written under ``--out``
(default ``artifacts/attention_split``), tagged with the way. The script
prints one JSON line per count (TFLOP, and arg, temp, out, peak and collective
GB a device), then each way's ratios to ``program`` in the same cell. Counts,
not measurements: no card is needed, and each child holds a few GB of host
memory. Exits non-zero if a count fails, and stops every process it starts.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ARCHS = ("qwen2-vl-7b", "arctic-480b")
SHAPE = "train_4k"
WAYS = ("program", "head_shares")
KEYS = ("arg_gb_dev", "temp_gb_dev", "out_gb_dev", "peak_gb_dev",
        "coll_gb_dev")


def _split_as(way: str, arch: str) -> None:
    """Make the attention split over "model" as ``way`` says."""
    from repro_torch import configs
    from repro_torch.models import attention
    if way == "head_shares":
        cfg = configs.get(arch)

        def rows_as_shares(fn, q, k, v, extra, extra_placements, whole):
            return attention._head_share_map(
                fn, q, k, v, extra, extra_placements, whole, cfg.num_heads,
                cfg.num_kv_heads)
        attention._rows_over_model = rows_as_shares
    elif way != "program":
        raise ValueError(f"unknown way {way!r}")


def child(arch: str, shape: str, way: str, out: str) -> None:
    """Count one cell one way; exit 1 if the count fails."""
    from repro_torch.launch import dryrun
    _split_as(way, arch)
    row = dryrun.run_cell(arch, shape, False, out,
                          tag=None if way == "program" else way)
    if row is None or "error" in row:
        raise SystemExit(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join("artifacts",
                                                  "attention_split"))
    ap.add_argument("--jobs", type=int, default=4)
    args = ap.parse_args(argv)
    todo = [(a, SHAPE, w) for a in ARCHS for w in WAYS]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    running, rows, failed = {}, {}, []
    t0 = time.perf_counter()
    try:
        while todo or running:
            while todo and len(running) < args.jobs:
                cell = todo.pop(0)
                running[cell] = subprocess.Popen(
                    [sys.executable, "-c",
                     "import dryrun_attention_split as m; "
                     f"m.child(*{cell!r}, {args.out!r})"],
                    env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)
            cell = next(iter(running))
            proc = running.pop(cell)
            text = proc.communicate()[0]
            arch, shape, way = cell
            name = f"{arch}__{shape}__16datax16model" + (
                "" if way == "program" else f"__{way}")
            if proc.returncode != 0:
                failed.append(cell)
                print(text[-3000:])
                continue
            with open(os.path.join(args.out, name + ".json")) as f:
                row = json.load(f)
            rows[cell] = {"tflop_dev": row["gflops_dev"] / 1e3,
                          **{k: row[k] for k in KEYS}}
            print(json.dumps({"arch": arch, "shape": shape, "way": way,
                              **rows[cell]}), flush=True)
    finally:
        for proc in running.values():
            proc.kill()
            proc.communicate()
    for (arch, shape, way), r in rows.items():
        base = rows.get((arch, shape, "program"))
        if way != "program" and base:
            print(f"[attention-split] {arch} {shape} {way} / program: "
                  + ", ".join(f"{k} {r[k] / base[k]:.4f}" for k in r
                              if base[k]))
    print(f"[attention-split] {len(rows)} counted, {len(failed)} failed, "
          f"{time.perf_counter() - t0:.1f} s")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
