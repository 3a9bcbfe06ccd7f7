"""Time the mamba2-130m prefill and one B4 call on the card, tree against tree.

    python3 chip_prefill_wall.py [--rounds R] TREE [TREE ...]

Each TREE is the root of a checkout of this repository (``.`` for this
one). Each gets a process of its own that imports ``repro_torch`` from
``TREE/src``, builds that tree's kernels into its own ``build/``, and
loads full-width mamba2-130m (random weights from seed 0) once. The
processes then take turns, R rounds (default 8), in the order given and
its reverse by turns (A B B A ...), so that a host that grows slower or
faster during the run weighs on every tree alike; a process waits on its
pipe while another measures. One turn of a tree measures:

- ``prefill_ms``: host-clock wall of ``Model.prefill`` on one 1024-token
  prompt from numpy seed 0, median of 10 calls after 2 warm ones;
- ``b4_host_us``: host time per ``ssd_scan_cuda`` call at the serving
  prefill's shape (1, 1024, 24, 64), N = 128, chunk 128, bf16, issued 200
  times back to back without waiting for the card;
- ``b4_event_ms``: CUDA-event time per call of the same 200 calls.

It prints one JSON line per turn, then one per tree with the median of its
turns and, for each earlier tree, the median over rounds of the
difference between the two in the same round, then the card's name
and power limit from ``nvidia-smi``. Needs one card; exits non-zero
without one or when a process fails, and stops every process it starts.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

SSD_SERVE = (1, 1024, 24, 64, 128, 128)
KEYS = ("prefill_ms", "b4_host_us", "b4_event_ms")


def serve_turns(tree: str) -> None:
    """The child: load the model, then measure one turn per line read."""
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.kernels import ssd_scan as sd
    from repro_torch.models.model import Model

    cfg = configs.get("mamba2-130m")
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 1024)).astype(np.int64)).cuda()
    b, S, nh, hd, N, Q = SSD_SERVE
    gen = torch.Generator(device="cuda").manual_seed(4)
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    args = (mk(b, S, nh, hd).bfloat16(), F.softplus(mk(b, S, nh) - 3.0),
            -(1.0 + 15.0 * torch.rand(nh, generator=gen, device="cuda")),
            mk(b, S, N).bfloat16(), mk(b, S, N).bfloat16())
    calls = 200
    print("ready", flush=True)
    for _ in sys.stdin:
        walls = []
        with torch.inference_mode():
            for i in range(12):
                t0 = time.perf_counter()
                model.prefill(params, {"tokens": toks}, max_len=2048)
                torch.cuda.synchronize()
                if i >= 2:
                    walls.append(1e3 * (time.perf_counter() - t0))
            for _ in range(5):
                sd.ssd_scan_cuda(*args, chunk=Q)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            for _ in range(calls):
                sd.ssd_scan_cuda(*args, chunk=Q)
            host = time.perf_counter() - t0
            end.record()
            torch.cuda.synchronize()
        print(json.dumps({"prefill_ms": statistics.median(walls),
                          "b4_host_us": 1e6 * host / calls,
                          "b4_event_ms": start.elapsed_time(end) / calls}),
              flush=True)


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--child":
        serve_turns(argv[2])
        return 0
    rounds = 8
    if len(argv) > 2 and argv[1] == "--rounds":
        rounds, argv = int(argv[2]), argv[:1] + argv[3:]
    import torch
    trees = argv[1:]
    if not trees or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--child", tree], stdin=subprocess.PIPE,
                              stdout=subprocess.PIPE, text=True)
             for tree in trees]
    turns = [[] for _ in trees]
    try:
        for proc, tree in zip(procs, trees):
            if proc.stdout.readline().strip() != "ready":
                raise RuntimeError(f"{tree}: the timing process failed")
        for r in range(rounds):
            order = range(len(trees)) if r % 2 == 0 else \
                reversed(range(len(trees)))
            for k in order:
                procs[k].stdin.write("go\n")
                procs[k].stdin.flush()
                line = procs[k].stdout.readline()
                if not line:
                    raise RuntimeError(f"{trees[k]}: the timing process "
                                       f"ended")
                turn = json.loads(line)
                turns[k].append(turn)
                print(json.dumps({"round": r, "tree": trees[k], **turn}),
                      flush=True)
    finally:
        for proc in procs:
            proc.stdin.close()
        for proc in procs:
            proc.wait(timeout=120)
    if any(proc.returncode for proc in procs):
        return 1
    for k, tree in enumerate(trees):
        row = {"tree": tree, "turns": rounds}
        for key in KEYS:
            row[key] = statistics.median(t[key] for t in turns[k])
            for j in range(k):
                row[f"{key}_minus_{trees[j]}"] = statistics.median(
                    a[key] - b[key] for a, b in zip(turns[k], turns[j]))
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
