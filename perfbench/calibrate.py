"""The readings a cell's correctness limits are set from, on the card.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        --seconds <s> [--controls 3] [--faults 3]

For each seed one run of the cell as ``run.py`` makes it, printing the
compared numbers of the program (the lower readings). On the first
``--controls`` seeds also the control's: the family's reference in the
precision below the configuration's (fp8 products in place of bf16) put
in the program's place and compared as the program is. A training cell
also reads, on the first ``--faults`` seeds, each fault planted in the
port: half of each lane's batch left out (the loss a mean over the other
half), and a refilled lane that keeps the previous task's AdamW moments.
One JSON line a reading; the benchmark's own runs run none of this.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def half_batch(model_cls):
    """The sweep's model with each lane's loss over the first half of its
    rows only."""
    class HalfBatch(model_cls):
        def loss(self, params, batch):
            rows = batch["labels"].shape[0]
            return super().loss(params, {k: v[:rows // 2]
                                         for k, v in batch.items()})
    return HalfBatch


@contextlib.contextmanager
def stale_moments():
    """While open, a lane that the pool attaches a task to a second time
    keeps the AdamW moments (``mu``, ``nu``) of the task it held before;
    the rest of the task's state is written as usual."""
    from repro_torch.core import packing
    from repro_torch.core.lanepool import LanePool
    attach = LanePool.attach

    def attach_keeping_moments(self, lane, task_id, params, opt_state,
                               hparams):
        used = self.__dict__.setdefault("_lanes_used", set())
        kept = None
        if lane in used:
            kept = {k: packing.tree_copy(packing.tree_get_lane(
                self.opt_state[k], lane)) for k in ("mu", "nu")}
        attach(self, lane, task_id, params, opt_state, hparams)
        used.add(lane)
        if kept is not None:
            for k, v in kept.items():
                packing.tree_set_lane(self.opt_state[k], lane, v)

    LanePool.attach = attach_keeping_moments
    try:
        yield
    finally:
        LanePool.attach = attach


# the training faults: (plant handed to the driver, context it runs in)
SWEEP_FAULTS = {"half_batch": (half_batch, contextlib.nullcontext),
                "stale_moments": (None, stale_moments)}


def serve_control(out: dict, device) -> float:
    from perfbench.drivers.serve import logit_gaps
    c = out["compared"]
    return max(logit_gaps(c["fam"], c["port"], c["params"], r, c["s_pad"],
                          device, "fp8", pick="control")
               for r in c["picked"])


def sweep_control(out: dict, device, details: list = None) -> dict:
    """The control's numbers; with ``details``, each compared task's
    program and control readings in full (``gap_detail``) are appended
    to it."""
    from perfbench.drivers.sweep import gap_detail, gaps, reference_run
    c = out["compared"]
    worst: dict = {}
    for tid in c["prog"]:
        seed, lr, _ = c["spec"][tid]
        args = (c["fam"], c["port"], c["layout"], seed, lr, c["batch_fn"],
                c["traffic"], device)
        ref = reference_run(*args, "f32")
        low = reference_run(*args, "fp8")
        for k, v in gaps(low, ref).items():
            worst[k] = max(worst.get(k, 0.0), v)
        if details is not None:
            details.append({"task": tid, "lr": lr,
                            "program": gap_detail(c["prog"][tid], ref),
                            "control": gap_detail(low, ref)})
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    from perfbench import common
    from perfbench.run import forbidden_modules
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = common.cell(args.workload)
    kind = cell["traffic"]["driver"]
    driver = importlib.import_module(f"perfbench.drivers.{kind}")
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        out = driver.run(cell, seed, args.seconds, False, "cuda")
        rec = {"workload": args.workload, "seed": seed, "reading": "program",
               **{c["name"]: c["value"] for c in out["checks"]},
               "e2e": out["e2e"], "s": time.perf_counter() - t0}
        print(json.dumps(rec), flush=True)
        if i < args.controls:
            details: list = []
            ctl = (serve_control(out, "cuda") if kind == "serve"
                   else sweep_control(out, "cuda", details))
            if kind == "serve":
                ctl = {"logit_gap": ctl}
            for d in details:
                print(json.dumps({"seed": seed, "reading": "detail", **d}),
                      flush=True)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "reading": "control_fp8", **ctl}), flush=True)
        del out
        if kind == "sweep" and i < args.faults:
            for name, (plant, context) in SWEEP_FAULTS.items():
                with context():
                    bad = driver.run(cell, seed, args.seconds, False,
                                     "cuda", plant=plant)
                print(json.dumps({"workload": args.workload, "seed": seed,
                                  "reading": f"fault_{name}",
                                  **{c["name"]: c["value"]
                                     for c in bad["checks"]}}), flush=True)
                del bad
    print(json.dumps({"forbidden_modules": forbidden_modules()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
