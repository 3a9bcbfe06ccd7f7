"""Peak device memory of one full-width StableLM-2 lane-pool step on the
card, as the port steps it and with the plain forms of two of its
memory savings.

    python3 chip_pool_peak.py [--lanes K]

The pool is ``chip_smoke.py``'s [train-lm] pool: K lanes (default 2) of
StableLM-2 1.6B at its published width cut to 4 layers, remat on, AdamW
as ``run_sweep`` builds it, batch 2 x 512 from ``SyntheticLM``. One
"where" pool step is run in each of these forms, each on a fresh pool:

- ``port``: as the package steps it;
- ``clip first``: AdamW clips the whole gradient tree with
  ``clip_by_global_norm`` before its update (the reference's form)
  instead of scaling each gradient leaf where the update uses it;
- ``plain where``: the masked step selects with ``tree_map(torch.where)``
  over the stepped trees (the reference's form), instead of dropping each
  stepped leaf once its selected copy exists;
- ``both``, then ``port`` again.

Each prints, as one JSON line, the step's peak of allocated bytes, that
peak above what the pool held before the step, and whether the stepped
params equal the first ``port`` run's bit for bit. Then the card's name
and power limit. Needs one card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def plain_masked_step(step_fn):
    """``packing.masked_step`` in the reference's form."""
    import torch
    from repro_torch.core import packing

    def step(params, opt_state, batch, hparams, active):
        new_p, new_o, metrics = step_fn(params, opt_state, batch, hparams)
        keep = lambda new, old: torch.where(active, new, old)
        return (packing.tree_map(keep, new_p, params),
                packing.tree_map(keep, new_o, opt_state), metrics)
    return step


def clip_first_adamw():
    """``optim.adamw(weight_decay=0.0)`` with the reference's clipping:
    the whole gradient tree clipped before the update (same values)."""
    from repro_torch import optim
    base = optim.adamw(weight_decay=0.0, grad_clip=0.0)

    def update(grads, state, params, lr):
        grads, _ = optim.clip_by_global_norm(grads, 1.0)
        return base.update(grads, state, params, lr)
    return optim.Optimizer(base.init, update)


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=2)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_pool_peak: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.core import packing
    from repro_torch.core.packing import tree_leaves
    from repro_torch.models import build_model

    cfg = dataclasses.replace(configs.get("stablelm-1.6b"),
                              num_layers=cs.TRAIN_LM_LAYERS)
    model = build_model(cfg, device="cuda")
    bf = cs.lm_batch_fn(cfg, cs.TRAIN_LM_SEQ, cs.TRAIN_LM_BATCH)
    port_step = packing.masked_step
    forms = (("port", False, False), ("clip first", True, False),
             ("plain where", False, True), ("both", True, True),
             ("port", False, False))
    first = None
    for name, clip_first, plain_where in forms:
        packing.masked_step = plain_masked_step if plain_where else port_step
        pool, batch = cs.lm_pool(model, args.lanes, bf,
                                 clip_first_adamw() if clip_first else None)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        pool.step(batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        params = [x.cpu() for x in tree_leaves(pool.params)]
        first = first or params
        same = all(torch.equal(a, b) for a, b in zip(params, first))
        print(json.dumps({"form": name, "lanes": args.lanes,
                          "peak_gb": peak / 1e9,
                          "above_pool_gb": (peak - before) / 1e9,
                          "params_equal_port": same}), flush=True)
        del pool, batch, params
        gc.collect()
        torch.cuda.empty_cache()
    packing.masked_step = port_step
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
