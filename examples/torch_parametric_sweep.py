"""Parametric study with GPU sharing on the PyTorch port — the paper's
headline use case: sweep learning rates of a small LM, packed onto shared
accelerators with auto-NPPN, checkpointing, and straggler monitoring
(``examples/parametric_sweep.py`` on JAX).

    PYTHONPATH=src python examples/torch_parametric_sweep.py [--tasks 6] [--steps 20] [--device cpu]

Runs on the CUDA card by default, and stops when there is none unless
``--device cpu`` asks for the CPU.
"""
import argparse
import sys

import torch

from repro_torch import configs
from repro_torch.data import SyntheticLM
from repro_torch.launch.sweep import SweepTask, run_sweep
from repro_torch.models import ParallelCtx, build_model
from repro_torch.models.model import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tasks", type=int, default=6)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"torch_parametric_sweep: {e} (--device cpu)", file=sys.stderr)
        raise SystemExit(1)

    cfg = configs.get("stablelm-1.6b").reduced()
    model = build_model(cfg, ParallelCtx(moe_oracle=True), device=dev)

    def batch_fn(seed, step):
        ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=64,
                         batch_size=8, seed=seed)
        return ds.batch(step)

    lrs = [1e-3 * (2 ** i) for i in range(args.tasks)]
    tasks = [SweepTask(id=i, lr=lr, seed=i) for i, lr in enumerate(lrs)]
    res = run_sweep(model, tasks, batch_fn=batch_fn, steps=args.steps,
                    max_pack=args.tasks, checkpoint_dir=args.ckpt)
    print(f"\nsweep done in {res.wall_s:.1f}s at pack factor "
          f"{res.pack_factor} (backoffs: {res.backoffs})")
    for t in tasks:
        ls = res.losses[t.id]
        print(f"  lr={t.lr:<8.4g} first={ls[0]:.3f} last={ls[-1]:.3f}")
    best = min(tasks, key=lambda t: res.losses[t.id][-1])
    print(f"best lr: {best.lr:g}")


if __name__ == "__main__":
    main()
