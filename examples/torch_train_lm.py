"""End-to-end LM training on the PyTorch port: data pipeline -> model ->
AdamW -> checkpoints -> monitoring (``examples/train_lm.py`` on JAX).
Defaults train a ~5M-param model for 200 steps; --preset 100m is the
real-hardware configuration.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200 [--device cpu]

Runs on the CUDA card by default, and stops when there is none unless
``--device cpu`` asks for the CPU.
"""
import argparse
import dataclasses
import sys

import torch

from repro_torch import configs, optim
from repro_torch.data import SyntheticLM
from repro_torch.launch.train import Trainer
from repro_torch.models import ParallelCtx, build_model
from repro_torch.models.model import resolve_device
from repro_torch.optim import schedule


PRESETS = {
    # ~5M params: runnable on a CPU in minutes
    "5m": dict(num_layers=4, d_model=128, num_heads=4, num_kv_heads=4,
               head_dim=32, d_ff=512, vocab_size=8192, remat=False,
               param_dtype="float32", compute_dtype="float32"),
    # ~100M params: the few-hundred-step run for a real accelerator
    "100m": dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
                 head_dim=64, d_ff=3072, vocab_size=32768, remat=False),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="5m", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default="artifacts/train_lm_ckpt")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"torch_train_lm: {e} (--device cpu)", file=sys.stderr)
        raise SystemExit(1)

    cfg = dataclasses.replace(configs.get("stablelm-1.6b"),
                              **PRESETS[args.preset])
    model = build_model(cfg, ParallelCtx(), device=dev)
    print(f"model: {cfg.param_count()/1e6:.1f}M params")

    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                     batch_size=args.batch, seed=0)
    trainer = Trainer(model, optim.adamw(),
                      schedule.linear_warmup_cosine(args.lr, 20, args.steps),
                      checkpoint_dir=args.ckpt, checkpoint_every=50,
                      log_every=10)
    out = trainer.fit(torch.Generator(device=dev).manual_seed(0), iter(ds),
                      steps=args.steps)
    print(f"loss: {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f} "
          f"({out['monitor']['mean_s']*1e3:.0f} ms/step)")


if __name__ == "__main__":
    main()
