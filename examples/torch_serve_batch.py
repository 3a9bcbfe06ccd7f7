"""Batched serving on the PyTorch port: prefill + greedy decode over a lane
pool — the inference-side counterpart of job packing (multiple requests
share the accelerator as decode lanes; ``examples/serve_batch.py`` on JAX).

    PYTHONPATH=src python examples/torch_serve_batch.py [--device cpu]

Runs on the CUDA card by default (prefill attention through the Hopper
kernel), and stops when there is none unless ``--device cpu`` asks for
the CPU.
"""
import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.launch.serve import BatchServer, Request
from repro_torch.models import ParallelCtx, build_model
from repro_torch.models.model import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"torch_serve_batch: {e} (--device cpu)", file=sys.stderr)
        raise SystemExit(1)

    cfg = configs.get("stablelm-1.6b").reduced()
    model = build_model(cfg, ParallelCtx(moe_oracle=True), device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))

    rng = np.random.default_rng(0)
    reqs = [Request(id=i,
                    prompt=rng.integers(1, cfg.vocab_size, size=5 + i % 4).astype(np.int32),
                    max_new=8)
            for i in range(6)]

    srv = BatchServer(model, params, batch_lanes=3, max_len=32)
    t0 = time.perf_counter()
    out = srv.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(v) for v in out.values())
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "CPU")
    print(f"served {len(reqs)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens/dt:.1f} tok/s on {where})")
    for rid in sorted(out):
        print(f"  req{rid}: {out[rid]}")


if __name__ == "__main__":
    main()
