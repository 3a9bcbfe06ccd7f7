"""Quickstart on the PyTorch port: share one accelerator between 8 small
training jobs with triples mode — the paper's core workflow in ~40 lines of
user code (``examples/quickstart.py`` on JAX).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on the CUDA card by default, and stops when there is none unless
``--device cpu`` asks for the CPU.
"""
import argparse
import functools
import sys

import torch

from repro_torch import optim
from repro_torch.core import NodeSpec, Triples, packing, plan
from repro_torch.core.monitor import profile_fn
from repro_torch.data.mnist import synthetic_mnist
from repro_torch.models import lenet
from repro_torch.models.model import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"torch_quickstart: {e} (--device cpu)", file=sys.stderr)
        raise SystemExit(1)

    # 1. The paper's triplet: 1 node, 8 processes, sharing its accelerators.
    node = NodeSpec(chips_per_node=1, hbm_per_chip=16e9)
    trip = Triples(nnode=1, nppn=8, ntpp=1)
    p = plan(n_tasks=8, triples=trip, node_spec=node)
    print(f"pack factor: {p.pack_factor} tasks/chip "
          f"(sharing={trip.is_sharing(node)})")

    # 2. Define the per-task step (LeNet-4/MNIST, as in the paper §III-A).
    opt = optim.sgd()

    def step(params, opt_state, batch, lr):
        grads, loss = torch.func.grad_and_value(lenet.loss)(params, batch)
        upd, opt_state = opt.update(grads, opt_state, params, lr)
        return optim.apply_updates(params, upd), opt_state, loss

    init = functools.partial(lenet.init, device=dev)
    gen = lambda: torch.Generator(device=dev).manual_seed(0)

    # 3. LLload-style pre-flight: does 8-way packing fit the HBM budget?
    params = init(gen())
    prof = profile_fn(step, params, opt.init(params),
                      {"image": torch.zeros((64, 28, 28, 1), device=dev),
                       "label": torch.zeros((64,), dtype=torch.int32,
                                            device=dev)},
                      torch.tensor(0.05, device=dev))
    print(f"per-task memory: {prof.resident_bytes/1e6:.1f} MB "
          f"-> 8 packed ≈ {8*prof.resident_bytes/1e6:.0f} MB "
          f"(fits 16GB: {8*prof.resident_bytes < 16e9})")

    # 4. Pack the 8 jobs as vmapped lanes of ONE program and train.
    jobs = packing.PackedJobs.create(
        init, opt.init, step, gen(), n_lanes=8,
        hparams=torch.tensor([0.01 * (i + 1) for i in range(8)],
                             dtype=torch.float32, device=dev))
    for s in range(10):
        batch = packing.stack_trees([
            {k: torch.as_tensor(v, device=dev) for k, v in
             synthetic_mnist(64, s, seed=i).items()} for i in range(8)])
        metrics = jobs.run_step(batch)
    print("final per-task losses:",
          [f"{float(l):.3f}" for l in metrics])


if __name__ == "__main__":
    main()
