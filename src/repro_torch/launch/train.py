"""Training (port of ``repro.launch.train``): ``make_train_step``, which
the sweep and the tests use, and a single-task training loop with checkpoints
and monitoring.

The step is a pure function of tensors, differentiated with
``torch.func.grad_and_value``, so a lane pool can step many tasks as lanes
of one call under ``torch.func.vmap``, as the reference's step runs under
``jax.vmap``. Nothing is compiled: the reference's ``jax.jit`` (and its
buffer donation) has no counterpart here.

Under a mesh (DTensor params, ``distributed.sharding``'s placements) the
step differentiates with ``torch.autograd`` instead: ``local_map`` regions
see DTensors only as they are, not through ``torch.func``'s wrappers. A
gradient comes back with the placements its ops left (partial sums over
the data axes, where the ranks' batch shards each add theirs); the step
redistributes each to its parameter's placements before the optimizer,
the data-parallel reduce-scatter or all-reduce that GSPMD puts in, and
the update stays elementwise on the shards.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import optim
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import packing, spans
from repro_torch.core.monitor import RunMonitor
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models.model import Model


def make_train_step(model: Model, opt: optim.Optimizer) -> Callable:
    """(params, opt_state, batch, lr) -> (params, opt_state, metrics),
    differentiated by ``mesh_grads`` for DTensor params and by
    ``torch.func`` otherwise. Traced (``core.spans``): ``train.grad`` (the
    forward and backward) and ``train.update`` (the global norm, the
    optimizer, the update); under a pool's vmap, once a pool step."""

    def train_step(params, opt_state, batch, lr):
        with spans.span("train.grad"):
            if _on_mesh(params):
                grads, metrics = mesh_grads(model.loss, params, batch)
            else:
                grads, (_, metrics) = torch.func.grad_and_value(
                    model.loss, has_aux=True)(params, batch)
        with spans.span("train.update"):
            metrics = dict(metrics, grad_norm=optim.global_norm(grads))
            updates, opt_state = opt.update(grads, opt_state, params, lr)
            params = optim.apply_updates(params, updates)
        return params, opt_state, metrics

    return train_step


def _on_mesh(params) -> bool:
    return is_dtensor(packing.tree_leaves(params)[0])


def mesh_grads(loss_fn: Callable, params, batch):
    """(grads, metrics) of ``loss_fn(params, batch) -> (loss, metrics)``
    by ``torch.autograd``; a DTensor parameter's gradient redistributed to
    its placements."""
    leaves = [p.detach().requires_grad_(True)
              for p in packing.tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(packing.tree_unflatten(params, leaves),
                                batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a parameter the loss does not use (a vlm's embedding table, fed
    # embeddings) gets zeros, as torch.func gives it
    grads = [torch.zeros_like(p) if g is None else
             g.redistribute(p.device_mesh, p.placements) if is_dtensor(p)
             else g for g, p in zip(grads, leaves)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return packing.tree_unflatten(params, grads), metrics


def make_eval_step(model: Model) -> Callable:
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = model.loss(params, batch)
        return metrics
    return eval_step


def _to_device(batch: Any, device) -> Any:
    return packing.tree_map(lambda x: torch.as_tensor(x, device=device),
                            batch)


@dataclasses.dataclass
class Trainer:
    """Single-task training loop (lanes of a packed sweep reuse the same
    step through ``core.packing`` instead)."""
    model: Model
    opt: optim.Optimizer
    lr_schedule: Callable
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 100
    log_every: int = 10

    def fit(self, generator: torch.Generator, batch_iter, steps: int,
            params: Any = None, opt_state: Any = None,
            start_step: int = 0) -> Dict[str, Any]:
        """Train from ``model.init(generator)`` (or the given state) up to
        ``steps``, resuming from the newest checkpoint in
        ``checkpoint_dir`` when there is one."""
        model, opt = self.model, self.opt
        if params is None:
            params = model.init(generator)
        if opt_state is None:
            opt_state = opt.init(params)
        ckpt = (Checkpointer(self.checkpoint_dir)
                if self.checkpoint_dir else None)
        if ckpt is not None:
            try:
                state, start_step, _ = ckpt.restore(
                    {"params": params, "opt_state": opt_state})
                params, opt_state = state["params"], state["opt_state"]
                print(f"[trainer] resumed from step {start_step}")
            except FileNotFoundError:
                pass

        step_fn = make_train_step(model, opt)
        mon = RunMonitor()
        losses = []
        it = iter(batch_iter)
        for step in range(start_step, steps):
            batch = _to_device(next(it), model.device)
            lr = self.lr_schedule(step).to(model.device)
            mon.start_step()
            params, opt_state, metrics = step_fn(params, opt_state, batch, lr)
            loss = float(metrics["loss"])
            mon.end_step(step)
            losses.append(loss)
            if self.log_every and step % self.log_every == 0:
                print(f"[trainer] step {step} loss {loss:.4f} "
                      f"({mon.history[-1].wall_s*1e3:.0f} ms)")
            if ckpt is not None and (step + 1) % self.checkpoint_every == 0:
                ckpt.save({"params": params, "opt_state": opt_state},
                          step + 1, blocking=False)
        if ckpt is not None:
            ckpt.save({"params": params, "opt_state": opt_state}, steps)
            ckpt.wait()
        return {"params": params, "opt_state": opt_state,
                "losses": losses, "monitor": mon.summary()}
