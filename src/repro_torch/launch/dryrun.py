"""Multi-pod dry-run (port of ``repro.launch.dryrun``): build every
(architecture x shape x mesh) cell's sharded step, run it once on ``meta``
tensors (shapes only, nothing allocated) inside a ``"fake"`` process group
of the mesh's size, and emit roofline rows to JSON artifacts.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --out artifacts/dryrun

The reference lowers and compiles each cell for 256 or 512 host devices and
reads XLA's memory and cost analyses. The port runs the step as rank 0 of
the mesh sees it: its params, optimizer state, batch and cache are meta
DTensors with the sharding rules' placements, DTensor propagates shardings
op by op (GSPMD's part), and ``roofline.counting.count_step`` counts what
rank 0 runs: its FLOPs and bytes, the collectives DTensor and the
``local_map`` regions issue (``CollectiveOp``s, priced by the reference's
rules), the bytes of the storages that hold what the step returns
(``out_gb_dev``: XLA's ``output_size_in_bytes``, a train step's new params
and moments, a prefill's logits and cache) and the peak of the bytes its
other storages hold (``temp_gb_dev``: XLA's ``temp_size_in_bytes``, which
the reference's dry-run reports under that name), and the peak of all of
them together (``peak_gb_dev``: what a card's allocator holds above the
arguments, so a cell fits a card where ``arg_gb_dev + peak_gb_dev`` does).
A ``"fake"`` group
completes every collective at once without moving data, so the count is
the step's program, not a run.

It counts the path the port runs on cards: ``attn_impl="kernel"``, so the
attention (B3) and the scan (B4) are leaves counted from their local
shapes, where the reference's CPU dry-run counted XLA's attention.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Optional

import torch

from repro_torch import configs, optim
from repro_torch.configs.base import SHAPES_BY_NAME, ShapeSpec, cell_is_runnable
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_production_mesh, mesh_name
from repro_torch.launch.serve import make_prefill, make_serve_step
from repro_torch.launch.train import make_train_step
from repro_torch.models.model import Model
from repro_torch.models.transformer import ParallelCtx

# zamba2's shared attention runs a 4096 sliding window at 500k (DESIGN.md)
LONG_WINDOW = {"zamba2-7b": 4096}


@dataclasses.dataclass(frozen=True)
class ArgSpec:
    """A step argument's stand-in: its global shape, dtype and DTensor
    placements (None: a plain tensor, the same on every rank)."""
    shape: tuple
    dtype: torch.dtype
    placements: Optional[tuple]


def build_model(arch: str, shape: ShapeSpec, mesh,
                overrides: Optional[dict] = None,
                opt: Optional[dict] = None, device="meta") -> Model:
    """opt: perf-iteration flags, as the reference's: pad_heads (TP head
    padding), score_bf16 (bf16 softmax probabilities in the chunked
    attention), ep_bf16 (bf16 EP combine). A moe arch runs its experts
    under expert parallelism; the sequence mixers take the kernels."""
    opt = opt or {}
    cfg = configs.get(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if opt.get("pad_heads"):
        cfg = cfg.tp_pad_heads(sharding.axis_sizes(mesh)["model"])
    window = LONG_WINDOW.get(arch) if shape.name == "long_500k" else None
    pctx = ParallelCtx(mesh=mesh, ep=(cfg.family == "moe"),
                       attn_impl="kernel",
                       score_bf16=bool(opt.get("score_bf16")),
                       ep_bf16=bool(opt.get("ep_bf16")))
    return Model(cfg, pctx=pctx, window=window, device=device)


def _specs(tree, placements_tree) -> Any:
    return sharding._zip_map(
        lambda t, p: ArgSpec(tuple(t.shape), t.dtype, tuple(p)), tree,
        placements_tree)


def param_specs(model: Model, rules: sharding.ShardingRules) -> Any:
    """``ArgSpec``s of the model's params, from its init drawn under
    ``FakeTensorMode`` (nothing allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        p = Model(model.cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
    return _specs(p, rules.shardings(p))


def lower_cell(arch: str, shape_name, mesh, *, fsdp: bool = True,
               overrides: Optional[dict] = None, opt: Optional[dict] = None,
               device="meta"):
    """The cell's sharded step on ``mesh``: (step, arg specs, n_tokens,
    kind, model). ``shape_name`` names one of ``configs.base.SHAPES`` (or
    is a ``ShapeSpec``). The specs are ``ArgSpec`` trees of the step's
    arguments, (params, opt_state, batch, lr) for train, (params, batch)
    for prefill, (params, batch, cache) for decode; ``materialize`` makes
    meta DTensors of them, or a caller distributes real values with their
    placements. The model makes its tensors (a prefill's cache) on
    ``device``."""
    shape = (SHAPES_BY_NAME[shape_name] if isinstance(shape_name, str)
             else shape_name)
    model = build_model(arch, shape, mesh, overrides, opt, device=device)
    rules = sharding.ShardingRules(mesh, fsdp=fsdp)
    p_spec = param_specs(model, rules)
    batch = model.input_specs(shape)
    cache = batch.pop("_cache", None)
    b_spec = _specs(batch, sharding.batch_shardings(
        mesh, batch, shape.global_batch))
    if shape.kind == "train":
        o_spec = {"mu": p_spec, "nu": p_spec,
                  "count": ArgSpec((), torch.int32, None)}
        step = make_train_step(model, optim.adamw())
        return (step, (p_spec, o_spec, b_spec,
                       ArgSpec((), torch.float32, None)),
                shape.tokens, "train", model)
    if shape.kind == "prefill":
        return (make_prefill(model, max_len=shape.seq_len),
                (p_spec, b_spec), shape.tokens, "inference", model)
    c_spec = _specs(cache, sharding.batch_shardings(
        mesh, cache, shape.global_batch))
    # one new token per sequence
    return (make_serve_step(model), (p_spec, b_spec, c_spec),
            shape.global_batch, "inference", model)


def materialize(specs: Any, mesh) -> Any:
    """Meta tensors for a tree of ``ArgSpec``s: DTensors on ``mesh`` where
    placements are given (a plain scalar otherwise)."""
    def one(s):
        if s.placements is None:
            return torch.zeros(s.shape, dtype=s.dtype, device="meta")
        return sharding.meta_dtensor(s.shape, s.dtype, mesh, s.placements)
    return _map_specs(one, specs)


def _map_specs(fn, tree):
    if isinstance(tree, ArgSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs(fn, v) for v in tree)
    return tree


def spec_local_bytes(specs: Any, mesh) -> int:
    """Rank 0's bytes of the arguments, summed from the specs alone: each
    global shape divided along its sharded dims by the mesh dims sharding
    them (0-dim scalars count none, as ``count_step``'s do not)."""
    total = [0]

    def one(s):
        shape = list(s.shape)
        for size, p in zip(mesh.shape, s.placements or ()):
            if p.is_shard():
                shape[p.dim] //= size
        if shape:
            n = 1
            for d in shape:
                n *= d
            total[0] += n * torch.empty((), dtype=s.dtype).element_size()
        return s
    _map_specs(one, specs)
    return total[0]


@contextlib.contextmanager
def fake_world(size: int):
    """A ``"fake"`` default process group of ``size`` ranks (this process
    is rank 0), destroyed on exit. Its collectives complete at once and
    move nothing. DTensor's sharding propagation caches are cleared on
    exit: they key an op by its meshes' layouts, so that a later world's
    op on a mesh of the same layout was handed this world's mesh, and
    with it this world's groups (a flattened one among them,
    ``sharding.over_data_axes``), which no longer exist."""
    import torch.distributed as dist
    from torch.distributed.tensor import debug
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()
        clear = getattr(debug, "_clear_sharding_prop_cache", None)
        if clear is not None:
            clear()


def count_cell(arch: str, shape_name, mesh, *, fsdp: bool = True,
               overrides: Optional[dict] = None, opt: Optional[dict] = None):
    """Build the cell on ``mesh`` and count its step on meta tensors:
    (StepCounts, n_tokens, kind, model, arg specs). The specs of the
    arguments the step never reads (``StepCounts.unread_args``: a vlm's
    prefill, fed embeddings, and its embedding table) are None, as the
    reference's ``jax.jit`` leaves such an argument out."""
    from repro_torch.roofline import counting
    step, specs, n_tokens, kind, model = lower_cell(
        arch, shape_name, mesh, fsdp=fsdp, overrides=overrides, opt=opt)
    args = materialize(specs, mesh)
    with torch.no_grad() if kind == "inference" else contextlib.nullcontext():
        c = counting.count_step(step, *args)
    position = iter(range(len(counting._tensors(args))))
    specs = _map_specs(lambda s: None if next(position) in c.unread_args
                       else s, specs)
    return c, n_tokens, kind, model, specs


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             fsdp: bool = True, overrides: Optional[dict] = None,
             opt: Optional[dict] = None, tag: str = "") -> Optional[dict]:
    """Count one cell in a fake world of the production mesh's size and
    write its row to ``out_dir``. Returns the row, an error row, or None
    for a documented skip."""
    from repro_torch.roofline.analysis import (HW, RooflineReport,
                                               attn_kernel_io_bytes,
                                               collective_totals, model_flops)
    size = 512 if multi_pod else 256
    label = (f"{arch} × {shape_name} × "
             f"{'2x16x16' if multi_pod else '16x16'}"
             + (f" [{tag}]" if tag else ""))
    if not cell_is_runnable(arch, shape_name):
        print(f"[dryrun] SKIP {label} (documented: this cell needs "
              f"sub-quadratic attention or a decoder arch)")
        return None
    t0 = time.perf_counter()
    mname = "?"
    try:
        with fake_world(size):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            mname = mesh_name(mesh)
            c, n_tokens, kind, model, specs = count_cell(
                arch, shape_name, mesh, fsdp=fsdp, overrides=overrides,
                opt=opt)
            arg_check = spec_local_bytes(specs, mesh)
            sizes = sharding.axis_sizes(mesh)
            by_axis = coll_by_axis(c, mesh)
        base_cfg = configs.get(arch)
        if overrides:
            base_cfg = dataclasses.replace(base_cfg, **overrides)
        operand, traffic, by_kind = collective_totals(c.collectives)
        tp = sizes["model"]
        dp = size // tp
        shape = SHAPES_BY_NAME[shape_name]
        kio = attn_kernel_io_bytes(model.cfg, shape.tokens if kind == "train"
                                   or shape.kind == "prefill" else n_tokens,
                                   tp, dp, kind)
        rep = RooflineReport(
            arch=arch, shape=shape_name, mesh=mname, chips=size,
            flops_per_dev=float(c.flops), bytes_per_dev=float(c.bytes),
            coll_operand_bytes=operand, coll_traffic_bytes=traffic,
            coll_by_kind=by_kind, peak_mem_bytes=0, arg_bytes=c.arg_bytes,
            model_flops_global=model_flops(
                base_cfg.active_param_count(), n_tokens, kind),
            hw=HW.for_arch("h100"), bytes_by_tag=dict(c.bytes_by_tag),
            kernel_io_bytes=kio)
        row = rep.row()
        top = sorted(zip(c.collective_causes, c.collectives),
                     key=lambda x: -x[1].operand_bytes)[:3]
        row.update({
            "bytes_by_tag_gb": {k: v / 1e9
                                for k, v in rep.bytes_by_tag.items()},
            "kernel_io_gb_dev": rep.kernel_io_bytes / 1e9,
            "t_memory_kernel_s": rep.t_memory_kernel,
            "roofline_fraction_kernel": rep.roofline_fraction_kernel,
            "count_s": time.perf_counter() - t0,
            "arg_gb_dev": c.arg_bytes / 1e9,
            "arg_gb_dev_from_specs": arg_check / 1e9,
            "temp_gb_dev": c.temp_peak_bytes / 1e9,
            "out_gb_dev": c.output_bytes / 1e9,
            "peak_gb_dev": c.live_peak_bytes / 1e9,
            "coll_by_kind_gb": {k: v / 1e9 for k, v in by_kind.items()},
            "coll_traffic_gb_dev": traffic / 1e9,
            "coll_by_axis_gb": by_axis,
            "coll_largest": [{"cause": cause, "kind": op.kind,
                              "gb": op.operand_bytes / 1e9,
                              "group": op.group_size} for cause, op in top],
            "leaf_calls": dict(c.leaf_calls),
            "attn_impl": "kernel",
            "hw": "h100 data sheet (roofline.analysis.HW)",
            "tag": tag or "baseline",
        })
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        fname = f"{arch}__{shape_name}__{mname}{suffix}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(row, f, indent=1)
        print(f"[dryrun] OK   {label}: "
              f"mem/dev arg={row['arg_gb_dev']:.2f}+tmp="
              f"{row['temp_gb_dev']:.2f}GB out={row['out_gb_dev']:.2f}GB "
              f"peak={row['peak_gb_dev']:.2f}GB "
              f"flops/dev={row['gflops_dev']:.1f}G "
              f"coll/dev={row['coll_gb_dev']:.3f}GB "
              f"bottleneck={row['bottleneck']} "
              f"roofline={row['roofline_fraction']:.3f} "
              f"({row['count_s']:.0f}s)")
        if top:
            print("[dryrun]      largest collectives: " + "; ".join(
                f"{d['kind']} {d['gb']:.3f}GB over {d['group']} "
                f"from {d['cause'] or 'an explicit call'}"
                for d in row["coll_largest"]))
        return row
    except Exception as e:  # noqa: BLE001 — a failed cell is a bug; report it
        print(f"[dryrun] FAIL {label}: {type(e).__name__}: {e}")
        traceback.print_exc()
        return {"arch": arch, "shape": shape_name, "mesh": mname,
                "error": f"{type(e).__name__}: {e}", "tag": tag or "baseline"}


def coll_by_axis(counts, mesh) -> dict:
    """Operand GB of the recorded collectives by the mesh axis (or axes,
    joined by "+") whose group of this rank they ran over."""
    import torch.distributed as dist
    names = list(sharding.axis_sizes(mesh))
    axis_of = {tuple(sorted(dist.get_process_group_ranks(
        mesh.get_group(a)))): a for a in names}
    out: dict = {}
    for op, ranks in zip(counts.collectives, counts.collective_groups):
        key = axis_of.get(tuple(sorted(ranks)), "+".join(
            a for a in names if set(dist.get_process_group_ranks(
                mesh.get_group(a))) <= set(ranks)) or "other")
        out[key] = out.get(key, 0.0) + op.operand_bytes / 1e9
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--no-fsdp", action="store_true")
    args = ap.parse_args(argv)

    archs = list(configs.available()) if args.arch == "all" else [args.arch]
    shapes = (list(SHAPES_BY_NAME) if args.shape == "all"
              else [args.shape])
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    n_ok = n_fail = n_skip = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                row = run_cell(arch, shape, mp, args.out,
                               fsdp=not args.no_fsdp)
                if row is None:
                    n_skip += 1
                elif "error" in row:
                    n_fail += 1
                else:
                    n_ok += 1
    print(f"[dryrun] done: {n_ok} ok, {n_fail} failed, {n_skip} skipped")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
