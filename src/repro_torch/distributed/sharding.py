"""Sharding rules: parameter and batch sharding specs for any assigned arch
(port of ``repro.distributed.sharding``).

Strategy, as the reference's:
  * TP ("model" axis): attention q/o folded head dims, MLP d_ff, MoE expert
    dim (EP), vocab dim of embed/unembed.
  * FSDP (all non-"model" axes, e.g. ("pod", "data")): the OTHER large dim
    of each weight, ZeRO-3 style; DTensor all-gathers it where a layer
    uses it.
  * small vectors (norms, biases, scalars) replicate.

A spec is the reference's ``PartitionSpec`` as a plain tuple, one entry per
tensor dim: ``None`` (replicated), a mesh axis name, or a tuple of axis
names (the dim split over several axes, major to minor), so that
``spec == tuple(PartitionSpec(...))`` compares the two packages.
``placements`` turns a spec into DTensor placements on a ``DeviceMesh``.

Rules are name-based over the dotted param path (dict keys and list
indices, in the reference's pytree order) with shape-aware fallbacks, and
an axis assignment that does not divide its dim is dropped.

A mesh here is a ``torch.distributed.DeviceMesh`` with named dims, or any
object with ``axis_names`` and a ``shape`` mapping (the specs need only the
axis sizes).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

Spec = Tuple[Any, ...]


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (by its type's name: importing
    ``torch.distributed.tensor`` costs over a second, and a module that
    only asks should not pay it)."""
    return type(t).__name__ == "DTensor"


def axis_sizes(mesh) -> Dict[str, int]:
    """Mesh axis name -> size, in mesh order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def fsdp_axes_of(mesh) -> Tuple[str, ...]:
    return tuple(n for n in axis_sizes(mesh) if n != "model")


def _dotted(path) -> str:
    return ".".join(str(k) for k in path)


def flatten_with_path(tree: Any, path: tuple = ()) -> list:
    """[(path, leaf)] of a tree of dicts and lists, in the reference's
    pytree order (dict keys sorted, list items in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in flatten_with_path(v, path + (i,))]
    return [(path, tree)]


def map_with_path(fn, tree: Any, path: tuple = ()) -> Any:
    """``fn(dotted_path, leaf)`` over a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(_dotted(path), tree)


def _norm(axes):
    """An axis tuple of one name as the name, as ``PartitionSpec`` keeps
    it."""
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def _axsize(sizes: Dict[str, int], axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return sizes[axes]
    return int(np.prod([sizes[a] for a in axes]))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Maps param path -> spec. ``fsdp=False`` => params replicated over
    the data axes (pure TP), used by small packed-sweep models."""
    mesh: Any
    fsdp: bool = True
    allow_uneven: Tuple[str, ...] = ()   # vocab is padded; nothing uneven

    def _fsdp(self):
        return fsdp_axes_of(self.mesh) if self.fsdp else None

    def spec_for(self, path: str, shape: Tuple[int, ...]) -> Spec:
        sizes = axis_sizes(self.mesh)
        fs = self._fsdp()
        mdl = "model"
        n = len(shape)

        def guarded(*spec) -> Spec:
            """Drop axis assignments that do not divide (unless the path is
            one allowed to stay uneven)."""
            out = []
            for dim, axes in enumerate(spec):
                if axes is None:
                    out.append(None)
                elif (shape[dim] % _axsize(sizes, axes) == 0
                      or any(k in path for k in self.allow_uneven)):
                    out.append(_norm(axes))   # (or an intended uneven shard)
                else:
                    out.append(None)
            return tuple(out)

        # ---- embeddings / head: vocab over model ONLY (an FSDP d dim
        # collides with the batch's data sharding in the logits
        # contraction). As in the reference, "unembed" ends with "embed"
        # too, so the first rule takes it: its d dim goes over model, and
        # the (d, V) rule after it is never reached
        if path.endswith("embed"):                       # (V, d)
            return guarded(mdl, None)
        if path.endswith("unembed"):                     # (d, V)
            return guarded(None, mdl)

        # ---- stacked layers have a leading layer dim; strip it ----
        lead: Tuple = ()
        core = shape
        m = re.search(r"(blocks|encoder|tail|hybrid)", path)
        if m and n >= 3:
            # 1 leading dim, or 2 for the hybrid's superblocks
            n_lead = 2 if ("hybrid" in path and "blocks" in path
                           and n >= 4) else 1
            lead = (None,) * n_lead
            core = shape[n_lead:]

        def lp(*spec):
            return guarded(*(lead + spec))

        # ---- MoE experts: (E, d, f) / (E, f, d): EP over model ----
        if "w_gate" in path or "w_up" in path:
            if len(core) == 3:                           # moe experts
                return lp(mdl, None, fs)
            return lp(fs, mdl)                           # dense swiglu (d,f)
        if "w_down" in path:
            if len(core) == 3:
                return lp(mdl, fs, None)
            return lp(mdl, fs)                           # dense (f,d)
        if "router" in path:
            return lp(fs, None)

        # ---- attention ----
        if re.search(r"w_[qkv]$", path):                 # (d, H*hd)
            return lp(fs, mdl)
        if path.endswith("w_o"):                         # (H*hd, d)
            return lp(mdl, fs)

        # ---- mamba ----
        if path.endswith("w_in"):                        # (d, d_proj)
            return lp(fs, mdl)
        if path.endswith("w_out"):                       # (d_in, d)
            return lp(mdl, fs)
        if "conv_w" in path:                             # (width, ch)
            return lp(None, mdl)

        # ---- fallback: replicate small, shard biggest dim of big ----
        if len(core) >= 2 and min(core) >= 8:
            big = int(np.argmax(core))
            spec: list = [None] * len(core)
            spec[big] = mdl
            return lp(*spec)
        return (None,) * n

    def tree(self, params: Any) -> Any:
        """Spec tree matching ``params`` (tensors, or anything with a
        ``shape``)."""
        return map_with_path(lambda name, leaf: self.spec_for(
            name, tuple(leaf.shape)), params)

    def shardings(self, params: Any) -> Any:
        """Tree of DTensor placements matching ``params``."""
        return map_with_path(lambda _, s: placements(s, self.mesh),
                             self.tree(params))


def param_shardings(mesh, params: Any, fsdp: bool = True) -> Any:
    return ShardingRules(mesh, fsdp=fsdp).shardings(params)


def batch_specs(mesh, batch: Any, global_batch: int) -> Any:
    """Spec tree of a batch or a decode cache: the first dim equal to
    ``global_batch`` over the data axes; KV head dims of caches over
    "model" when divisible; the SSM decode state's heads likewise."""
    sizes = axis_sizes(mesh)
    dp = fsdp_axes_of(mesh)
    dp_size = _axsize(sizes, dp)
    mdl_size = sizes["model"]

    def spec(name, leaf) -> Spec:
        shape = tuple(leaf.shape)
        out: list = [None] * len(shape)
        for i, s in enumerate(shape):
            if s == global_batch and s % dp_size == 0:
                out[i] = _norm(dp)
                break
        # cache KV heads over model: (..., Smax, Hkv, hd)
        if re.search(r"\bk\b|\bv\b|cross_k|cross_v", name) and len(shape) >= 4:
            if shape[-2] % mdl_size == 0:
                out[-2] = "model"
        # ssm decode state (..., nh, hd, N)
        if "ssm" in name and len(shape) >= 3 and shape[-3] % mdl_size == 0:
            out[-3] = "model"
        return tuple(out)

    return map_with_path(spec, batch)


def batch_shardings(mesh, batch: Any, global_batch: int) -> Any:
    """Tree of DTensor placements for ``batch_specs``."""
    return map_with_path(lambda _, s: placements(s, mesh),
                         batch_specs(mesh, batch, global_batch))


def placements(spec: Spec, mesh) -> tuple:
    """A spec as DTensor placements on ``mesh``, one per mesh dim: a tensor
    dim over several mesh axes is ``Shard(d)`` on each of them, and they
    must come in mesh order (major to minor); every other mesh dim is
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    out: list = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} are not in mesh "
                             f"order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def shard_shape(shape, mesh, placements) -> list:
    """The shape of this rank's shard of a tensor of ``shape`` under
    ``placements`` (DTensor's split: ``torch.chunk``'s pieces)."""
    coord = mesh.get_coordinate()
    shape = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            size = shape[p.dim]
            piece = -(-size // mesh.shape[i])
            shape[p.dim] = max(0, min(piece, size - coord[i] * piece))
    return shape


def local_shard(full, mesh, placements):
    """This rank's shard of ``full`` (which every rank holds) as a DTensor
    with ``placements``, cut locally: no collective (``distribute_tensor``
    would broadcast a replicated one)."""
    from torch.distributed.tensor import DTensor
    coord = mesh.get_coordinate()
    local = full
    for i, p in enumerate(placements):
        if p.is_shard():          # DTensor's split: torch.chunk's pieces
            pieces = torch.chunk(local, mesh.shape[i], dim=p.dim)
            local = (pieces[coord[i]] if coord[i] < len(pieces)
                     else local.narrow(p.dim, 0, 0))
    return DTensor.from_local(local.contiguous(), mesh, tuple(placements),
                              run_check=False, shape=full.shape,
                              stride=full.stride())


def distribute_local(tree: Any, mesh, placements_tree: Any) -> Any:
    """``local_shard`` of each tensor of ``tree`` with its placements."""
    return _zip_map(lambda t, p: local_shard(t, mesh, p), tree,
                    placements_tree)


def meta_dtensor(shape, dtype, mesh, placements):
    """A DTensor of global ``shape`` whose local shard is a ``meta`` tensor
    of the shard's shape: it carries shapes only and allocates nothing."""
    full = torch.empty(shape, dtype=dtype, device="meta")
    return local_shard(full, mesh, placements)


def _zip_map(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_map(fn, v, other[i]) for i, v in enumerate(tree)]
    return fn(tree, other)


# ---------------------------------------------------------------------------
# placements of the activations that ``local_map`` regions take
# ---------------------------------------------------------------------------

def dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return _axsize(sizes, fsdp_axes_of(mesh))


def dim_placements(mesh, data=None, model=None, *, data_partial=False,
                   model_partial=False) -> list:
    """One placement per mesh dim (a list: ``local_map`` reads a tuple as
    one placement list per output): each data axis ``Shard(data)`` (a
    ``Partial()`` with ``data_partial``, else ``Replicate()`` when ``data``
    is None), "model" ``Shard(model)`` likewise."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    def one(dim, partial):
        if partial:
            return Partial()
        return Replicate() if dim is None else Shard(dim)

    return [one(model, model_partial) if a == "model"
            else one(data, data_partial) for a in axis_sizes(mesh)]


def batch_dim(mesh, size: int, dim: int = 0):
    """``dim`` when the data axes divide a batch of ``size``, else None (a
    batch they do not divide stays replicated, as the reference's head
    keeps it; so does a batch of one row, which DTensor could not fold
    into the sequence dim while it is marked sharded)."""
    return dim if size > 1 and size % dp_size(mesh) == 0 else None


def model_dim(mesh, size: int, dim: int):
    """``dim`` when "model" divides ``size``, else None."""
    return dim if size % axis_sizes(mesh)["model"] == 0 else None


class _Constrain(torch.autograd.Function):
    """Redistribute to ``placements`` in the forward and the gradient to
    ``grad_placements`` in the backward, as the reference's sharding
    constraint binds the cotangent too. A shard cut from a whole owns its
    storage (``_owned``)."""

    @staticmethod
    def forward(ctx, x, mesh, placements, grad_placements):
        ctx.mesh, ctx.grad_placements = mesh, grad_placements
        return _owned(x.redistribute(mesh, placements), x)

    @staticmethod
    def backward(ctx, g):
        return (_owned(g.redistribute(ctx.mesh, ctx.grad_placements), g),
                None, None, None)


def _owned(out, src):
    """``out``, redistributed from ``src`` (DTensors), with a local tensor
    that owns its storage where ``redistribute`` cut it as a view of a
    larger one (a shard of a gathered or replicated whole), which would
    keep the whole alive as long as the shard. A local tensor that is
    ``src``'s own (nothing was moved) stays as it is, a view or not."""
    local, before = out.to_local(), src.to_local()
    storage = local.untyped_storage()
    same = (storage._cdata == before.untyped_storage()._cdata
            and local.storage_offset() == before.storage_offset()
            and local.shape == before.shape
            and local.stride() == before.stride())
    if same or storage.nbytes() <= local.numel() * local.element_size():
        return out
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local.clone(), out.device_mesh, out.placements,
                              run_check=False, shape=out.shape,
                              stride=out.stride())


def constrain(x, mesh, placements, grad_placements=None):
    """``x`` (a DTensor) redistributed to ``placements``, and its gradient
    to ``grad_placements`` (by default ``placements`` too): a gradient
    that comes back as partial sums is summed here (where DTensor would
    otherwise carry it on into the next product and gather that product's
    weight to keep it partial), and one sharded where a view cannot split
    it is gathered."""
    placements = list(placements)
    return _Constrain.apply(x, mesh, placements, placements
                            if grad_placements is None
                            else list(grad_placements))


def fsdp_gather(w, keep_model: bool = True):
    """A parameter ``w`` (a DTensor) at its point of use: gathered over
    the data axes (its FSDP shards) for the product that takes it, and
    over "model" too unless ``keep_model`` (a norm's weight, which scales
    every feature of a replicated activation: a stack of at least 8
    layers shards its (L, d) leaf over "model" by the fallback rule). The
    gradient goes back to ``w``'s own placements right there (a
    reduce-scatter over the data axes), so a layer's weight gradients are
    reduced in its backward whatever strategy DTensor would pick for the
    product, as GSPMD does inside the reference's scan. Where nothing is
    to be gathered (every such axis of size 1, or ``w`` whole on it
    already), ``w`` itself."""
    from torch.distributed.tensor import Replicate
    mesh = w.device_mesh
    sizes = axis_sizes(mesh)
    need = [p if a == "model" and keep_model else Replicate()
            for a, p in zip(sizes, w.placements)]
    if all(n == p or sizes[a] == 1
           for a, n, p in zip(sizes, need, w.placements)):
        return w
    return constrain(w, mesh, need, w.placements)


def _flat(mesh, axes):
    """The 1-D mesh of ``axes`` flattened, major to minor (as a dim split
    over them is laid out)."""
    return mesh[tuple(axes)]._flatten()


def _reverse(src, dst):
    """The (src, dst) of a redistribution's gradient: a gather's is a
    reduce-scatter of partial sums, a reduce-scatter's a gather, a
    re-split's the re-split back."""
    from torch.distributed.tensor import Partial, Replicate
    if dst.is_replicate():
        return Partial(), src
    if src.is_partial():
        return dst, Replicate()
    return dst, src


def _moved(t, axes, src, dst):
    """``t`` with ``axes`` (all ``src``) redistributed to ``dst`` in one
    collective over their flattened group, its other placements kept."""
    from torch.distributed.tensor import DTensor
    mesh = t.device_mesh
    flat = _flat(mesh, axes)
    local = DTensor.from_local(t.to_local(), flat, [src], run_check=False
                               ).redistribute(flat, [dst]).to_local()
    out = [dst if a in axes else p
           for a, p in zip(mesh.mesh_dim_names, t.placements)]
    return DTensor.from_local(local, mesh, out, run_check=False,
                              shape=t.shape, stride=t.stride())


class _OverDataAxes(torch.autograd.Function):
    """``_moved`` forward, and its gradient moved back (``_reverse``) over
    the same group."""

    @staticmethod
    def forward(ctx, t, axes, src, dst):
        ctx.axes, ctx.back = axes, _reverse(src, dst)
        return _moved(t, axes, src, dst)

    @staticmethod
    def backward(ctx, g):
        src, dst = ctx.back
        names = g.device_mesh.mesh_dim_names
        if all(g.placements[names.index(a)] == src for a in ctx.axes):
            return _moved(g, ctx.axes, src, dst), None, None, None
        to = [dst if a in ctx.axes else p for a, p in zip(names, g.placements)]
        return _owned(g.redistribute(g.device_mesh, to), g), None, None, None


def over_data_axes(t, dst):
    """DTensor ``t`` placed ``dst`` on each data axis of more than one rank
    (its "model" placement kept), in ONE collective over the flattened
    group of the axes that move, where they all move from one placement:
    a gather (``dst`` Replicate), a reduce-scatter of partial sums, or a
    re-split (an all-to-all). DTensor moves a dim split over ("pod",
    "data") axis by axis, and gathers "data" first, so that the "pod"
    gather moves a tensor as many times larger as "data" has ranks. The
    gradient moves back over the same group (a gather's partial sums as
    one reduce-scatter). Where one axis moves, or axes from different
    placements, it is ``constrain`` (DTensor's own collectives); where
    none does, ``t``."""
    mesh = t.device_mesh
    sizes = axis_sizes(mesh)
    axes = [a for a, p in zip(sizes, t.placements)
            if a != "model" and sizes[a] > 1 and p != dst]
    if not axes:
        return t
    names = list(sizes)
    srcs = {t.placements[names.index(a)] for a in axes}
    if len(axes) > 1 and len(srcs) == 1:
        return _OverDataAxes.apply(t, tuple(axes), srcs.pop(), dst)
    from torch.distributed.tensor import Replicate
    to = [dst if a in axes else p for a, p in zip(names, t.placements)]
    back = [_reverse(p, dst)[1] if a in axes
            else Replicate() if p.is_partial() else p
            for a, p in zip(names, t.placements)]
    return constrain(t, mesh, to, back)


def rows_product(x, w):
    """``split_contraction(x, w)`` for an activation of one token a row (a
    decode step's (B, d) or (B, 1, d)), its rows split over the data axes,
    and a weight left split over them (serving: ``layers.at_use``): where
    two data axes or more split both, the rows meet the weight gathered
    in one collective and the result goes back to them in one
    (``over_data_axes``), where DTensor would move the rows, or the
    result, axis by axis. Otherwise ``split_contraction(x, w)``: on one
    axis DTensor's own move is one collective."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = axis_sizes(x.device_mesh)
    one_token = x.numel() == x.shape[0] * x.shape[-1]
    axes = [a for a, p, q in zip(sizes, x.placements, w.placements)
            if a != "model" and sizes[a] > 1 and p == Shard(0)
            and q.is_shard()]
    if not one_token or len(axes) < 2:
        return split_contraction(x, w)
    out = split_contraction(over_data_axes(x, Replicate()), w)
    return over_data_axes(out, Shard(0))


def split_contraction(x, w):
    """``x @ w`` (DTensors, ``w`` a matrix at its use) split over "model"
    along the contraction where the placements leave that to DTensor,
    which may compute a product or its weight's gradient whole on every
    "model" rank:

    * "model" splits w's contraction dim and not x: x is taken split
      likewise (the forward DTensor runs), so that the weight's gradient
      is computed on the split too;
    * "model" splits neither of w's dims (its output dim does not divide,
      as Mamba2-130m's in-projection's) and divides the contraction: x
      and w are both taken split and the partial products summed, as
      GSPMD splits the reference's.

    The gradients keep the split: x's is split along its last dim, w's
    gathered back to its placements. Any other placements: ``x @ w``."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = w.device_mesh
    sizes = axis_sizes(mesh)
    m = list(sizes).index("model")
    if sizes["model"] == 1 or x.placements[m] != Replicate():
        return x @ w

    def on_model(placements, p):
        out = list(placements)
        out[m] = p
        return out

    xs = on_model(x.placements, Shard(x.ndim - 1))
    if w.placements[m] == Shard(0):
        return constrain(x, mesh, xs) @ w
    if w.placements[m] == Replicate() and w.shape[0] % sizes["model"] == 0:
        out = constrain(x, mesh, xs) @ constrain(
            w, mesh, on_model(w.placements, Shard(0)), w.placements)
        return constrain(out, mesh, on_model(out.placements, Replicate()))
    return x @ w
