"""A step's FLOPs and HBM bytes, counted by running it once: the port's
counterpart of ``repro.roofline.hlo_costs``, which reads them from a
compiled XLA program's HLO text.

  * FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``: the
    products (mm, bmm, convolutions, ...) of every aten op the step runs,
    forward and backward, under ``torch.func`` transforms too (the modes
    sit below them and see the batched, physical ops).
  * Bytes come from a ``TorchDispatchMode`` that adds up each aten op's
    operand and result sizes, as an eager step moves them through HBM;
    views, allocations that write nothing and 0-dim scalars move none.
  * Each kernel entry of ``kernels.ops`` (``flash_attention``, ``ssd``,
    ``packed_matmul``, ``packed_norm``) is one leaf: its FLOPs and bytes
    come from its operand shapes by the formulas below (each input read
    once, each output written once, the work of the unmasked pairs), and
    the modes do not descend into it. So a step counts the same work
    whether the kernel or its plain version runs, on ``cuda``, on the CPU
    or on ``meta`` tensors, which carry shapes only and allocate nothing
    (during a count the kernels' wrappers hand meta tensors to the plain
    versions, whose outputs come back in the kernels' contiguous layout).
    The reference gets the same effect by putting the kernels' analytic
    I/O in place of the ``sdpa``/``ssd`` scopes.

A leaf's shapes are read through the ``torch.func`` wrappers of its
operands, so a call under ``vmap`` counts every lane. Work done by a
leaf's backward (flash attention recomputes through ``sdpa_chunked``)
is counted op by op, as it runs the same ops on every device.

A step on a mesh (DTensor arguments) is counted per device: the topmost
mode hands every DTensor op back to DTensor (``NotImplemented``), so the
modes see the ops each rank runs on its local shards, the collectives
DTensor issues for them among those, and the kernel leaves count their
``local_map`` calls' local shapes. ``CollectiveCounter`` records every
c10d and functional collective as a ``CollectiveOp`` (kind, result bytes,
group size) with the DTensor op that caused it, and ``LiveBytes`` the peak
of the bytes held by the tensors the step makes, on any device (``meta``
included), beyond those of its arguments, and which of them hold the
step's outputs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import weakref
from typing import Dict, List

import numpy as np
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils.flop_counter import FlopCounterMode

# ---------------------------------------------------------------------------
# the kernels' work from their shapes
# ---------------------------------------------------------------------------


def attention_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the causal and window masks leave, positions
    counted from 0 in both (the kernels' contract)."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention_work(B, Sq, Sk, Hq, Hkv, D, causal, window, itemsize) -> tuple:
    """(FLOPs, bytes) of flash attention: QKᵀ and PV over the unmasked
    pairs; q, k, v read once and o written once."""
    flops = 4 * B * Hq * D * attention_pairs(Sq, Sk, causal, window)
    nbytes = (2 * B * Sq * Hq + 2 * B * Sk * Hkv) * D * itemsize
    return flops, nbytes


def ssd_work(b, S, nh, hd, N, Q, itemsize, init_state: bool = False
             ) -> tuple:
    """(f32 operations, bytes) of the SSD scan on these shapes: C·Bᵀ and
    the intra-chunk product over the causal half of each chunk (j <= i),
    the inter-chunk and state products in full; x, B, C read and y written
    in their dtype, dt read and the state written in f32 (and a given
    start state read)."""
    nc, tri = S // Q, Q * (Q + 1) // 2
    flops = b * nc * (2 * N * tri + 2 * nh * hd * tri + 4 * Q * N * nh * hd)
    state = b * nh * hd * N
    nbytes = ((2 * b * S * nh * hd + 2 * b * S * N) * itemsize
              + 4 * (b * S * nh + nh + state * (2 if init_state else 1)))
    return flops, nbytes


def matmul_work(J, M, K, N, itemsize) -> tuple:
    """(FLOPs, bytes) of J products (M, K) @ (K, N)."""
    return 2 * J * M * K * N, (J * M * K + J * K * N + J * M * N) * itemsize


def norm_work(n_rows, d, n_weights, itemsize) -> tuple:
    """(operations, bytes) of RMSNorm over n_rows rows of d: about 4 f32
    operations an element; x and the weights read, the output written."""
    return 4 * n_rows * d, (2 * n_rows * d + n_weights * d) * itemsize


def _physical(t: torch.Tensor) -> torch.Tensor:
    """``t`` under its ``torch.func`` wrappers: its shape then carries every
    vmapped axis."""
    from torch._C._functorch import get_unwrapped, is_functorch_wrapped_tensor
    while is_functorch_wrapped_tensor(t):
        t = get_unwrapped(t)
    return t


def _lead(t: torch.Tensor, inner: int) -> int:
    """The product of ``t``'s physical leading axes before its last
    ``inner`` logical ones: the batch a leaf's kernel would run."""
    tail = int(np.prod(t.shape[-inner:]))
    return _physical(t).numel() // max(tail, 1)


def _flash_attention_work(q, k, v, causal=True, window=0, *, active=None):
    Sq, Hq, D = q.shape[-3:]
    Sk, Hkv = k.shape[-3], k.shape[-2]
    return attention_work(_lead(q, 3), Sq, Sk, Hq, Hkv, D, causal, window,
                          q.element_size())


def _ssd_work(x, dt, A, B, C, *, chunk=128, active=None, init_state=None):
    S, nh, hd = x.shape[-3:]
    return ssd_work(_lead(x, 3), S, nh, hd, B.shape[-1], min(chunk, S),
                    x.element_size(), init_state is not None)


def _packed_matmul_work(x, w, *, active=None):
    M, K = x.shape[-2:]
    return matmul_work(_lead(x, 2), M, K, w.shape[-1], x.element_size())


def _packed_norm_work(x, w, *, active=None, eps=1e-5):
    d = x.shape[-1]
    return norm_work(_lead(x, 1), d, _lead(w, 1), x.element_size())


# entry of kernels.ops -> (tag, work from its arguments, and in its kernel
# module: the plain version, which the "plain" sequence-mixer path calls
# directly, and the wrapper that picks the kernel or the plain version by
# device); the tags of the attention and the scan are the reference's
# scope names
LEAVES = {"flash_attention": ("sdpa", _flash_attention_work,
                              ("flash_attention", "flash_attention_plain",
                               "flash_attention_fwd")),
          "ssd": ("ssd", _ssd_work, ("ssd_scan", "ssd_scan_plain",
                                     "ssd_scan")),
          "packed_matmul": ("packed_matmul", _packed_matmul_work,
                            ("packed_gemm", "packed_gemm_plain",
                             "packed_gemm")),
          "packed_norm": ("packed_norm", _packed_norm_work,
                          ("fused_rmsnorm", "packed_rmsnorm_plain",
                           "packed_rmsnorm"))}

# ---------------------------------------------------------------------------
# the counting modes
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
# ops that allocate without writing, or only read metadata
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default,
               _aten.empty_like.default, _aten.new_empty.default,
               _aten.new_empty_strided.default, _aten.lift_fresh.default,
               _aten.is_same_size.default, _aten.sym_size.int,
               _aten.sym_stride.int, _aten.sym_numel.default,
               _aten.sym_storage_offset.default,
               _aten.is_contiguous.default, _aten.is_contiguous.memory_format,
               _aten.is_non_overlapping_and_dense.default,
               _aten.is_strides_like_format.default}


def _tensor_bytes(tree) -> int:
    """Bytes of the tensors in ``tree``; a 0-dim tensor (a scalar, which a
    kernel takes by value, and which a CPU, a card and ``meta`` may hold on
    different devices) counts none."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size() if tree.dim() else 0
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    return 0


def _dtensor_op(types) -> bool:
    return any(t.__name__ == "DTensor" for t in types)


class _ByteMode(TorchDispatchMode):
    """Adds up every aten op's operand and result bytes (views and
    allocations excepted), and keeps the storages those ops read
    (``read``)."""

    def __init__(self):
        super().__init__()
        self.by_op: Dict[str, int] = {}
        self.read: set = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _dtensor_op(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view and func not in _NO_TRAFFIC:
            name = str(func.overloadpacket)
            self.by_op[name] = (self.by_op.get(name, 0) + _tensor_bytes(args)
                                + _tensor_bytes(kwargs) + _tensor_bytes(out))
            self.read.update(t.untyped_storage()._cdata
                             for t in _tensors((args, kwargs)))
        return out


# the collectives a step can issue: c10d's ops (``torch.distributed``'s
# calls) and the functional ones (DTensor's redistributions, ``funcol``),
# by op name -> (the reference's HLO kind, where the result is: "out" or
# the index of the argument the op writes)
_COLLECTIVES = {
    "all_reduce": ("all-reduce", "out"), "all_reduce_": ("all-reduce", 0),
    "allreduce_": ("all-reduce", 0),
    "all_gather_into_tensor": ("all-gather", "out"),
    "all_gather_into_tensor_out": ("all-gather", "out"),
    "allgather_": ("all-gather", 0), "_allgather_base_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "reduce_scatter_tensor": ("reduce-scatter", "out"),
    "reduce_scatter_": ("reduce-scatter", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
    "all_to_all_single": ("all-to-all", "out"),
    "alltoall_base_": ("all-to-all", 0), "alltoall_": ("all-to-all", 0),
    "shard_dim_alltoall": ("all-to-all", "out"),
    "broadcast": ("broadcast", "out"), "broadcast_": ("broadcast", 0),
    "send": ("collective-permute", 0),
}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional",
                          "_dtensor")


def _group(args):
    """The process group among a collective's arguments (c10d's boxed
    ProcessGroup, or a functional collective's group name), or None."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d
    for a in args:
        if type(a).__name__ == "ScriptObject":      # c10d's ops: boxed
            try:
                return dist.ProcessGroup.unbox(a)
            except RuntimeError:                    # a ReduceOp
                continue
        if isinstance(a, str):
            try:
                return c10d._resolve_process_group(a)
            except (KeyError, RuntimeError, ValueError):
                continue
    return None


class CollectiveCounter(TorchDispatchMode):
    """Records the collectives a run issues as ``CollectiveOp``s (kind,
    result bytes, group size), each in ``ops`` beside ``causes``: the
    DTensor op whose dispatch issued it (the last one seen), or "" for a
    collective called directly, and ``groups``: the global ranks of its
    group. It hands DTensor ops back to DTensor, so it sees the
    collectives DTensor issues for them."""

    def __init__(self):
        super().__init__()
        self.ops: list = []
        self.causes: List[str] = []
        self.groups: List[tuple] = []
        self._cause = ""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _dtensor_op(types):
            self._cause = str(func.overloadpacket)
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        name = func.overloadpacket.__name__
        if ns in _COLLECTIVE_NAMESPACES and name in _COLLECTIVES:
            from repro_torch.roofline.analysis import CollectiveOp
            kind, where = _COLLECTIVES[name]
            import torch.distributed as dist
            result = out if where == "out" else args[where]
            pg = _group(args)
            ranks = () if pg is None else tuple(
                dist.get_process_group_ranks(pg))
            self.ops.append(CollectiveOp(kind, _tensor_bytes(result),
                                         max(len(ranks), 1)))
            self.causes.append(self._cause if ns != "c10d" else "")
            self.groups.append(ranks)
        return out


class LiveBytes(TorchDispatchMode):
    """The peak of the bytes held by the storages the run makes (``peak``),
    tracked from each op's outputs until the last tensor on a storage dies
    (the outputs of views and in-place ops share a storage already counted,
    or an argument's). Works on ``meta`` tensors, which have storages of
    their sizes and no memory. It keeps the order in which the storages
    were made and freed, so that ``split`` can tell the storages a step
    returns from its temporaries afterwards."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._held: Dict[int, list] = {}   # storage -> [bytes, tensors, id]
        self._sizes: List[int] = []        # bytes, by storage id
        self._events: List[int] = []       # id + 1 made, -(id + 1) freed

    def _release(self, key: int) -> None:
        entry = self._held.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            self._events.append(-(entry[2] + 1))
            del self._held[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _dtensor_op(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        seen = {t.untyped_storage()._cdata for t in _tensors((args, kwargs))}
        for t in _tensors(out):
            key = t.untyped_storage()._cdata
            if key in seen and key not in self._held:
                continue                    # an argument's storage
            entry = self._held.get(key)
            if entry is None:
                nbytes = t.untyped_storage().nbytes()
                entry = self._held[key] = [nbytes, 0, len(self._sizes)]
                self._sizes.append(nbytes)
                self._events.append(len(self._sizes))
                self.live += nbytes
                self.peak = max(self.peak, self.live)
            entry[1] += 1
            weakref.finalize(t, self._release, key)
        return out

    def split(self, outputs) -> tuple:
        """(output bytes, temporaries' peak) of a finished run that
        returned ``outputs`` (a tree of tensors; a DTensor's local shard
        counts): the bytes of the storages the run made that hold them
        (an argument's storage, which a step updates in place, is not
        one), and the peak of the live bytes of every other storage, as
        XLA's memory analysis tells its ``output_size_in_bytes`` from its
        ``temp_size_in_bytes``. ``peak`` is their sum's peak."""
        keys = {_local(t).untyped_storage()._cdata
                for t in _tensors(outputs)}
        ids = {self._held[k][2] for k in keys if k in self._held}
        live = peak = 0
        for e in self._events:
            i = abs(e) - 1
            if i not in ids:
                live += self._sizes[i] if e > 0 else -self._sizes[i]
                peak = max(peak, live)
        return sum(self._sizes[i] for i in ids), peak


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return []


@dataclasses.dataclass
class StepCounts:
    """What ``count_step`` read: FLOPs and bytes in all, the bytes of the
    aten ops outside the leaves by op, the kernel leaves' share by tag,
    their calls by entry, the CUDA allocator's peak above its level before
    the call (0 off the card) and the bytes of the arguments the step
    reads (``unread_args``: the positions, among the arguments' tensors,
    of those it never reads, which the bytes leave out, as ``jax.jit``
    leaves out an argument its step does not use). Of the storages the step
    makes (``LiveBytes``), ``live_peak_bytes`` is the peak of all of them,
    what a device's allocator holds above the arguments; ``output_bytes``
    those that hold what the step returns, and ``temp_peak_bytes`` the peak
    of every other one: XLA's ``output_size_in_bytes`` and
    ``temp_size_in_bytes``, which the reference's dry-run reads."""
    flops: int = 0
    bytes: int = 0
    bytes_by_op: Dict[str, int] = dataclasses.field(default_factory=dict)
    flops_by_tag: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes_by_tag: Dict[str, float] = dataclasses.field(default_factory=dict)
    leaf_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0
    arg_bytes: int = 0
    unread_args: tuple = ()
    collectives: list = dataclasses.field(default_factory=list)
    collective_causes: List[str] = dataclasses.field(default_factory=list)
    collective_groups: List[tuple] = dataclasses.field(default_factory=list)
    live_peak_bytes: int = 0
    output_bytes: int = 0
    temp_peak_bytes: int = 0


def _contiguous(out):
    """A leaf's outputs in the layout the kernels write them: contiguous."""
    if isinstance(out, (tuple, list)):
        return type(out)(_contiguous(o) for o in out)
    return out.contiguous() if isinstance(out, torch.Tensor) else out


@contextlib.contextmanager
def _kernel_leaves(counts: StepCounts, read: set):
    """Within the block, each entry of ``LEAVES`` in ``kernels.ops``, and
    its plain version, adds its work to ``counts``, the storages of its
    tensor arguments to ``read``, and runs with no dispatch mode active. A leaf inside a leaf (the plain version that an
    entry runs on the CPU) adds nothing. The kernel module's wrapper hands
    CPU and ``meta`` tensors to the plain version (outside a count it
    raises for meta tensors: no kernel takes them), and the plain version
    returns its outputs contiguous, as the kernels write theirs, so what
    follows a leaf runs the same ops whichever version ran."""
    import importlib

    from repro_torch.kernels import ops
    depth = [0]

    def leaf(fn, name, tag, work):
        @functools.wraps(fn)
        def counted(*args, **kwargs):
            if any(_dtensor_op((type(a),)) for a in args):
                # under a mesh: the call runs its local_map, whose calls on
                # the local shards are the ones counted
                return fn(*args, **kwargs)
            if not depth[0]:
                flops, nbytes = work(*args, **kwargs)
                counts.flops_by_tag[tag] = (counts.flops_by_tag.get(tag, 0)
                                            + flops)
                counts.bytes_by_tag[tag] = (counts.bytes_by_tag.get(tag, 0)
                                            + nbytes)
                counts.leaf_calls[name] = counts.leaf_calls.get(name, 0) + 1
                read.update(_storage_key(t)
                            for t in _tensors((args, kwargs)))
            depth[0] += 1
            try:
                with _disable_current_modes():
                    return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
        return counted

    def in_kernel_layout(plain):
        @functools.wraps(plain)
        def run(*args, **kwargs):
            return _contiguous(plain(*args, **kwargs))
        return run

    def by_device(fn, plain):
        @functools.wraps(fn)
        def pick(x, *args, **kwargs):
            return (fn if x.device.type == "cuda" else plain)(x, *args,
                                                              **kwargs)
        return pick

    patches = []
    for name, (tag, work, (module, plain, dispatch)) in LEAVES.items():
        mod = importlib.import_module(f"repro_torch.kernels.{module}")
        plain_fn = in_kernel_layout(getattr(mod, plain))
        patches += [(ops, name, leaf(getattr(ops, name), name, tag, work)),
                    (mod, plain, leaf(plain_fn, plain, tag, work)),
                    (mod, dispatch, by_device(getattr(mod, dispatch),
                                              plain_fn))]
    real = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in patches]
    try:
        for owner, attr, fn in patches:
            setattr(owner, attr, fn)
        yield
    finally:
        for owner, attr, fn in real:
            setattr(owner, attr, fn)


@contextlib.contextmanager
def _uncounted_shape_propagation():
    """Within the block, DTensor's shape propagation (it runs each new op
    once on fake tensors of the global shapes to learn its output's shape)
    runs with no dispatch mode active: it is not part of any rank's work."""
    try:
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
    except ImportError:
        yield
        return
    real = ShardingPropagator._propagate_tensor_meta_non_cached

    @functools.wraps(real)
    def quiet(self, op_schema):
        with _disable_current_modes():
            return real(self, op_schema)

    ShardingPropagator._propagate_tensor_meta_non_cached = quiet
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = real


def _first_device(tree) -> torch.device:
    if isinstance(tree, torch.Tensor):
        return tree.device
    items = (tree.values() if isinstance(tree, dict)
             else tree if isinstance(tree, (list, tuple)) else ())
    for v in items:
        dev = _first_device(v)
        if dev is not None:
            return dev
    return None


def _storage_key(t: torch.Tensor) -> int:
    """The storage under ``t``, through ``torch.func``'s wrappers (a leaf
    called under ``vmap`` or ``grad`` gets its arguments wrapped)."""
    from torch._C._functorch import (get_unwrapped, is_batchedtensor,
                                     is_gradtrackingtensor)
    while is_batchedtensor(t) or is_gradtrackingtensor(t):
        t = get_unwrapped(t)
    return t.untyped_storage()._cdata


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard, or ``t``."""
    from repro_torch.distributed.sharding import is_dtensor
    return t.to_local() if is_dtensor(t) else t


def _local_bytes(tree) -> int:
    """``_tensor_bytes`` of ``tree`` with each DTensor's local shard."""
    from repro_torch.distributed.sharding import is_dtensor
    if is_dtensor(tree):
        return _tensor_bytes(tree.to_local())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    return _tensor_bytes(tree)


def count_step(fn, *args) -> StepCounts:
    """Run ``fn(*args)`` once and count its FLOPs, bytes, collectives and
    live bytes (in all, its outputs' and its temporaries' peak), per device
    (see the module docstring). The step runs for real: a step that updates
    state in place does so."""
    counts = StepCounts()
    dev = _first_device(args)
    on_card = dev is not None and dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    flop_mode = FlopCounterMode(display=False)
    byte_mode = _ByteMode()
    live = LiveBytes()
    coll = CollectiveCounter()       # topmost: it hands DTensor ops back
    with _kernel_leaves(counts, byte_mode.read), \
            _uncounted_shape_propagation(), \
            flop_mode, byte_mode, live, coll:
        out = fn(*args)
    leaves = _tensors(args)
    read = [_local(t).untyped_storage()._cdata in byte_mode.read
            for t in leaves]
    counts.arg_bytes = sum(_local_bytes(t) for t, r in zip(leaves, read) if r)
    counts.unread_args = tuple(i for i, r in enumerate(read) if not r)
    counts.collectives, counts.collective_causes = coll.ops, coll.causes
    counts.collective_groups = coll.groups
    counts.live_peak_bytes = live.peak
    counts.output_bytes, counts.temp_peak_bytes = live.split(out)
    if on_card:
        torch.cuda.synchronize(dev)
        counts.peak_bytes = torch.cuda.max_memory_allocated(dev) - base
    counts.flops = (flop_mode.get_total_flops()
                    + int(sum(counts.flops_by_tag.values())))
    counts.bytes_by_op = byte_mode.by_op
    counts.bytes = (sum(byte_mode.by_op.values())
                    + int(sum(counts.bytes_by_tag.values())))
    return counts
