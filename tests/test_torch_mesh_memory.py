"""The memory and FLOPs of the port's sharded steps against the
reference's (ROADMAP C18, C22-C25), counted on ``meta`` in a ``"fake"``
process group of 8 ranks on a (1, 8) ("data", "model") mesh, and B3's
backward by query slices on the CPU.

The reference's numbers come from one child python with 8 XLA host
devices, which compiles the same cells (``lower_cell(...).compile()``)
and reads ``memory_analysis()``'s ``temp_size_in_bytes`` and
``output_size_in_bytes`` (less ``alias_size_in_bytes``) and the FLOPs of
its trip-count-aware HLO analyzer (``roofline.hlo_costs.analyze_hlo``,
the reference dry-run's); the port's are ``count_cell``'s
``temp_peak_bytes`` (or ``live_peak_bytes``, outputs included, where a
test says so), ``output_bytes`` and ``flops``: the dry-run's
``temp_gb_dev``, ``out_gb_dev`` and FLOPs. The cells, at train_4k unless
named otherwise:
  * reduced StableLM-2, per-layer growth, 8 and 16 layers, 8 heads (over
    "model"): the block input that remat keeps, and from 8 layers on the
    norms' (L, d) leaves sharded over "model" by the fallback rule;
  * reduced StableLM-2, one layer with 4 heads, which "model" does not
    divide (each rank attends with every head for its share of the batch,
    C24; B3's backward is held at the whole batch's shape on its own), and
    one at prefill_32k with 24 query heads on 12
    KV heads (a cache is written: each rank attends with its share of the
    heads, and rank 0's, heads 0-2, span two KV groups);
  * reduced StableLM-2, 2 layers, at prefill_32k: its logits and KV cache
    are the step's outputs (C18);
  * reduced Mamba2-130m, 8 layers, shaped as the full model is on its
    16-wide "model" axis: 12 heads and an in-projection 428 wide, which
    "model" does not divide, a width of 96 that it does (C22);
  * reduced Zamba2-7B, 2 layers, at prefill_32k (the in-projection's
    blocks each split over "model", C18) and at train_4k (port only: each
    product's local shapes, C25);
  * reduced Mamba2-130m, 16 layers and 12 heads (port only): its (16, 12)
    leaves are sharded along their layer dim (C23).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention, transformer
from repro_torch.roofline import counting

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESH = ((1, 8), ("data", "model"))
WIDTHS = dict(d_model=128, d_ff=256, vocab_size=512)
HEADS_SPLIT = dict(WIDTHS, num_heads=8, num_kv_heads=8, head_dim=16)
HEADS_WHOLE = dict(WIDTHS, num_heads=4, num_kv_heads=4, head_dim=32)
HEADS_GQA = dict(WIDTHS, num_heads=24, num_kv_heads=12, head_dim=16)
DEPTHS = (8, 16)
SSM = dict(state_dim=16, head_dim=16, expand=2, conv_width=4, chunk_size=128)
# a reduced Zamba2-7B whose in-projection's blocks (z and x 256 wide, B and
# C 16, dt 16 heads) each divide over 8 "model" ranks, 560 wide in all
ZAMBA2 = dict(num_layers=2, d_model=128, num_heads=8, num_kv_heads=8,
              head_dim=16, d_ff=384, vocab_size=512, hybrid_attn_period=2,
              ssm=SSM)
ZAMBA2_WIDTHS = (256, 560)              # d_in, d_in + ch + nh
# name -> (arch, overrides, shape); an "ssm" override is SSMConfig's fields
CELLS = {f"split{L}": ("stablelm-1.6b", dict(HEADS_SPLIT, num_layers=L),
                       "train_4k") for L in DEPTHS}
CELLS["whole1"] = ("stablelm-1.6b", dict(HEADS_WHOLE, num_layers=1),
                   "train_4k")
CELLS["gqa1"] = ("stablelm-1.6b", dict(HEADS_GQA, num_layers=1),
                 "prefill_32k")
CELLS["prefill"] = ("stablelm-1.6b", dict(HEADS_SPLIT, num_layers=2),
                    "prefill_32k")
CELLS["mamba2"] = ("mamba2-130m", dict(
    num_layers=8, d_model=96, vocab_size=512, ssm=SSM), "train_4k")
CELLS["zamba2"] = ("zamba2-7b", ZAMBA2, "prefill_32k")
# counted by the port alone
PORT_CELLS = {
    "zamba2_train": ("zamba2-7b", ZAMBA2, "train_4k"),
    **{f"mamba16_{shape}": ("mamba2-130m", dict(
        num_layers=16, d_model=96, vocab_size=512, ssm=SSM), shape)
       for shape in ("train_4k", "prefill_32k")}}

REFERENCE = """
import json, sys
import repro.compat  # noqa: F401
from repro.configs.base import SSMConfig
from repro.launch import dryrun
from repro.launch.mesh import make_mesh
from repro.roofline.hlo_costs import analyze_hlo
mesh = make_mesh(MESH[0], MESH[1])
out = {}
for name, (arch, over, shape) in CELLS.items():
    if "ssm" in over:
        over = dict(over, ssm=SSMConfig(**over["ssm"]))
    with mesh:
        lowered, _, _, _ = dryrun.lower_cell(arch, shape, mesh,
                                             overrides=over)
        c = lowered.compile()
    m = c.memory_analysis()
    out[name] = {"temp": m.temp_size_in_bytes,
                 "arg": m.argument_size_in_bytes,
                 "out": m.output_size_in_bytes - m.alias_size_in_bytes,
                 "flops": analyze_hlo(c.as_text()).flops}
print(json.dumps(out))
"""


def _count(name, seen=None):
    """The cell's counts; with ``seen`` (a list), each matrix product a
    rank runs (``aten.mm``, ``aten.addmm``) is appended to it as its
    operands' local shapes, and each ``aten.cat`` as its result's."""
    arch, over, shape = {**CELLS, **PORT_CELLS}[name]
    if "ssm" in over:
        over = dict(over, ssm=SSMConfig(**over["ssm"]))
    mp = pytest.MonkeyPatch()
    if seen is not None:
        real = counting._ByteMode.__torch_dispatch__
        aten = torch.ops.aten
        mm = {aten.mm.default, aten.addmm.default}

        def spy(self, func, types, args=(), kwargs=None):
            out = real(self, func, types, args, kwargs)
            if func in mm and out is not NotImplemented:
                seen.append(("mm", [tuple(a.shape) for a in args[-2:]]))
            if func.overloadpacket is aten.cat and out is not NotImplemented:
                seen.append(("cat", [tuple(out.shape)]))
            return out
        mp.setattr(counting._ByteMode, "__torch_dispatch__", spy)
    try:
        with dryrun.fake_world(8):
            mesh = make_mesh(*MESH, device_type="cpu")
            return dryrun.count_cell(arch, shape, mesh, overrides=over)[0]
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def counts():
    """The port's counts, taken while the reference's child compiles the
    same cells. The per-layer cells run B3's backward in one slice (its
    budget raised) to keep the count short, and record what each layer's
    recompute hands back (``_Recompute.backward``): its inputs' global
    shapes and placements beside its gradients' placements and local
    storage."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    child = subprocess.Popen(
        [sys.executable, "-c", f"MESH = {MESH!r}\nCELLS = {CELLS!r}\n"
         + REFERENCE], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)
    try:
        handed = []
        real = transformer._Recompute.backward

        def backward(ctx, *grads):
            inputs = ctx.saved_tensors
            out = real(ctx, *grads)
            wide = [n > 1 for n in MESH[0]]
            handed.extend(
                ([p for p, w in zip(t.placements, wide) if w],
                 [p for p, w in zip(g.placements, wide) if w],
                 t.to_local().shape, g.to_local().shape,
                 g.to_local().untyped_storage().nbytes(),
                 g.to_local().numel() * g.element_size())
                for t, g in zip(inputs, out[2:]) if g is not None)
            return out

        port = {name: _count(name) for name in (
            "whole1", "gqa1", "prefill", "mamba2", "mamba16_train_4k",
            "mamba16_prefill_32k")}
        for name in ("zamba2", "zamba2_train"):
            port[name + "_ops"] = []
            port[name] = _count(name, port[name + "_ops"])
        mp = pytest.MonkeyPatch()
        mp.setattr(ops, "BACKWARD_BLOCK_BYTES", 1 << 50)
        mp.setattr(transformer._Recompute, "backward", staticmethod(backward))
        try:
            port["split8"] = _count("split8")
            port["handed"] = list(handed)
            port["split16"] = _count("split16")
        finally:
            mp.undo()
        stdout, stderr = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    assert child.returncode == 0, stderr[-4000:]
    return port, json.loads(stdout.strip().splitlines()[-1])


def test_temp_growth_per_layer_within_twice_the_reference(counts):
    """Between 8 and 16 layers the port's temporaries grow by at most
    twice the reference's a layer: remat keeps each block input sharded
    over "model" (it kept it whole: 268 MB a layer against the
    reference's 67), and the norms' sharded leaves no longer shard the
    activations they scale. The argument bytes agree (but for AdamW's
    step count and the learning rate, which the port's count leaves
    out)."""
    port, reference = counts
    lo, hi = (f"split{L}" for L in DEPTHS)
    per_layer = (port[hi].live_peak_bytes
                 - port[lo].live_peak_bytes) / (DEPTHS[1] - DEPTHS[0])
    ref_per_layer = (reference[hi]["temp"]
                     - reference[lo]["temp"]) / (DEPTHS[1] - DEPTHS[0])
    assert 0 < per_layer <= 2 * ref_per_layer, (per_layer, ref_per_layer)
    for name in (lo, hi):
        assert port[name].arg_bytes + 8 == reference[name]["arg"]


def test_one_layer_whole_attention_within_twice_the_reference(counts):
    """B3 over the whole of whole1's layer, every head of all 256
    sequences as a rank took it before the attention was split over
    "model" (C24), holds at most twice the reference's temp of the layer,
    and at most 20 of its backward's f32 score blocks: the backward holds
    one query slice's scores at a time (about 17 blocks at its peak here;
    with every key chunk's scores held at once, 198.9 GB, and the layer
    200.9 GB, against the reference's 24-27). Counted on ``meta``, the
    forward and the backward of ``ops.flash_attention`` alone. The cell
    itself, where each rank now attends with every head for its 32 rows
    (``attention._rows_over_model``), is within twice the reference's as
    well."""
    port, reference = counts
    limit = 2 * reference["whole1"]["temp"]
    B, S, H, D = 256, 4096, HEADS_WHOLE["num_heads"], HEADS_WHOLE["head_dim"]

    def step(q, k, v, g):
        out = ops.flash_attention(q, k, v, causal=True)
        return torch.autograd.grad(out, (q, k, v), g)
    q, k, v, g = (torch.empty((B, S, H, D), dtype=torch.bfloat16,
                              device="meta", requires_grad=i < 3)
                  for i in range(4))
    b3 = counting.count_step(step, q, k, v, g)
    block = B * H * ops.backward_rows(B, S, H, 1024) * 1024 * 4
    assert b3.leaf_calls == {"flash_attention": 1}
    assert b3.live_peak_bytes <= min(limit, 20 * block), (
        b3.live_peak_bytes, limit, block)
    assert port["whole1"].live_peak_bytes <= limit
    # the forward and the recompute in the backward
    assert port["whole1"].leaf_calls == {"flash_attention": 2}


def test_mamba2_flops_and_temp_within_twice_the_reference(counts):
    """The reduced Mamba2-130m's FLOPs and temporaries are each at most
    twice the reference's: the in-projection, whose output "model" does
    not divide, is split over "model" along its contraction
    (``sharding.split_contraction``), and each rank scans its share of
    the heads that "model" does not divide (``ssm._scan_split_heads``).
    Both computed whole on every rank, PR 23's tree counted 2.7 times the
    reference's FLOPs and 2.7 times its temp. The argument bytes agree
    (but for AdamW's step count and the learning rate)."""
    port, reference = counts
    got, want = port["mamba2"], reference["mamba2"]
    assert got.flops <= 2 * want["flops"], (got.flops, want["flops"])
    assert got.live_peak_bytes <= 2 * want["temp"], (got.live_peak_bytes,
                                                     want["temp"])
    assert got.arg_bytes + 8 == want["arg"]


@pytest.mark.parametrize("name", ["whole1", "gqa1"])
def test_attention_heads_shared_where_model_does_not_divide_them(counts,
                                                                 name):
    """With query heads that "model" does not divide, the attention is
    split over "model" all the same: whole1's train step (4 heads on 8
    ranks) by its batch (``attention._rows_over_model``), gqa1's prefill
    (24 query heads on 12 KV heads) by shares of ceil(24 / 8) query heads,
    rank 0's spanning two KV groups (``attention._head_share``). Each
    cell's FLOPs are at most 1.25 times the reference's and its temp at
    most twice it; with every rank attending with all the heads, whole1
    counted 6.2 times the reference's FLOPs (C24)."""
    port, reference = counts
    got, want = port[name], reference[name]
    assert got.flops <= 1.25 * want["flops"], (got.flops, want["flops"])
    assert got.temp_peak_bytes <= 2 * want["temp"], (got.temp_peak_bytes,
                                                     want["temp"])


def test_prefill_outputs_counted_apart_from_temporaries(counts):
    """The reduced StableLM-2's prefill returns its logits and the KV cache
    it made: their bytes are the count's ``output_bytes``, equal to the
    reference's output bytes (less those aliased to its arguments, and
    but for the table of the output tuple's pointers), and
    the peak of every other storage (``temp_peak_bytes``, the dry-run's
    ``temp_gb_dev``) is within twice the reference's temp. The whole peak
    (``live_peak_bytes``), what a card's allocator would hold, is above it:
    the cache is made before the layers run (C18)."""
    port, reference = counts
    got, want = port["prefill"], reference["prefill"]
    # XLA's output is a tuple: beside its 5 buffers (the logits and the
    # cache's k, v, len and pos) it counts a table of their 8-byte pointers
    assert got.output_bytes + 5 * 8 == want["out"], (got.output_bytes,
                                                     want["out"])
    assert got.temp_peak_bytes <= 2 * want["temp"], (got.temp_peak_bytes,
                                                     want["temp"])
    assert got.live_peak_bytes > got.temp_peak_bytes


def test_zamba2_in_projection_kept_split(counts):
    """The reduced Zamba2's prefill gathers no whole in-projection: one
    product for each of its column blocks (z, x, B, C, dt), each split over
    "model" (``ssm._project_on_mesh``), where one 560-wide product cut into
    z, xBC and dt off its shard edges made DTensor gather its (B, 32768,
    560) result whole (``aten.cat``; the weight itself is gathered, and so
    are the conv state's last 3 rows). Its temp is within twice the
    reference's (C18)."""
    port, reference = counts
    got, want = port["zamba2"], reference["zamba2"]
    cats = [shapes[0] for op, shapes in port["zamba2_ops"] if op == "cat"]
    rows = [s for s in cats if len(s) == 3 and s[1] == 32768]
    assert not [s for s in rows if s[-1] in ZAMBA2_WIDTHS], rows
    assert got.temp_peak_bytes <= 2 * want["temp"], (got.temp_peak_bytes,
                                                     want["temp"])


def test_zamba2_products_split_over_model(counts):
    """Every matrix product of the reduced Zamba2's train step runs on its
    split over "model": no operand on a rank is as wide as the whole
    in-projection (560) or its z and x blocks (256). Cut from one product,
    the in-projection's weight gradient was taken from its whole (B, S,
    560) gradient: on every rank under the strategy torch 2.11's DTensor
    picks, along a batch split under 2.13's (C25)."""
    port, _ = counts
    mms = [shapes for op, shapes in port["zamba2_train_ops"] if op == "mm"]
    assert mms
    wide = [s for s in mms if set(ZAMBA2_WIDTHS) & {d for t in s for d in t}]
    assert not wide, wide


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_stacked_leaf_sharded_along_its_layers(counts, shape):
    """A reduced Mamba2 of 16 layers and 12 heads counts on (1, 8): its
    (16, 12) leaves ``A_log``, ``dt_bias`` and ``D``, which the specs'
    fallback rule shards along their layer dim, are gathered whole before
    the layers are unbound (``transformer._unbindable``; DTensor refused
    the unbind, C23). Its train step does at most twice the work of the
    8-layer cell's (the head and the embedding counted once)."""
    port, _ = counts
    c = port[f"mamba16_{shape}"]
    assert c.flops > 0 and c.temp_peak_bytes > 0
    if shape == "train_4k":
        assert c.flops <= 2 * port["mamba2"].flops


def test_layer_weight_gradients_reduced_at_their_layer(counts):
    """Every gradient a layer's recompute hands back has its input's own
    placements on each mesh axis of more than one rank (no partial sum
    carried on to the end of the backward; on an axis of one rank a
    partial sum is whole already, and the gather that would bind it is
    skipped), its input's local shape, and a local tensor that owns
    exactly its storage (no shard that keeps a gathered whole alive):
    each weight's gradient is reduced to its parameter's local shard in
    its layer's backward."""
    port, _ = counts
    handed = port["handed"]
    assert len(handed) == DEPTHS[0] * 10     # each layer's x and 9 leaves
    for placements, grad_placements, shape, grad_shape, nbytes, own \
            in handed:
        assert grad_placements == placements
        assert grad_shape == shape
        assert nbytes == own


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 24)])
def test_b3_backward_by_query_slices(monkeypatch, causal, window):
    """``ops.flash_attention``'s backward by query slices (the budget cut
    so that 70 query rows take five slices of 16 and one of 6) against the
    backward through ``sdpa_chunked`` whole, under ``torch.func.vmap(
    torch.func.grad(...))`` with a lane mask per lane: dq, dk and dv
    within 1e-6 of each gradient's largest entry in f32, and the inactive
    lanes' exact zeros."""
    lanes, B, S, Hq, Hkv, D = 3, 2, 70, 4, 2, 16
    monkeypatch.setattr(ops, "BACKWARD_BLOCK_BYTES", B * Hq * S * 4 * 16)
    assert ops.backward_rows(B, S, Hq, S) == 16
    rng = np.random.default_rng(24)
    q, k, v, gw = (torch.from_numpy(
        rng.standard_normal((lanes, B, S, h, D)).astype(np.float32))
        for h in (Hq, Hkv, Hkv, Hq))
    act = torch.tensor([[1, 0], [0, 1], [1, 1]], dtype=torch.int32)

    def sliced(q, k, v, a):
        return ops.flash_attention(q, k, v, causal, window, active=a)

    def whole(q, k, v, a):
        out = attention.sdpa_chunked(q, k, v, causal=causal, window=window)
        return ref.mask_lanes(a, out)

    grads = {}
    for name, attend in (("sliced", sliced), ("whole", whole)):
        grads[name] = torch.func.vmap(torch.func.grad(
            lambda q, k, v, gw, a: (attend(q, k, v, a) * gw).sum(),
            argnums=(0, 1, 2)))(q, k, v, gw, act)
    for got, want in zip(grads["sliced"], grads["whole"]):
        scale = want.abs().max()
        assert scale > 0
        assert (got - want).abs().max() <= 1e-6 * scale
        for lane, b in zip(*torch.nonzero(act == 0, as_tuple=True)):
            assert torch.equal(got[lane, b], torch.zeros_like(got[lane, b]))


def test_backward_rows_at_the_qwen2_vl_train_cell():
    """qwen2-vl-7b's layer at train_4k with 16 sequences of 4096 on a
    rank and its 28 query heads whole, as 16 x 16 gave it before the
    attention was split over "model" (C24), key chunks of 1024: 512 query
    rows a slice, a 0.94 GB f32 score block. Split, its one sequence a
    rank takes one slice, as does a short sequence that fits."""
    rows = ops.backward_rows(16, 4096, 28, 1024)
    assert rows == 512
    assert 16 * 28 * rows * 1024 * 4 <= ops.BACKWARD_BLOCK_BYTES
    assert ops.backward_rows(1, 4096, 28, 1024) == 4096
    assert ops.backward_rows(2, 512, 4, 512) == 512

