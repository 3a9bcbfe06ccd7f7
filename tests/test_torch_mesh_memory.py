"""The memory of the port's sharded training step against the reference's
(ROADMAP C18), counted on ``meta`` in a ``"fake"`` process group of 8
ranks on a (1, 8) ("data", "model") mesh, and B3's backward by query
slices on the CPU.

The reference's numbers come from one child python with 8 XLA host
devices, which compiles the same cells (``lower_cell(...).compile()``)
and reads ``memory_analysis().temp_size_in_bytes`` and the FLOPs of its
trip-count-aware HLO analyzer (``roofline.hlo_costs.analyze_hlo``, the
reference dry-run's); the port's are ``count_cell``'s ``live_peak_bytes``
and ``flops``, the dry-run's ``temp_gb_dev`` and FLOPs. The cells, all
at train_4k:
  * reduced StableLM-2, per-layer growth, 8 and 16 layers, 8 heads (over
    "model"): the block input that remat keeps, and from 8 layers on the
    norms' (L, d) leaves sharded over "model" by the fallback rule;
  * reduced StableLM-2, one layer with 4 heads, which "model" does not
    divide, so that the attention is whole on every rank (B3's backward);
  * reduced Mamba2-130m, 8 layers, shaped as the full model is on its
    16-wide "model" axis: 12 heads and an in-projection 428 wide, which
    "model" does not divide, a width of 96 that it does (C22).
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

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESH = ((1, 8), ("data", "model"))
WIDTHS = dict(d_model=128, d_ff=256, vocab_size=512)
HEADS_SPLIT = dict(WIDTHS, num_heads=8, num_kv_heads=8, head_dim=16)
HEADS_WHOLE = dict(WIDTHS, num_heads=4, num_kv_heads=4, head_dim=32)
DEPTHS = (8, 16)
# name -> (arch, overrides); an "ssm" override is SSMConfig's fields
CELLS = {f"split{L}": ("stablelm-1.6b", dict(HEADS_SPLIT, num_layers=L))
         for L in DEPTHS}
CELLS["whole1"] = ("stablelm-1.6b", dict(HEADS_WHOLE, num_layers=1))
CELLS["mamba2"] = ("mamba2-130m", dict(
    num_layers=8, d_model=96, vocab_size=512,
    ssm=dict(state_dim=16, head_dim=16, expand=2, conv_width=4,
             chunk_size=128)))

REFERENCE = """
import json, sys
import repro.compat  # noqa: F401
from repro.configs.base import SSMConfig
from repro.launch import dryrun
from repro.launch.mesh import make_mesh
from repro.roofline.hlo_costs import analyze_hlo
mesh = make_mesh(MESH[0], MESH[1])
out = {}
for name, (arch, over) in CELLS.items():
    if "ssm" in over:
        over = dict(over, ssm=SSMConfig(**over["ssm"]))
    with mesh:
        lowered, _, _, _ = dryrun.lower_cell(arch, "train_4k", mesh,
                                             overrides=over)
        c = lowered.compile()
    m = c.memory_analysis()
    out[name] = {"temp": m.temp_size_in_bytes,
                 "arg": m.argument_size_in_bytes,
                 "flops": analyze_hlo(c.as_text()).flops}
print(json.dumps(out))
"""


def _count(name):
    arch, over = CELLS[name]
    if "ssm" in over:
        over = dict(over, ssm=SSMConfig(**over["ssm"]))
    with dryrun.fake_world(8):
        mesh = make_mesh(*MESH, device_type="cpu")
        return dryrun.count_cell(arch, "train_4k", mesh, overrides=over)[0]


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

        port = {name: _count(name) for name in ("whole1", "mamba2")}
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
    """With the attention whole on every rank, one layer's temporaries
    are at most twice the reference's: B3's backward holds one query
    slice's scores at a time (it held every key chunk's scores of the
    layer: 200.9 GB against the reference's 24-27)."""
    port, reference = counts
    assert port["whole1"].live_peak_bytes <= 2 * reference["whole1"]["temp"]
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
    """qwen2-vl-7b at train_4k on 16 x 16: 16 sequences a rank, its 28
    query heads whole on every rank (16 does not divide them), key chunks
    of 1024: 512 query rows a slice, a 0.94 GB f32 score block. A short
    sequence that fits takes one slice."""
    rows = ops.backward_rows(16, 4096, 28, 1024)
    assert rows == 512
    assert 16 * 28 * rows * 1024 * 4 <= ops.BACKWARD_BLOCK_BYTES
    assert ops.backward_rows(2, 512, 4, 512) == 512

