"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's, on the CPU: the reduced StableLM-2 x train_4k cell of the
reference's ``test_small_multipod_dryrun_cell`` on a (2, 2, 2) ("pod",
"data", "model") mesh, counted on ``meta`` tensors inside a ``"fake"``
process group of 8 ranks (made in this process and destroyed after each
test), and a cell that fails. The reference's numbers come from one child
python with 8 XLA host devices, which lowers and compiles the same cell.

The port counts the path it runs on cards (B3 as a leaf, from its local
shapes); the reference's CPU dry-run counts XLA's attention. Only the
argument bytes are compared between the two: params, AdamW's moments and
the batch, each rank's shards, which both packages place by the same
rules.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import Model
from repro_torch.roofline import counting

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
OVERRIDES = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
                 head_dim=32, d_ff=256, vocab_size=512)
# the reduced Qwen2-VL (a vlm's prefill, fed embeddings), every field
VLM = {f.name: getattr(configs.get("qwen2-vl-7b").reduced(), f.name)
       for f in dataclasses.fields(configs.get("qwen2-vl-7b").reduced())}

REFERENCE = """
import json, sys
import repro.compat  # noqa: F401
from repro.launch import dryrun
from repro.launch.mesh import make_mesh
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
out = {}
for name, arch, shape, over in (
        ("arg_bytes", "stablelm-1.6b", "train_4k", OVERRIDES),
        ("vlm_prefill_arg_bytes", "qwen2-vl-7b", "prefill_32k", VLM)):
    with mesh:
        lowered, n_tok, kind, model = dryrun.lower_cell(
            arch, shape, mesh, overrides=over)
        c = lowered.compile()
    out[name] = c.memory_analysis().argument_size_in_bytes
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run([sys.executable, "-c", "OVERRIDES = "
                          + repr(OVERRIDES) + "\nVLM = " + repr(VLM) + "\n"
                          + REFERENCE],
                         capture_output=True, text=True, timeout=600,
                         env=env)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def cell():
    """The cell counted on meta in a fake world of 8 ranks."""
    with dryrun.fake_world(8):
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"),
                         device_type="cpu")
        c, n_tokens, kind, model, specs = dryrun.count_cell(
            "stablelm-1.6b", "train_4k", mesh, overrides=OVERRIDES)
        return dict(counts=c, kind=kind, n_tokens=n_tokens,
                    spec_bytes=dryrun.spec_local_bytes(specs, mesh),
                    batch_bytes=dryrun.spec_local_bytes(specs[2], mesh),
                    by_axis=dryrun.coll_by_axis(c, mesh))


@pytest.fixture(scope="module")
def vlm_prefill():
    """The reduced Qwen2-VL's prefill_32k cell counted on meta in a fake
    world of 8 ranks: its argument bytes, from the count and from the
    specs."""
    with dryrun.fake_world(8):
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"),
                         device_type="cpu")
        c, _, _, _, specs = dryrun.count_cell("qwen2-vl-7b", "prefill_32k",
                                              mesh, overrides=VLM)
        return c.arg_bytes, dryrun.spec_local_bytes(specs, mesh)


def test_arg_bytes_match_reference(ref, cell, vlm_prefill):
    """Rank 0's argument bytes equal the reference's
    ``memory_analysis().argument_size_in_bytes`` for the same cell, but for
    the two scalars the port's count leaves out (0-dim tensors count no
    bytes): AdamW's int32 step count and the f32 learning rate. The
    reduced Qwen2-VL's prefill_32k cell has no scalar and equals the
    reference's to the byte: its prefill, fed embeddings, never reads the
    embedding table, which the count leaves out (``unread_args``) as the
    reference's ``jax.jit`` does (``keep_unused=False``)."""
    scalars = 4 + 4
    assert cell["counts"].arg_bytes + scalars == ref["arg_bytes"]
    assert cell["spec_bytes"] == cell["counts"].arg_bytes
    assert vlm_prefill[0] == vlm_prefill[1] == ref["vlm_prefill_arg_bytes"]


def test_train_step_outputs_are_its_new_params_and_moments(cell):
    """A train step's outputs (``StepCounts.output_bytes``, the dry-run's
    ``out_gb_dev``) are its new params and AdamW moments, as many bytes a
    rank as the arguments but for the batch, and a few scalars (the step
    count and the metrics); its temporaries' peak (``temp_gb_dev``, XLA's
    ``temp_size_in_bytes``) leaves them out, and the whole peak, what a
    card's allocator holds, takes both."""
    c = cell["counts"]
    state = c.arg_bytes - cell["batch_bytes"]
    assert 0 <= c.output_bytes - state <= 64, (c.output_bytes, state)
    assert 0 < c.temp_peak_bytes < c.live_peak_bytes
    assert c.live_peak_bytes <= c.temp_peak_bytes + c.output_bytes


def test_prefill_row_reads_fit_from_its_whole_peak(tmp_path):
    """A prefill cell's row (and its JSON file) carries the whole peak
    (``peak_gb_dev``, ``live_peak_bytes``), the one a card's allocator
    holds and the one whether the cell fits is read from: above the
    temporaries' peak by the KV cache made before the layers run, and at
    most temporaries and outputs together."""
    row = dryrun.run_cell("stablelm-1.6b", "prefill_32k", False,
                          str(tmp_path), overrides=dict(OVERRIDES,
                                                        num_layers=1))
    assert "error" not in row, row
    temp, out, peak = (row[k] for k in ("temp_gb_dev", "out_gb_dev",
                                        "peak_gb_dev"))
    assert 0 < temp < peak <= temp + out, (temp, out, peak)
    (path,) = tmp_path.glob("stablelm-1.6b__prefill_32k__*.json")
    assert json.loads(path.read_text())["peak_gb_dev"] == peak


def test_pod_axis_carries_collectives(cell):
    """The cell's collectives run over every mesh axis, the pod axis
    among them (its FSDP gathers and gradient reductions)."""
    assert cell["by_axis"].get("pod", 0) > 0
    assert cell["by_axis"].get("model", 0) > 0
    assert sum(cell["by_axis"].values()) > 0


def test_flops_cover_the_unsharded_step(cell):
    """Rank 0's FLOPs x 8 ranks are at least the unsharded step's (counted
    on meta too): sharding splits the work, and may repeat some of it."""
    cfg = dataclasses.replace(configs.get("stablelm-1.6b"), **OVERRIDES)
    from repro_torch import optim
    from repro_torch.core import packing
    from repro_torch.launch.train import make_train_step
    from torch._subclasses.fake_tensor import FakeTensorMode
    model = Model(cfg, device="meta")
    with FakeTensorMode():
        shapes = Model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
    params = packing.tree_map(lambda t: torch.empty(
        t.shape, dtype=t.dtype, device="meta"), shapes)
    batch = model.input_specs(SHAPES_BY_NAME["train_4k"])
    opt = optim.adamw()
    plain = counting.count_step(make_train_step(model, opt), params,
                                opt.init(params), batch,
                                torch.zeros((), device="meta"))
    assert cell["counts"].flops * 8 >= plain.flops
    assert cell["counts"].leaf_calls == {"flash_attention": 4}


def test_failing_cell_prints_fail(tmp_path, capsys):
    """A cell that cannot be built (a "model" axis of 16 that does not
    divide 8 experts) prints FAIL and returns an error row."""
    moe = dataclasses.replace(configs.get("deepseek-moe-16b").moe,
                              num_experts=8)
    row = dryrun.run_cell("deepseek-moe-16b", "train_4k", False,
                          str(tmp_path), overrides=dict(num_layers=1,
                                                        moe=moe))
    assert "error" in row and "experts" in row["error"]
    assert "[dryrun] FAIL deepseek-moe-16b" in capsys.readouterr().out


def test_cli_exits_1_on_a_failed_cell(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "stablelm-1.6b", "--shape", "no_such_shape", "--mesh", "single",
         "--out", str(tmp_path)], capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=SRC))
    assert res.returncode == 1
    assert "[dryrun] FAIL stablelm-1.6b" in res.stdout
    assert "0 ok, 1 failed" in res.stdout


@pytest.mark.parametrize("arch, kind", [
    ("qwen2-vl-7b", "train"), ("seamless-m4t-medium", "train"),
    ("mamba2-130m", "prefill"), ("zamba2-7b", "decode"),
    ("deepseek-moe-16b", "decode")])
def test_every_family_counts_on_a_mesh(arch, kind):
    """The families and kinds the cells above do not reach, each reduced
    and at a small shape, build and count on the (2, 2, 2) fake mesh: the
    vlm's M-RoPE and unused embedding table, the encdec's cross-attention
    and encoder, the scan under ``local_map``, a sharded decode cache,
    EP in decode. FLOPs counted, argument bytes two ways equal, and a
    train step's collectives over the pod axis."""
    from repro_torch.configs.base import ShapeSpec
    red = configs.get(arch).reduced()
    over = {f.name: getattr(red, f.name) for f in dataclasses.fields(red)}
    shape = ShapeSpec("small", 64, 4, kind)
    with dryrun.fake_world(8):
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"),
                         device_type="cpu")
        c, _, _, _, specs = dryrun.count_cell(arch, shape, mesh,
                                              overrides=over)
        by_axis = dryrun.coll_by_axis(c, mesh)
        assert c.flops > 0
        assert c.arg_bytes == dryrun.spec_local_bytes(specs, mesh)
        if kind == "train":
            assert by_axis.get("pod", 0) > 0
