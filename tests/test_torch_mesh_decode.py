"""The collectives and FLOPs of the port's sharded decode steps against the
reference's (ROADMAP C26, C27), counted on ``meta`` in a ``"fake"``
process group of 8 ranks.

The reference's numbers come from one child python with 8 XLA host
devices, which compiles the same cells (``lower_cell(...).compile()``)
and reads the FLOPs and the collectives' operand bytes of its
trip-count-aware HLO analyzer (``roofline.hlo_costs.analyze_hlo``, the
reference dry-run's ``hlo_gflops_dev`` and ``coll_gb_dev``); the port's are
``count_cell``'s ``flops`` and its collectives' operand bytes, by mesh axis
as the dry-run's ``coll_by_axis_gb`` keys them. The cells, each a
decode_32k step (128 rows against a 32k cache), the Mamba2 ones with the
full models' state size (N = 64) and 2 ranks on "data", so that the rows
a rank keeps are a share of the batch:
  * reduced Mamba2-130m on a (2, 4) ("data", "model") mesh, 10 heads,
    which "model" does not divide (C26);
  * reduced Zamba2-7B on (2, 4), 8 heads, which it divides (C26);
  * reduced DeepSeekMoE-16B under expert parallelism on a (2, 2, 2)
    ("pod", "data", "model") mesh (C27).
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs.base import SSMConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SSM = dict(state_dim=64, head_dim=16, expand=2, conv_width=4, chunk_size=128)
# name -> (arch, overrides, mesh); an "ssm" override is SSMConfig's fields
CELLS = {
    "mamba2": ("mamba2-130m", dict(num_layers=2, d_model=80,
                                   vocab_size=512, ssm=SSM),
               ((2, 4), ("data", "model"))),
    "zamba2": ("zamba2-7b", dict(num_layers=2, d_model=128, num_heads=8,
                                 num_kv_heads=8, head_dim=16, d_ff=384,
                                 vocab_size=512, hybrid_attn_period=2,
                                 ssm=SSM),
               ((2, 4), ("data", "model"))),
    "moe": ("deepseek-moe-16b", dict(num_layers=2, d_model=64, num_heads=4,
                                     num_kv_heads=4, head_dim=16, d_ff=64,
                                     vocab_size=512),
            ((2, 2, 2), ("pod", "data", "model"))),
}
SHAPE = "decode_32k"

REFERENCE = """
import json
import repro.compat  # noqa: F401
from repro.configs.base import SSMConfig
from repro.launch import dryrun
from repro.launch.mesh import make_mesh
from repro.roofline.hlo_costs import analyze_hlo
out = {}
for name, (arch, over, (shape, axes)) in CELLS.items():
    if "ssm" in over:
        over = dict(over, ssm=SSMConfig(**over["ssm"]))
    mesh = make_mesh(shape, axes)
    with mesh:
        lowered, _, _, _ = dryrun.lower_cell(arch, SHAPE, mesh,
                                             overrides=over)
        c = lowered.compile()
    h = analyze_hlo(c.as_text())
    out[name] = {"flops": h.flops, "coll": h.collective_operand_bytes}
print(json.dumps(out))
"""


def _count(name):
    """(counts, operand bytes by mesh axis) of the port's cell."""
    arch, over, (shape, axes) = CELLS[name]
    if "ssm" in over:
        over = dict(over, ssm=SSMConfig(**over["ssm"]))
    with dryrun.fake_world(8):
        mesh = make_mesh(shape, axes, device_type="cpu")
        c = dryrun.count_cell(arch, SHAPE, mesh, overrides=over)[0]
        return c, dryrun.coll_by_axis(c, mesh)


@pytest.fixture(scope="module")
def counts():
    """The port's counts, taken while the reference's child compiles the
    same cells."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    child = subprocess.Popen(
        [sys.executable, "-c", f"CELLS = {CELLS!r}\nSHAPE = {SHAPE!r}\n"
         + REFERENCE], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)
    try:
        port = {name: _count(name) for name in CELLS}
        stdout, stderr = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    assert child.returncode == 0, stderr[-4000:]
    return port, json.loads(stdout.strip().splitlines()[-1])


def _coll(c) -> int:
    return sum(op.operand_bytes for op in c.collectives)


@pytest.mark.parametrize("name", ["mamba2", "zamba2"])
def test_mamba2_decode_within_the_reference(counts, name):
    """A Mamba2 decode step's collectives are within twice the
    reference's and its FLOPs within 1.25 times them, with 10 heads that
    "model" (4) does not divide and with 8 that it does: the in-projection
    is one product per column block of w_in, the rows are kept over
    "data", and the state update runs under ``local_map`` on the cache's
    placements (``ssm._state_step_on_mesh``). Through one in-projection
    product and the state left to DTensor, the reduced Mamba2 did 1.38
    times the reference's FLOPs, and the reduced Zamba2 moved 4.3 times
    its collectives."""
    port, reference = counts
    (got, _), want = port[name], reference[name]
    assert _coll(got) <= 2 * want["coll"], (_coll(got), want["coll"])
    assert got.flops <= 1.25 * want["flops"], (got.flops, want["flops"])


def test_zamba2_decode_gathers_no_state(counts):
    """No collective of the reduced Zamba2's decode step is as large as
    one layer's SSM state on a rank (its 64 rows, 8 heads, 16 x 64, f32),
    which "model" splits along its heads: the step updates each rank's
    own heads, where DTensor gathered the state whole at
    ``new_state = state * a + upd``."""
    port, _ = counts
    got, _ = port["zamba2"]
    state = 64 * 8 * 16 * 64 * 4
    big = [(op.kind, op.result_bytes) for op in got.collectives
           if op.result_bytes >= state]
    assert not big, big


def test_moe_decode_on_two_pods(counts):
    """The reduced DeepSeekMoE's expert-parallel decode step on a (2, 2,
    2) mesh gathers its experts over "pod" and "data" in one collective
    over their flattened group (keyed "pod+data"), so the bytes over
    "pod" alone are at most those over "data", and the whole is within
    twice the reference's. Gathered "data" first and then "pod", the
    "pod" gathers moved twice the bytes of the "data" ones."""
    port, reference = counts
    (got, by_axis), want = port["moe"], reference["moe"]
    assert by_axis.get("pod+data", 0) > 0, by_axis
    assert by_axis.get("pod", 0) <= by_axis.get("data", 0), by_axis
    assert _coll(got) <= 2 * want["coll"], (_coll(got), want["coll"])
