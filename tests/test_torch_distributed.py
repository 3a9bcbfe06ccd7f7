"""The port's distributed layer (``repro_torch.distributed``, expert
parallelism, a sharded train step, the kernels under a mesh and the
collective counter) against the JAX reference, on the CPU.

Multi-rank runs happen in child processes: the port's on gloo ranks that
meet through a ``file://`` store in the test's temporary directory (one job
of 4 ranks and one of 8, each run once per module), the reference's in ONE
child python with 8 XLA host devices (``tests/test_distributed.py``'s
pattern), which writes its outputs to an ``.npz`` once per module. Inputs
come from numpy with a seed or from the reference's own init, crossing over
as numpy arrays.

Tolerances: sharding specs equal; int8 ``compressed_psum`` bit-equal (the
same scale, integer sums); fp32 within 1e-6; bf16 within the reference
test's 0.02 of the exact sum; ``allgather_matmul`` within 1e-5; expert
parallelism within 1e-4 of the reference's (its test's bound), within 1e-6
of the port's unsharded routing, and its gradient within 1e-5 relative to
each leaf's largest entry; the sharded step's loss within 1e-5 of the
unsharded one. The reduced DeepSeekMoE-16B of the step is the reference
test's (``tests/test_distributed.py::test_distributed_train_step_runs_on_8_devices``)
with its compute in f32, so that 1e-5 means something.
"""
import json
import os
import subprocess
import sys
import textwrap
from functools import lru_cache

import jax
import numpy as np
import pytest
import torch

import repro.compat  # noqa: F401  (jax version shims)
from repro import configs as jconfigs
from repro.models import build_model as jbuild
from repro_torch import configs
from repro_torch.distributed import compression, sharding
from repro_torch.models.model import Model

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
DS_OVERRIDES = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                    head_dim=16, d_ff=64, vocab_size=512,
                    compute_dtype="float32")
MESHES = {"16x16": (("data", 16), ("model", 16)),
          "2x16x16": (("pod", 2), ("data", 16), ("model", 16))}


# ---------------------------------------------------------------------------
# child processes
# ---------------------------------------------------------------------------

def _env(**extra):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu", **extra)
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


REFERENCE = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
import repro.compat  # noqa: F401
from jax.sharding import Mesh, PartitionSpec as P
from repro import configs
from repro.configs.base import MoEConfig
from repro.distributed.collectives import allgather_matmul
from repro.distributed.compression import compressed_psum
from repro.models import moe, build_model
out = {}
# expert parallelism on a (2, 4) mesh, as tests/test_distributed.py
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
m = MoEConfig(num_experts=8, top_k=2, expert_d_ff=16, capacity_factor=0.0)
p = moe.init_moe(jax.random.PRNGKey(0), 32, m, jnp.float32)
x = jax.random.normal(jax.random.PRNGKey(1), (64, 32))
def body(router, wg, wu, wd, xt):
    prm = {"router": router, "w_gate": wg, "w_up": wu, "w_down": wd}
    y, aux = moe.moe_routed(prm, xt, m, ep_axis="model")
    return y, jax.lax.pmean(aux, ("data",))
fn = jax.jit(jax.shard_map(body, mesh=mesh,
             in_specs=(P(), P("model"), P("model"), P("model"),
                       P(("data",), None)),
             out_specs=(P(("data",), None), P()), check_vma=False))
y, aux = fn(p["router"], p["w_gate"], p["w_up"], p["w_down"], x)
for k, v in p.items():
    out["ep_" + k] = np.asarray(v)
out["ep_x"], out["ep_y"], out["ep_aux"] = np.asarray(x), np.asarray(y), \\
    np.asarray(aux)
# compressed_psum and the collective matmul on 4 devices
mesh4 = Mesh(np.array(jax.devices()[:4]), ("data",))
g = np.random.default_rng(0).standard_normal((4, 128)).astype(np.float32)
def cp(gl):
    return tuple(compressed_psum(gl, "data", s)
                 for s in ("fp32", "bf16", "int8"))
res = jax.jit(jax.shard_map(cp, mesh=mesh4, in_specs=P("data"),
                            out_specs=(P("data"),) * 3, check_vma=False))(g)
out["cp_g"] = g
for s, r in zip(("fp32", "bf16", "int8"), res):
    out["cp_" + s] = np.asarray(r)[0]
rng = np.random.default_rng(1)
ax = rng.standard_normal((8, 64)).astype(np.float32)
aw = rng.standard_normal((64, 24)).astype(np.float32)
agm = jax.jit(jax.shard_map(lambda xx, ws: allgather_matmul(xx, ws, "data"),
              mesh=mesh4, in_specs=(P(), P("data")), out_specs=P(),
              check_vma=False))(ax, aw)
out["ag_x"], out["ag_w"], out["ag_y"] = ax, aw, np.asarray(agm)
# the reduced DeepSeekMoE-16B: params and its single-device loss
import dataclasses
cfg = dataclasses.replace(configs.get("deepseek-moe-16b"), **OVERRIDES)
model = build_model(cfg)
params = model.init(jax.random.PRNGKey(0))
rng = np.random.default_rng(2)
tok = rng.integers(0, 512, (16, 128)).astype(np.int32)
lab = rng.integers(0, 512, (16, 128)).astype(np.int32)
loss, _ = jax.jit(model.loss)(params, {"tokens": tok, "labels": lab})
flat, _ = jax.tree_util.tree_flatten_with_path(params)
for path, leaf in flat:
    out["ds." + ".".join(str(getattr(k, "key", k)) for k in path)] = \\
        np.asarray(leaf)
out["ds_tokens"], out["ds_labels"] = tok, lab
out["ds_loss"] = np.asarray(loss)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's outputs, from one child with 8 XLA host devices."""
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    code = "OVERRIDES = " + repr(DS_OVERRIDES) + "\n" + REFERENCE
    res = subprocess.run(
        [sys.executable, "-c", code, str(path)], capture_output=True,
        text=True, timeout=600,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8"))
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(path))


HEADER = """
import json, sys
import numpy as np, torch, torch.distributed as dist
rank, world, init, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world)
ref = dict(np.load(sys.argv[5])) if len(sys.argv) > 5 else {}
out = {}
def t(a):
    return torch.from_numpy(np.array(a))
"""
FOOTER = """
if rank == 0:
    with open(out_dir + "/out.json", "w") as f:
        json.dump(out, f)
dist.barrier()
dist.destroy_process_group()
"""


def run_ranks(tmp_path, n: int, code: str, ref_path=None) -> dict:
    """Run ``code`` on ``n`` gloo ranks (child processes meeting through a
    ``file://`` store in ``tmp_path``); returns rank 0's ``out``."""
    script = tmp_path / "worker.py"
    script.write_text(HEADER + textwrap.dedent(code) + FOOTER)
    args = [str(n), str(tmp_path / "pg"), str(tmp_path)]
    if ref_path is not None:
        args.append(str(ref_path))
    procs = [subprocess.Popen([sys.executable, str(script), str(r), *args],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=_env(OMP_NUM_THREADS="1"))
             for r in range(n)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    failed = [f"rank {r}:\n{log[-3000:]}" for r, (p, log)
              in enumerate(zip(procs, logs)) if p.returncode]
    assert not failed, "\n".join(failed)
    return json.loads((tmp_path / "out.json").read_text())


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

class _FakeMesh:
    def __init__(self, name):
        self.axis_names = tuple(a for a, _ in MESHES[name])
        self.shape = dict(MESHES[name])


@lru_cache(maxsize=None)
def _param_trees(arch):
    """(reference's eval_shape tree, port's init tree drawn under
    FakeTensorMode): shapes only."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    want = jax.eval_shape(jbuild(jconfigs.get(arch)).init,
                          jax.random.PRNGKey(0))
    with FakeTensorMode():
        mine = Model(configs.get(arch), device="cpu").init(
            torch.Generator().manual_seed(0))
    return want, mine


def _ref_specs(tree_specs) -> list:
    from jax.sharding import PartitionSpec as P
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree_specs, is_leaf=lambda x: isinstance(x, P))]


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(configs.available()))
def test_param_specs_match_reference(arch, mesh, fsdp):
    """Every leaf's spec equals ``tuple(PartitionSpec)`` of the reference's
    ``ShardingRules.spec_for`` on the same (full-size) shapes."""
    from repro.distributed.sharding import ShardingRules as JRules
    want, mine = _param_trees(arch)
    got = [s for _, s in sharding.flatten_with_path(
        sharding.ShardingRules(_FakeMesh(mesh), fsdp=fsdp).tree(mine))]
    assert got == _ref_specs(JRules(_FakeMesh(mesh), fsdp=fsdp).tree(want))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "zamba2-7b",
                                  "seamless-m4t-medium", "llama3-405b"])
def test_decode_cache_specs_match_reference(arch, mesh):
    """``batch_specs`` of the decode_32k cache and batch equal the
    reference's ``batch_shardings`` (on an abstract mesh of the same
    shape)."""
    from repro.distributed.sharding import batch_shardings as jbatch
    from repro_torch.configs.base import SHAPES_BY_NAME
    shape = SHAPES_BY_NAME["decode_32k"]
    amesh = jax.sharding.AbstractMesh(
        tuple(n for _, n in MESHES[mesh]), tuple(a for a, _ in MESHES[mesh]))
    want = jbuild(jconfigs.get(arch)).input_specs(shape)
    mine = Model(configs.get(arch), device="meta").input_specs(shape)
    for key in ("_cache", None):
        w = want.pop(key) if key else want
        g = mine.pop(key) if key else mine
        ref_specs = [tuple(s.spec) for s in jax.tree_util.tree_leaves(
            jbatch(amesh, w, shape.global_batch))]
        got = [s for _, s in sharding.flatten_with_path(sharding.batch_specs(
            _FakeMesh(mesh), g, shape.global_batch))]
        assert got == ref_specs


def test_large_params_are_model_sharded():
    """Mirror of the reference's test on llama3-405b at (16, 16)."""
    _, mine = _param_trees("llama3-405b")
    spec = sharding.ShardingRules(_FakeMesh("16x16")).tree(mine)
    assert spec["blocks"]["attn"]["w_q"] == (None, "data", "model")
    assert spec["blocks"]["mlp"]["w_down"] == (None, "model", "data")
    assert spec["embed"] == ("model", None)


def test_placements_of_a_multi_axis_dim():
    """A dim over ("pod", "data") is Shard(d) on both mesh dims, major to
    minor; axes out of mesh order raise."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = _FakeMesh("2x16x16")
    assert sharding.placements((None, ("pod", "data"), "model"), mesh) == (
        Shard(1), Shard(1), Shard(2))
    assert sharding.placements((None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        sharding.placements((("data", "pod"),), mesh)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def test_quantize_int8_bit_equal_to_reference():
    from repro.distributed.compression import (dequantize_int8 as jdeq,
                                               quantize_int8 as jq)
    g = np.random.default_rng(3).standard_normal((64, 33)).astype(
        np.float32) * 3
    q, s = compression.quantize_int8(torch.from_numpy(g))
    jqq, js = jq(jax.numpy.asarray(g))
    assert np.array_equal(q.numpy(), np.asarray(jqq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    back = compression.dequantize_int8(q, s)
    assert back.numpy().tobytes() == np.asarray(jdeq(jqq, js)).tobytes()


def test_error_feedback_converges():
    """Mirror of the reference's: SGD with aggressive int8 compression and
    error feedback still converges on a quadratic."""
    target = torch.from_numpy(
        np.random.default_rng(0).standard_normal(32).astype(np.float32))
    w = torch.zeros(32)
    residual = compression.ErrorFeedback.init((w,))

    def compress(g):
        q, s = compression.quantize_int8(g)
        return compression.dequantize_int8(q, s)

    for _ in range(200):
        g = 2 * (w - target)
        (cg,), residual = compression.ErrorFeedback.apply((g,), residual,
                                                          compress)
        w = w - 0.05 * cg
    assert float((w - target).abs().max()) < 1e-2


def test_error_feedback_keeps_tree_order():
    tree = {"b": [torch.ones(2), torch.zeros(3)], "a": torch.full((1,), 2.)}
    res = compression.ErrorFeedback.init(tree)
    out, new = compression.ErrorFeedback.apply(tree, res, lambda g: g * 0.5)
    assert torch.equal(out["a"], torch.ones(1))
    assert torch.equal(new["b"][0], torch.full((2,), 0.5))
    assert list(out) == ["b", "a"]


def test_bytes_for_scheme():
    from repro.distributed.compression import bytes_for_scheme as jbytes
    for s in ("fp32", "bf16", "int8"):
        assert compression.bytes_for_scheme(1000, s) == jbytes(1000, s)


# ---------------------------------------------------------------------------
# 4 gloo ranks: compressed_psum, allgather_matmul, kernels under a mesh,
# the collective counter
# ---------------------------------------------------------------------------

GLOO4 = """
from repro_torch.distributed.collectives import allgather_matmul
from repro_torch.distributed.compression import (compressed_psum,
    dequantize_int8, quantize_int8)
from repro_torch.distributed import sharding
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.roofline.counting import CollectiveCounter
g = t(ref["cp_g"])[rank]
for s in ("fp32", "bf16", "int8"):
    out["cp_" + s] = compressed_psum(g, None, s).tolist()
w = t(ref["ag_w"])
k = w.shape[0] // world
out["ag_y"] = allgather_matmul(t(ref["ag_x"]), w[rank * k:(rank + 1) * k],
                               None).tolist()
# the model's blocks with impl="kernel" on DTensor activations of a (2, 2)
# mesh: each kernel entry point is reached inside the block's local_map with
# plain local tensors, and each rank's call returns its slice of the
# unsharded call's result. Inputs and projections are multiples of 1/8 and
# small, so that the projections are exact in any order of summation and
# the kernels' inputs on a rank are bit-equal slices of the unsharded ones.
from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import ops
from repro_torch.models import attention, ssm
mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
calls = {"fa": [], "ssd": []}
for key, attr in (("fa", "flash_attention"), ("ssd", "ssd")):
    def spy(*a, _real=getattr(ops, attr), _key=key, **kw):
        res = _real(*a, **kw)
        calls[_key].append((type(a[0]).__name__, res))
        return res
    setattr(ops, attr, spy)
gen = torch.Generator().manual_seed(0)
eighths = lambda t: torch.round(t * 8) / 8  # noqa: E731
rep = lambda t: sharding.local_shard(  # noqa: E731
    t, mesh, sharding.dim_placements(mesh))
rows = lambda t: sharding.local_shard(  # noqa: E731
    t, mesh, sharding.dim_placements(mesh, data=0))
di, mi = mesh.get_local_rank("data"), mesh.get_local_rank("model")
mine = lambda t, hdim: t[2 * di:2 * di + 2].narrow(  # noqa: E731
    hdim, mi * (t.shape[hdim] // 2), t.shape[hdim] // 2)
pos = torch.arange(16)[None].expand(4, 16)
for key, kv in (("fa", 2), ("fa_query_heads", 1)):
    ap = {k: eighths(w) for k, w in attention.init_attention(
        gen, 32, 4, kv, 16, torch.float32).items()}
    x = eighths(torch.randn(4, 16, 32, generator=gen))
    kw = dict(num_heads=4, num_kv_heads=kv, head_dim=16, rope_theta=1e4,
              impl="kernel")
    calls["fa"].clear()
    want, _ = attention.attention_block(ap, x, positions=pos, **kw)
    (_, full), = calls["fa"]
    calls["fa"].clear()
    got, _ = attention.attention_block(
        {k: rep(w) for k, w in ap.items()}, rows(x), positions=rows(pos),
        **kw)
    (kind, local), = calls["fa"]
    out[key + "_local"] = kind
    out[key + "_err"] = float((local - mine(full, 2)).abs().max())
    out[key + "_block_err"] = float((got.full_tensor() - want).abs().max())
s = SSMConfig(state_dim=8, head_dim=16, expand=2, chunk_size=8)
mp = {k: eighths(w) if k.startswith("w_") else w
      for k, w in ssm.init_mamba2(gen, 32, s, torch.float32).items()}
x = eighths(torch.randn(4, 32, 32, generator=gen))
calls["ssd"].clear()
wy, wst = ssm.mamba2_block(mp, x, 32, s, impl="kernel")
(_, (fy, fst)), = calls["ssd"]
calls["ssd"].clear()
y, st = ssm.mamba2_block({k: rep(w) for k, w in mp.items()}, rows(x), 32, s,
                         impl="kernel")
(kind, (ly, lst)), = calls["ssd"]
out["ssd_local"] = kind
out["ssd_err"] = max(float((ly - mine(fy, 2)).abs().max()),
                     float((lst - mine(fst, 1)).abs().max()))
out["ssd_block_err"] = max(float((y.full_tensor() - wy).abs().max()),
                           float((st.full_tensor() - wst).abs().max()))
# a Mamba2 block of 3 heads, which "model" (2) does not divide, and an
# in-projection 115 wide: each rank scans its own 2 heads (rank 1's second
# a padding head) and the in-projection is split over "model" along its
# contraction; the block's output, final state and gradients by
# torch.autograd against the same block unsharded
s3 = SSMConfig(state_dim=8, head_dim=16, expand=2, chunk_size=8)
mp3 = {k: eighths(w) if k.startswith("w_") else w
       for k, w in ssm.init_mamba2(gen, 24, s3, torch.float32).items()}
x3 = eighths(torch.randn(4, 32, 24, generator=gen))
gy3 = eighths(torch.randn(4, 32, 24, generator=gen))
plain3 = {k: w.clone().requires_grad_(True) for k, w in mp3.items()}
wy, wst = ssm.mamba2_block(plain3, x3, 24, s3, impl="chunked")
want = torch.autograd.grad((wy * gy3).sum(), list(plain3.values()))
dp3 = {k: rep(w).requires_grad_(True) for k, w in mp3.items()}
y, st = ssm.mamba2_block(dp3, rows(x3), 24, s3, impl="chunked")
got = torch.autograd.grad((y * rows(gy3)).sum(), list(dp3.values()))
out["ssd_split_heads_block_err"] = max(
    float((y.full_tensor() - wy).abs().max()),
    float((st.full_tensor() - wst).abs().max()))
out["ssd_split_heads_grad_rel"] = max(
    float((g.full_tensor() - w).abs().max() / w.abs().max())
    for g, w in zip(got, want))
# an attention block of 6 query heads on 2 KV heads under a "model" axis
# of 4 (which divides neither): at batch 2 each rank attends with its share
# of 2 query heads (rank 1's span both KV groups, rank 3's are padding), at
# batch 4 each rank attends with every head for its own row; the output and
# the gradients of x and every weight by torch.autograd against the same
# block unsharded, and at batch 2 a prefill into a KV cache and a decode
# step
m4 = make_mesh((1, 4), ("data", "model"), device_type="cpu")
rep4 = lambda t: sharding.local_shard(  # noqa: E731
    t, m4, sharding.dim_placements(m4))
ap6 = attention.init_attention(gen, 24, 6, 2, 8, torch.float32)
kw6 = dict(num_heads=6, num_kv_heads=2, head_dim=8, rope_theta=1e4,
           impl="kernel")
for B in (2, 4):
    x6 = torch.randn(B, 12, 24, generator=gen)
    gy6 = torch.randn(B, 12, 24, generator=gen)
    pos6 = torch.arange(12)[None].expand(B, 12)
    plain6 = {k: w.clone().requires_grad_(True) for k, w in ap6.items()}
    xp6 = x6.clone().requires_grad_(True)
    want, _ = attention.attention_block(plain6, xp6, positions=pos6, **kw6)
    wg = torch.autograd.grad((want * gy6).sum(), [*plain6.values(), xp6])
    dp6 = {k: rep4(w).requires_grad_(True) for k, w in ap6.items()}
    xd6 = rep4(x6).requires_grad_(True)
    got, _ = attention.attention_block(dp6, xd6, positions=rep4(pos6), **kw6)
    gg = torch.autograd.grad((got * rep4(gy6)).sum(), [*dp6.values(), xd6])
    out[f"heads6_b{B}_err"] = float((got.full_tensor() - want).abs().max())
    out[f"heads6_b{B}_grad_rel"] = max(
        float((g.full_tensor() - w).abs().max() / w.abs().max())
        for g, w in zip(gg, wg))
cache6 = attention.init_kv_cache(2, 16, 2, 8, torch.float32)
dcache6 = sharding.distribute_local(
    attention.init_kv_cache(2, 16, 2, 8, torch.float32), m4,
    sharding.batch_shardings(m4, cache6, 2))
errs = []
with torch.no_grad():
    for S, p0 in ((12, 0), (1, 12)):
        x6 = torch.randn(2, S, 24, generator=gen)
        pos6 = p0 + torch.arange(S)[None].expand(2, S)
        want, _ = attention.attention_block(ap6, x6, positions=pos6,
                                            kv_cache=cache6, **kw6)
        got, _ = attention.attention_block(
            {k: rep4(w) for k, w in ap6.items()}, rep4(x6),
            positions=rep4(pos6), kv_cache=dcache6, **kw6)
        errs.append(float((got.full_tensor() - want).abs().max()))
errs.append(float((dcache6["k"].full_tensor() - cache6["k"]).abs().max()))
out["heads6_cache_errs"] = errs
# a Mamba2 model of 10 layers and 8 heads on the (2, 2) mesh: the specs'
# fallback rule shards its (10, 8) leaves A_log, dt_bias and D along their
# layer dim; its loss and gradients by torch.autograd against the same
# model unsharded by torch.func
import dataclasses
from repro_torch import configs
from repro_torch.launch.train import mesh_grads
from repro_torch.models.model import Model
from repro_torch.models.transformer import ParallelCtx
mcfg = dataclasses.replace(
    configs.get("mamba2-130m").reduced(), num_layers=10, d_model=32,
    ssm=SSMConfig(state_dim=8, head_dim=8, expand=2, chunk_size=8))
mplain = Model(mcfg, device="cpu")
mparams = mplain.init(torch.Generator().manual_seed(1))
mbatch = {k: torch.randint(0, mcfg.vocab_size, (4, 16), generator=gen)
          for k in ("tokens", "labels")}
want_loss = float(mplain.loss(mparams, mbatch)[0])
want_g = torch.func.grad(lambda p: mplain.loss(p, mbatch)[0])(mparams)
mshard = sharding.param_shardings(mesh, mparams)
out["layers_sharded"] = [p.is_shard(0) for p in mshard["blocks"]["mamba"][
    "A_log"]]
smodel = Model(mcfg, ParallelCtx(mesh=mesh), device="cpu")
got_g, metrics = mesh_grads(
    smodel.loss, sharding.distribute_local(mparams, mesh, mshard),
    sharding.distribute_local(mbatch, mesh, sharding.batch_shardings(
        mesh, mbatch, 4)))
from repro_torch.core import packing
out["layers_loss_err"] = abs(float(metrics["loss"].full_tensor())
                             - want_loss)
out["layers_grad_rel"] = max(
    float((a.full_tensor() - b).abs().max() / b.abs().max().clamp_min(1e-30))
    for a, b in zip(packing.tree_leaves(got_g), packing.tree_leaves(want_g)))
# the collective counter on hand-built collectives
from torch.distributed.tensor import Partial, Replicate, Shard
cc = CollectiveCounter()
with cc:
    a = torch.ones(3, 5)
    dist.all_reduce(a, group=mesh.get_group("model"))
    d = sharding.local_shard(torch.ones(8, 6), mesh, [Shard(0), Replicate()])
    d.redistribute(mesh, [Replicate(), Replicate()])
    pd = sharding.local_shard(torch.ones(8, 6), mesh, [Replicate(),
                                                        Replicate()])
    from torch.distributed.tensor import DTensor
    part = DTensor.from_local(torch.ones(8, 6), mesh,
                              [Replicate(), Partial()], run_check=False)
    part.redistribute(mesh, [Replicate(), Shard(0)])
    allgather_matmul(torch.ones(2, 8), torch.ones(2, 3), None)
out["coll"] = [[op.kind, op.result_bytes, op.group_size, op.operand_bytes,
                op.traffic_bytes] for op in cc.ops]
out["coll_causes"] = cc.causes
# the reduced Zamba2-7B (Mamba2 blocks, the shared attention block, a
# tail) on the mesh with FSDP params: prefill, then two decode steps
from repro_torch import configs
from repro_torch.models.model import Model
from repro_torch.models.transformer import ParallelCtx
cfg = configs.get("zamba2-7b").reduced()
plain = Model(cfg, ParallelCtx(attn_impl="kernel"), device="cpu")
params = plain.init(torch.Generator().manual_seed(0))
sharded = Model(cfg, ParallelCtx(mesh=mesh, attn_impl="kernel"),
                device="cpu")
dparams = sharding.distribute_local(params, mesh, sharding.param_shardings(
    mesh, params))
place = lambda b: sharding.distribute_local(  # noqa: E731
    b, mesh, sharding.batch_shardings(mesh, b, 4))
batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 16), generator=gen)}
want, cache = plain.prefill(params, batch, 32)
got, dcache = sharded.prefill(dparams, place(batch), 32)
errs = [float((got.full_tensor() - want).abs().max())]
for i in range(2):
    step = {"tokens": torch.randint(0, cfg.vocab_size, (4, 1), generator=gen),
            "pos": torch.full((4,), 16 + i)}
    want, cache = plain.decode_step(params, step, cache)
    got, dcache = sharded.decode_step(dparams, place(step), dcache)
    errs.append(float((got.full_tensor() - want).abs().max()))
out["hybrid_errs"] = errs
# reduced Mamba2 models on the mesh with FSDP params: prefill, then two
# decode steps, with 8 heads ("model" divides them) and with 3 (it does
# not); every cache write of a decode step has the placements of the cache
# leaf it lands in (nothing re-laid out), and the cache keeps prefill's
from repro_torch.models import transformer as tf
writes = []
real_write = tf._write

def spy_write(cache, new):
    writes.append([(d.placements, s.placements) for d, s in zip(
        packing.tree_leaves(cache), packing.tree_leaves(new))])
    return real_write(cache, new)
for name, d, hd in (("even", 32, 8), ("odd", 24, 16)):
    scfg = dataclasses.replace(
        configs.get("mamba2-130m").reduced(), d_model=d,
        ssm=SSMConfig(state_dim=8, head_dim=hd, expand=2, chunk_size=8))
    splain = Model(scfg, ParallelCtx(attn_impl="kernel"), device="cpu")
    sparams = splain.init(torch.Generator().manual_seed(2))
    smesh = Model(scfg, ParallelCtx(mesh=mesh, attn_impl="kernel"),
                  device="cpu")
    sdp = sharding.distribute_local(sparams, mesh, sharding.param_shardings(
        mesh, sparams))
    batch = {"tokens": torch.randint(0, scfg.vocab_size, (4, 16),
                                     generator=gen)}
    with torch.no_grad():
        want, cache = splain.prefill(sparams, batch, 32)
        got, dcache = smesh.prefill(sdp, place(batch), 32)
        after_prefill = [c.placements for c in packing.tree_leaves(dcache)]
        errs = [float((got.full_tensor() - want).abs().max())]
        writes.clear()
        for i in range(2):
            step = {"tokens": torch.randint(0, scfg.vocab_size, (4, 1),
                                            generator=gen),
                    "pos": torch.full((4,), 16 + i)}
            want, cache = splain.decode_step(sparams, step, cache)
            tf._write = spy_write
            try:
                got, dcache = smesh.decode_step(sdp, place(step), dcache)
            finally:
                tf._write = real_write
            errs.append(float((got.full_tensor() - want).abs().max()))
    errs += [float((a.full_tensor() - b).abs().max()) for a, b in zip(
        packing.tree_leaves(dcache), packing.tree_leaves(cache))]
    out[f"ssm_{name}_heads"] = scfg.ssm.expand * d // hd
    out[f"ssm_{name}_errs"] = errs
    out[f"ssm_{name}_writes_kept"] = bool(writes) and all(
        a == b for w in writes for a, b in w)
    out[f"ssm_{name}_cache_kept"] = after_prefill == [
        c.placements for c in packing.tree_leaves(dcache)]
"""


@pytest.fixture(scope="module")
def gloo4(ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo4")
    np.savez(tmp / "ref.npz", **{k: v for k, v in ref.items()
                                 if k.startswith(("cp_", "ag_"))})
    return run_ranks(tmp, 4, GLOO4, tmp / "ref.npz")


def test_compressed_psum_on_4_ranks(ref, gloo4):
    """int8 bit-equal to the reference's on 4 devices (the same scale,
    integer sums); fp32 within 1e-6; bf16 within the reference test's 0.02
    of the exact sum, with its distance to the reference's printed."""
    exact = ref["cp_g"].astype(np.float64).sum(0)
    i8 = np.asarray(gloo4["cp_int8"], np.float32)
    assert i8.tobytes() == ref["cp_int8"].tobytes()
    np.testing.assert_allclose(gloo4["cp_fp32"], ref["cp_fp32"], atol=1e-6,
                               rtol=0)
    b16 = np.asarray(gloo4["cp_bf16"])
    scale = np.abs(exact).max()
    assert np.abs(b16 - exact).max() / scale < 0.02
    print("bf16 psum: max |port - reference| =",
          float(np.abs(b16 - ref["cp_bf16"]).max()))


def test_allgather_matmul_on_4_ranks(ref, gloo4):
    y = np.asarray(gloo4["ag_y"])
    np.testing.assert_allclose(y, ref["ag_x"] @ ref["ag_w"], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(y, ref["ag_y"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("kernel", ["fa", "fa_query_heads", "ssd"])
def test_kernels_under_a_mesh(gloo4, kernel):
    """``attention_block`` and the Mamba2 block with ``impl="kernel"`` on
    DTensor activations of a (2, 2) mesh (batch over "data", heads over
    "model": all heads where the KV heads divide, the query heads alone
    where they do not) reach ``ops.flash_attention`` and ``ops.ssd`` once,
    with plain local tensors inside the block's ``local_map``; each rank's
    call returns exactly its slice of the unsharded call's result, and the
    block's output is within 1e-5 of the unsharded block's (its last
    projection sums over the ranks' heads in another order)."""
    assert gloo4[kernel + "_local"] == "Tensor"
    assert gloo4[kernel + "_err"] == 0.0, gloo4[kernel + "_err"]
    assert gloo4[kernel + "_block_err"] < 1e-5, gloo4[kernel + "_block_err"]


def test_mamba2_block_with_heads_model_does_not_divide(gloo4):
    """A Mamba2 block of 3 heads on a (2, 2) mesh, each "model" rank
    scanning its own share of the heads (``ssm._scan_split_heads``) and
    its in-projection, whose output "model" does not divide, split along
    its contraction (``sharding.split_contraction``): the output and the
    final state within 1e-5 of the unsharded block's, and the gradients of
    every parameter by ``torch.autograd`` within 1e-5 of each one's
    largest entry (sums over the ranks in other orders)."""
    assert gloo4["ssd_split_heads_block_err"] < 1e-5, gloo4[
        "ssd_split_heads_block_err"]
    assert gloo4["ssd_split_heads_grad_rel"] < 1e-5, gloo4[
        "ssd_split_heads_grad_rel"]


@pytest.mark.parametrize("batch", [2, 4])
def test_attention_with_heads_model_does_not_divide(gloo4, batch):
    """An attention block of 6 query heads on 2 KV heads under a "model"
    axis of 4 on a (1, 4) mesh: at batch 2 each rank attends with its own
    share of 2 query heads (``attention._head_share``; rank 1's read both
    KV heads, rank 3's are padding), at batch 4 with every head for its own
    row (``attention._rows_over_model``). The output within 1e-5 of the
    unsharded block's, and the gradients of x and every weight by
    ``torch.autograd`` within 1e-5 of each one's largest entry, in f32
    (C24)."""
    assert gloo4[f"heads6_b{batch}_err"] < 1e-5, gloo4[
        f"heads6_b{batch}_err"]
    assert gloo4[f"heads6_b{batch}_grad_rel"] < 1e-5, gloo4[
        f"heads6_b{batch}_grad_rel"]


def test_attention_with_heads_model_does_not_divide_fills_a_cache(gloo4):
    """The same block at batch 2 prefills a ring KV cache (replicated over
    "model": 4 ranks do not divide its 2 KV heads) and takes a decode step
    from it: both outputs and the cache within 1e-5 of the unsharded
    block's."""
    assert max(gloo4["heads6_cache_errs"]) < 1e-5, gloo4["heads6_cache_errs"]


def test_layer_dim_sharded_leaf_on_a_mesh(gloo4):
    """A Mamba2 model of 10 layers and 8 heads on the (2, 2) mesh, whose
    (10, 8) leaves the specs shard along their layer dim over "model": its
    loss within 1e-5 of the unsharded model's and its gradients by
    ``torch.autograd`` within 1e-5 of each leaf's largest entry
    (``transformer._unbindable``; DTensor refused the layers' unbind,
    C23)."""
    assert gloo4["layers_sharded"] == [False, True]
    assert gloo4["layers_loss_err"] < 1e-5, gloo4["layers_loss_err"]
    assert gloo4["layers_grad_rel"] < 1e-5, gloo4["layers_grad_rel"]


def test_hybrid_model_serves_on_a_mesh(gloo4):
    """The reduced Zamba2-7B on a (2, 2) mesh with FSDP params (the
    causal conv, the scan, the shared attention block and its ring cache
    under ``local_map``): prefill and two decode steps within 1e-5 of the
    same model unsharded (sums over the ranks in other orders)."""
    assert max(gloo4["hybrid_errs"]) < 1e-5, gloo4["hybrid_errs"]


@pytest.mark.parametrize("heads", ["even", "odd"])
def test_mamba2_model_decodes_on_a_mesh(gloo4, heads):
    """A reduced Mamba2 on a (2, 2) mesh with FSDP params, with 8 heads
    ("model" divides them) and with 3 (``ssm._state_step_on_mesh`` then
    keeps the state whole over "model" and reads out each rank's share of
    the heads): prefill and two decode steps within 1e-5 of the same model
    unsharded, and so is the cache after them; each decode step's new
    state has its cache leaf's placements (no write re-lays the cache out),
    and the cache keeps prefill's placements."""
    assert gloo4[f"ssm_{heads}_heads"] == (8 if heads == "even" else 3)
    errs = gloo4[f"ssm_{heads}_errs"]
    assert max(errs) < 1e-5, errs
    assert gloo4[f"ssm_{heads}_writes_kept"]
    assert gloo4[f"ssm_{heads}_cache_kept"]


def test_collective_counter_kinds_and_bytes(gloo4):
    """The counter's records on a 4-rank (2, 2) mesh: an all-reduce of
    (3, 5) f32 over "model", DTensor's all-gather of (8, 6) f32 over
    "data" and reduce-scatter of (8, 6) f32 over "model", and the ring's
    send of its (2, 3) shard, with ``CollectiveOp``'s rules."""
    from repro.roofline.analysis import CollectiveOp as JOp
    want = [["all-reduce", 60, 2], ["all-gather", 192, 2],
            ["reduce-scatter", 96, 2], ["collective-permute", 24, 4],
            ["collective-permute", 24, 4], ["collective-permute", 24, 4]]
    got = gloo4["coll"]
    assert [c[:3] for c in got] == want
    for kind, rb, gs, operand, traffic in got:
        j = JOp(kind, rb, gs)
        assert (operand, traffic) == (j.operand_bytes, j.traffic_bytes)
    assert gloo4["coll_causes"][0] == ""


def test_collective_parser():
    """Mirror of ``tests/test_integration.py::test_collective_parser``."""
    from repro_torch.roofline.analysis import parse_collectives
    hlo = """
  %all-reduce.1 = f32[512,1024]{1,0} all-reduce(%x), channel_id=1, replica_groups=[4,2]<=[8], use_global_device_ids=true
  %ag = bf16[64,256]{1,0} all-gather(%y), replica_groups=[2,4]<=[8], dimensions={0}
  %done = f32[4]{0} all-gather-done(%h)
"""
    ops = parse_collectives(hlo)
    assert sorted(o.kind for o in ops) == ["all-gather", "all-reduce"]
    ar = next(o for o in ops if o.kind == "all-reduce")
    assert ar.result_bytes == 512 * 1024 * 4 and ar.group_size == 2
    ag = next(o for o in ops if o.kind == "all-gather")
    assert ag.operand_bytes == 64 * 256 * 2 // 4


def test_dtensor_at_a_kernel_wrapper_raises(tmp_path):
    """A DTensor reaching a kernel's wrapper, or the dispatch entry points
    in front of them, raises: it never runs the kernel (or its plain
    version) on a quietly replicated copy."""
    import torch.distributed as dist
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_rmsnorm, ops, packed_gemm, ssd_scan
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        d = sharding.local_shard(torch.ones(1, 8, 2, 16), mesh,
                                 sharding.dim_placements(mesh))
        w = sharding.local_shard(torch.ones(1, 16, 16), mesh,
                                 sharding.dim_placements(mesh))
        for call in (lambda: fa.flash_attention_cuda(d, d, d),
                     lambda: fa.flash_attention_fwd(d, d, d),
                     lambda: packed_gemm.packed_gemm_cuda(w, w),
                     lambda: packed_gemm.packed_gemm(w, w),
                     lambda: fused_rmsnorm.packed_rmsnorm(w, w[:, 0]),
                     lambda: fused_rmsnorm.fused_rmsnorm_cuda(w, w[0, 0]),
                     lambda: ssd_scan.ssd_scan_cuda(d, d, d, d, d),
                     lambda: ops.flash_attention(d, d, d),
                     lambda: ops.ssd(d, d[..., 0], d[0, 0, :, 0], d[..., 0, :],
                                     d[..., 0, :])):
            with pytest.raises(TypeError, match="DTensor"):
                call()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# 8 gloo ranks: expert parallelism and a sharded train step
# ---------------------------------------------------------------------------

GLOO8 = """
import dataclasses
from repro_torch import configs, optim
from repro_torch.configs.base import MoEConfig
from repro_torch.core import packing
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import make_train_step
from repro_torch.models import moe, transformer
from repro_torch.models.model import Model
from repro_torch.models.transformer import ParallelCtx
mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
pl = sharding.dim_placements
cfg = type("C", (), {})

def ep(p, x, m):
    cfg.moe = m
    pd = {k: sharding.local_shard(v, mesh, pl(mesh) if k == "router"
                                  else pl(mesh, model=0))
          for k, v in p.items()}
    xd = sharding.local_shard(x, mesh, pl(mesh, data=0))
    return pd, xd, ParallelCtx(mesh=mesh, ep=True)

def halves(p, x, m):
    # the unsharded routing of each data rank's tokens, aux averaged
    ya, aa = moe.moe_routed(p, x[:32], m)
    yb, ab = moe.moe_routed(p, x[32:], m)
    return torch.cat([ya, yb]), (aa + ab) / 2

p = {k: t(ref["ep_" + k]) for k in ("router", "w_gate", "w_up", "w_down")}
x = t(ref["ep_x"])
m = MoEConfig(num_experts=8, top_k=2, expert_d_ff=16, capacity_factor=0.0)
pd, xd, pctx = ep(p, x, m)
y, aux = transformer._ep_moe_call(pd, xd, cfg, pctx)
out["ep_y"], out["ep_aux"] = y.full_tensor().tolist(), float(
    aux.full_tensor())
# with a capacity that drops
md = dataclasses.replace(m, capacity_factor=0.5)
pd, xd, pctx = ep(p, x, md)
y, aux = transformer._ep_moe_call(pd, xd, cfg, pctx)
wy, waux = halves(p, x, md)
out["drop_err"] = max(float((y.full_tensor() - wy).abs().max()),
                      abs(float(aux.full_tensor()) - float(waux)))
out["drop_dense_gap"] = float((moe.moe_dense_oracle(p, x, md)[0]
                               - wy).abs().max())
# the gradient of a loss through EP against the unsharded one
leaves = {k: v.detach().requires_grad_() for k, v in pd.items()}
xl = xd.detach().requires_grad_()
y, aux = transformer._ep_moe_call(leaves, xl, cfg, pctx)
grads = torch.autograd.grad((y * y).sum() + 0.1 * aux,
                            [*leaves.values(), xl])
def loss_ref(p, x):
    y, aux = halves(p, x, md)
    return (y * y).sum() + 0.1 * aux
gp, gx = torch.func.grad(loss_ref, argnums=(0, 1))(p, x)
out["grad_rel"] = max(
    float((g.full_tensor() - w).abs().max() / w.abs().max())
    for g, w in zip(grads, [*(gp[k] for k in leaves), gx]))
# a sharded train step of the reduced DeepSeekMoE-16B against the same
# step unsharded (each data rank's batch half routed alone)
over = OVERRIDES
mcfg = dataclasses.replace(configs.get("deepseek-moe-16b"), **over)
flat = {k[3:]: v for k, v in ref.items() if k.startswith("ds.")}
def tree(like, path=()):
    if isinstance(like, dict):
        return {k: tree(v, path + (k,)) for k, v in like.items()}
    return t(flat[".".join(path)])
shapes = Model(mcfg, device="cpu").init(torch.Generator().manual_seed(0))
params = tree(shapes)
batch = {"tokens": t(ref["ds_tokens"]), "labels": t(ref["ds_labels"])}
opt = optim.adamw()
lr = torch.tensor(1e-3)
plain = Model(mcfg, device="cpu")
class Halves:
    def loss(self, p, b):
        la, ma = plain.loss(p, {k: v[:8] for k, v in b.items()})
        lb, mb = plain.loss(p, {k: v[8:] for k, v in b.items()})
        return (la + lb) / 2, {k: (ma[k] + mb[k]) / 2 for k in ma}
out["joint_loss"] = float(plain.loss(params, batch)[0])
step = make_train_step(Halves(), opt)
p1, o1, m1 = step(params, opt.init(params), batch, lr)
smodel = Model(mcfg, pctx=ParallelCtx(mesh=mesh, ep=True), device="cpu")
pls = sharding.param_shardings(mesh, params, fsdp=True)
dparams = sharding.distribute_local(params, mesh, pls)
dbatch = sharding.distribute_local(batch, mesh, sharding.batch_shardings(
    mesh, batch, 16))
dopt = opt.init(dparams)
sstep = make_train_step(smodel, opt)
p2, o2, m2 = sstep(dparams, dopt, dbatch, lr)
out["loss"] = float(m2["loss"].full_tensor())
out["loss_unsharded"] = float(m1["loss"])
out["placements_kept"] = all(
    a.placements == b.placements
    for a, b in zip(packing.tree_leaves(p2), packing.tree_leaves(dparams)))
# the gradients the step took, and the loss after its update
from repro_torch.launch.train import mesh_grads
g2, _ = mesh_grads(smodel.loss, dparams, dbatch)
g1 = torch.func.grad(lambda p, b: Halves().loss(p, b)[0])(params, batch)
out["step_grad_rel"] = max(
    float((a.full_tensor() - b).abs().max() / b.abs().max().clamp_min(1e-30))
    for a, b in zip(packing.tree_leaves(g2), packing.tree_leaves(g1)))
out["loss2"] = float(sstep(p2, o2, dbatch, lr)[2]["loss"].full_tensor())
out["loss2_unsharded"] = float(step(p1, o1, batch, lr)[2]["loss"])
# EP on a (2, 2, 2) ("pod", "data", "model") mesh, the experts split along
# their hidden dim over "pod" and "data" (FSDP) and gathered in one
# collective over the two: y, the router loss and the gradient of a loss
# against the unsharded routing of each of the 4 data ranks' tokens
mesh3 = make_mesh((2, 2, 2), ("pod", "data", "model"), device_type="cpu")
fs = ("pod", "data")
specs3 = {"router": (fs, None), "w_gate": ("model", None, fs),
          "w_up": ("model", None, fs), "w_down": ("model", fs, None)}
p3 = {k: sharding.local_shard(v, mesh3, sharding.placements(
    specs3[k], mesh3)).detach().requires_grad_() for k, v in p.items()}
x3 = sharding.local_shard(x, mesh3, pl(mesh3, data=0)).requires_grad_()
cfg.moe = m
y3, aux3 = transformer._ep_moe_call(p3, x3, cfg,
                                    ParallelCtx(mesh=mesh3, ep=True))
g3 = torch.autograd.grad((y3 * y3).sum() + 0.1 * aux3, [*p3.values(), x3])

def quarters(p, x):
    ys, auxs = zip(*(moe.moe_routed(p, c, m) for c in x.chunk(4)))
    return torch.cat(ys), sum(auxs) / 4

def loss_quarters(p, x):
    y, aux = quarters(p, x)
    return (y * y).sum() + 0.1 * aux
wy3, waux3 = quarters(p, x)
gp3, gx3 = torch.func.grad(loss_quarters, argnums=(0, 1))(p, x)
out["ep3_err"] = max(float((y3.full_tensor() - wy3).abs().max()),
                     abs(float(aux3.full_tensor()) - float(waux3)))
out["ep3_grad_rel"] = max(
    float((g.full_tensor() - w).abs().max() / w.abs().max())
    for g, w in zip(g3, [*(gp3[k] for k in p3), gx3]))
out["ep3_grad_placements"] = all(
    g.placements == q.placements for g, q in zip(g3, p3.values()))
# the reduced DeepSeekMoE-16B with 8 dropless experts 16 wide, serving on
# the (2, 2, 2) mesh under EP: prefill, then two decode steps routed row
# by row, as the server decodes, against the same model unsharded
dcfg = dataclasses.replace(mcfg, moe=dataclasses.replace(
    mcfg.moe, num_experts=8, top_k=2, expert_d_ff=16, capacity_factor=0.0))
dplain = Model(dcfg, device="cpu")
params = dplain.init(torch.Generator().manual_seed(3))
dsm = Model(dcfg, pctx=ParallelCtx(mesh=mesh3, ep=True), device="cpu")
dp3 = sharding.distribute_local(params, mesh3, sharding.param_shardings(
    mesh3, params))
place3 = lambda b: sharding.distribute_local(  # noqa: E731
    b, mesh3, sharding.batch_shardings(mesh3, b, 4))
gen = torch.Generator().manual_seed(3)
dbatch = {"tokens": torch.randint(0, 512, (4, 16), generator=gen)}
errs = []
with torch.no_grad():
    want, cache = dplain.prefill(params, dbatch, 32)
    got, dcache = dsm.prefill(dp3, place3(dbatch), 32)
    errs.append(float((got.full_tensor() - want).abs().max()))
    for i in range(2):
        step3 = {"tokens": torch.randint(0, 512, (4, 1), generator=gen),
                 "pos": torch.full((4,), 16 + i)}
        want, cache = dplain.decode_step(params, step3, cache,
                                         route_rows=True)
        got, dcache = dsm.decode_step(dp3, place3(step3), dcache,
                                      route_rows=True)
        errs.append(float((got.full_tensor() - want).abs().max()))
out["ep3_serve_errs"] = errs
"""


@pytest.fixture(scope="module")
def gloo8(ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo8")
    np.savez(tmp / "ref.npz", **{k: v for k, v in ref.items()
                                 if k.startswith(("ep_", "ds"))})
    return run_ranks(tmp, 8, "OVERRIDES = " + repr(DS_OVERRIDES) + "\n"
                     + GLOO8, tmp / "ref.npz")


def test_expert_parallelism_matches_reference_on_8_ranks(ref, gloo8):
    """EP on a (2, 4) mesh with the reference test's MoEConfig: y and the
    router loss averaged over "data" within 1e-4 of the reference's."""
    np.testing.assert_allclose(gloo8["ep_y"], ref["ep_y"], atol=1e-4,
                               rtol=0)
    assert abs(gloo8["ep_aux"] - float(ref["ep_aux"])) < 1e-4


def test_expert_parallelism_with_drops_equals_unsharded(gloo8):
    """With a capacity that drops (the dense oracle differs), EP equals the
    port's unsharded ``moe_routed`` of each data rank's tokens within
    1e-6."""
    assert gloo8["drop_dense_gap"] > 1e-3
    assert gloo8["drop_err"] < 1e-6


def test_expert_parallelism_gradient(gloo8):
    """The gradient of a loss through EP (router, experts, tokens) within
    1e-5 of the unsharded one, relative to each leaf's largest entry."""
    assert gloo8["grad_rel"] < 1e-5


def test_sharded_train_step_on_8_ranks(ref, gloo8):
    """The reduced DeepSeekMoE-16B's step on a (2, 4) mesh (FSDP params,
    EP experts, AdamW on the shards): its loss within 1e-5 of the same
    step unsharded, whose joint loss is within 1e-5 of the reference's
    single-device loss on the same params (the reference's own test asks
    only for a finite loss); the gradients within 1e-5 relative to each
    leaf's largest entry; the updated params kept on their placements, and
    the next step's loss within 1e-5 too. (The updated params themselves
    are not compared: AdamW's first step is lr * sign(g) wherever |g| is
    far above eps, so where a gradient entry is near 0 a rounding apart
    moves it by up to 2 lr.)"""
    assert abs(gloo8["loss"] - gloo8["loss_unsharded"]) < 1e-5
    assert abs(gloo8["joint_loss"] - float(ref["ds_loss"])) < 1e-5
    assert gloo8["step_grad_rel"] < 1e-5
    assert gloo8["placements_kept"]
    assert abs(gloo8["loss2"] - gloo8["loss2_unsharded"]) < 1e-5


def test_expert_parallelism_on_two_pods(gloo8):
    """EP on a (2, 2, 2) ("pod", "data", "model") mesh with the experts
    split over "pod" and "data" along their hidden dim, gathered in one
    collective over the two (``sharding.over_data_axes``): y and the
    router loss within 1e-5 of the unsharded routing of each data rank's
    tokens, and the gradient within 1e-5 relative to each leaf's largest
    entry, handed back on each leaf's own placements (one reduce-scatter
    over the same group)."""
    assert gloo8["ep3_err"] < 1e-5, gloo8["ep3_err"]
    assert gloo8["ep3_grad_rel"] < 1e-5, gloo8["ep3_grad_rel"]
    assert gloo8["ep3_grad_placements"]


def test_expert_parallel_serving_on_two_pods(gloo8):
    """The reduced DeepSeekMoE-16B (8 dropless experts) on the (2, 2, 2)
    mesh under EP, its experts split over "pod" and "data" along their
    hidden dim: prefill and two decode steps routed row by row, within
    1e-5 of the same model unsharded."""
    errs = gloo8["ep3_serve_errs"]
    assert len(errs) == 3 and max(errs) < 1e-5, errs
