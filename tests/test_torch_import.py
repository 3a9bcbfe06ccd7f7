"""The port stands alone: importing it loads no JAX and nothing of ``repro``,
no file of it (nor the ``chip_*.py`` scripts) imports them or calls a library
attention kernel, and a kernel's CUDA path computes nothing in PyTorch."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py"))
CHECKED_FILES = PORT_FILES + ["chip_smoke.py", "chip_prefill_wall.py",
                              "chip_pool_peak.py"]


def _is_forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_import_loads_no_jax_or_repro():
    """Import the package and every submodule in a fresh interpreter."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps({'n': len(names), 'bad': bad}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["n"] >= 49   # configs, kernels, models, core, launch, optim,
                            # data, checkpoint, roofline
    assert out["bad"] == []


def _alone_loads_no_jax(module: str) -> None:
    """Import ``module`` alone in a fresh interpreter (so no other import
    has pulled its dependencies in first) and check what it loaded."""
    code = (f"import json, sys, {module}\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(json.dumps({'bad': bad}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["bad"] == []


@pytest.mark.parametrize("module", ["repro_torch.models.ssm",
                                    "repro_torch.kernels.ssd_scan",
                                    "repro_torch.kernels.ops"])
def test_ssm_slice_modules_load_no_jax(module):
    """Each module of the SSM slice, imported alone."""
    _alone_loads_no_jax(module)


@pytest.mark.parametrize("module", [
    "repro_torch.launch.sweep", "repro_torch.launch.train",
    "repro_torch.optim.schedule", "repro_torch.data.pipeline",
    "repro_torch.core.autotune", "repro_torch.core.repack",
    "repro_torch.core.faults", "repro_torch.core.tenancy",
    "repro_torch.core.monitor", "repro_torch.models.model"])
def test_sweep_slice_modules_load_no_jax(module):
    """Each module of the transformer-sweep slice, imported alone."""
    _alone_loads_no_jax(module)


@pytest.mark.parametrize("module", [
    "repro_torch.core.elastic", "repro_torch.core.spatial",
    "repro_torch.core.scheduler", "repro_torch.core.mapreduce",
    "repro_torch.core.simulate", "repro_torch.core.traces",
    "repro_torch.core.eventlog", "repro_torch.core.controlplane"])
def test_policy_slice_modules_load_no_jax(module):
    """Each module of the policy and durability slice, imported alone."""
    _alone_loads_no_jax(module)


@pytest.mark.parametrize("module", [
    "repro_torch.models.moe", "repro_torch.models.transformer",
    "repro_torch.launch.serve"])
def test_moe_hybrid_slice_modules_load_no_jax(module):
    """Each module of the moe and hybrid slice, imported alone."""
    _alone_loads_no_jax(module)


@pytest.mark.parametrize("module", [
    "repro_torch.roofline", "repro_torch.roofline.analysis",
    "repro_torch.roofline.counting"])
def test_roofline_modules_load_no_jax(module):
    """Each module of the roofline, imported alone."""
    _alone_loads_no_jax(module)


@pytest.mark.parametrize("module", [
    "repro_torch.models.resnet", "repro_torch.models.layers",
    "repro_torch.models.attention", "repro_torch.models.convert"])
def test_encdec_vlm_resnet_slice_modules_load_no_jax(module):
    """Each module of the encdec, vlm and ResNet slice, imported alone."""
    _alone_loads_no_jax(module)


@pytest.mark.parametrize("module", [
    "repro_torch.distributed", "repro_torch.distributed.sharding",
    "repro_torch.distributed.compression",
    "repro_torch.distributed.collectives", "repro_torch.launch.mesh",
    "repro_torch.launch.dryrun"])
def test_distributed_slice_modules_load_no_jax(module):
    """Each module of the distributed slice, imported alone (the source
    checks below take in every file of the port, these too)."""
    _alone_loads_no_jax(module)


def test_encdec_vlm_resnet_paths_load_no_jax():
    """The vlm and encdec paths of ``models.model`` (prefill, a decode
    step, ``input_specs``) and ResNet's loss, run on the CPU in a fresh
    interpreter, load no JAX and nothing of ``repro``."""
    code = (
        "import json, sys, torch\n"
        "from repro_torch import configs\n"
        "from repro_torch.models import resnet\n"
        "from repro_torch.models.model import Model\n"
        "g = lambda: torch.Generator().manual_seed(0)\n"
        "for name, b in (('qwen2-vl-7b', {'embeds': torch.zeros(1, 4, 64),\n"
        "                 'mrope_pos': torch.zeros(3, 1, 4, dtype=torch.long)}),\n"
        "                ('seamless-m4t-medium', {'enc_embeds':\n"
        "                 torch.zeros(1, 5, 64),\n"
        "                 'tokens': torch.zeros(1, 3, dtype=torch.long)})):\n"
        "    m = Model(configs.get(name).reduced(), device='cpu')\n"
        "    p = m.init(g())\n"
        "    _, c = m.prefill(p, b, 8)\n"
        "    step = {'tokens': torch.zeros(1, 1, dtype=torch.long),\n"
        "            'pos': torch.full((1,), 4)}\n"
        "    if 'embeds' in b: step['mrope_pos'] = torch.full((3, 1, 1), 4)\n"
        "    m.decode_step(p, step, c)\n"
        "    m.input_specs(configs.SHAPES[2])\n"
        "rp = resnet.init(g(), 0.25, 10, device='cpu')\n"
        "resnet.loss(rp, {'image': torch.zeros(1, 8, 8, 3),\n"
        "                 'label': torch.zeros(1, dtype=torch.long)})\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps({'bad': bad}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert json.loads(res.stdout.strip().splitlines()[-1])["bad"] == []


@pytest.mark.parametrize("path", CHECKED_FILES)
def test_source_imports_no_jax_or_repro(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_is_forbidden(n) for n in names), (path, names)


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_calls_no_library_attention_or_compiler(path):
    """SDPA, cuDNN and torch.compile may time a yardstick in chip_smoke.py,
    never run in the port."""
    text = (ROOT / path).read_text()
    for word in ("scaled_dot_product_attention", "torch.compile", "cudnn",
                 "flash_attn"):
        assert word not in text, (path, word)


KERNEL_MODULES = ["kernels/flash_attention.py", "kernels/packed_gemm.py",
                  "kernels/fused_rmsnorm.py", "kernels/ssd_scan.py"]
TORCH_MATH = ("matmul", "bmm", "mm", "baddbmm", "einsum", "softmax", "rsqrt",
              "exp", "rms_norm")


@pytest.mark.parametrize("path", KERNEL_MODULES)
def test_kernel_path_computes_nothing_in_pytorch(path):
    """In a kernel module, the CUDA wrapper and its helpers (``*_cuda``,
    ``_check``, ``_bind``, ``_launch``) never reach the plain version, the
    oracle or a PyTorch math call: on a CUDA tensor the function is the
    kernel's alone."""
    tree = ast.parse((PORT / path).read_text())
    fns = [n for n in tree.body if isinstance(n, ast.FunctionDef)
           and (n.name.endswith("_cuda")
                or n.name in ("_check", "_bind", "_launch"))]
    assert any(f.name.endswith("_cuda") for f in fns), path
    for fn in fns:
        for node in ast.walk(fn):
            assert not (isinstance(node, ast.BinOp)
                        and isinstance(node.op, ast.MatMult)), fn.name
            name = (node.attr if isinstance(node, ast.Attribute)
                    else node.id if isinstance(node, ast.Name) else "")
            assert name not in TORCH_MATH, (fn.name, name)
            assert not name.endswith(("_plain", "_ref")), (fn.name, name)
