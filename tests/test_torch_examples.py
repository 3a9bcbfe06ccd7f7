"""The port's entry scripts (``examples/torch_*.py``): each ``main`` runs on
the CPU with ``--device cpu`` at a small size and prints the reference
example's lines, and without ``--device cpu`` a script on a machine with no
card stops with a non-zero exit instead of carrying on on the CPU.

What is held to the reference example (``examples/*.py`` on JAX):
- quickstart: its lines equal in form, the pack factor and sharing flag
  equal, and the eight final losses within 1e-3 (the printed 3 decimals:
  f32 lanes started from the same parameters and data drift apart by
  about 1e-5 in 10 SGD steps, so the rounded values differ by at most one
  unit of the last decimal);
- train_lm: its presets equal, its ``model: ...M params`` line equal to the
  reference config's ``param_count`` with the same preset;
- serve_batch and parametric_sweep: form only (token counts, the pack
  factor, the best lr among those swept). Their weights are random draws
  of each package's own generator, so their values are not comparable;
  the modules they drive are held to the reference in
  ``test_torch_serve.py`` and ``test_torch_sweep.py``.
"""
import dataclasses
import importlib.util
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import NodeSpec as JNodeSpec
from repro.core import Triples as JTriples
from repro.core import plan as jplan
from repro.models import lenet as jlenet
from repro_torch.models import lenet
from repro_torch.models.convert import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("torch_quickstart", "torch_serve_batch", "torch_train_lm",
            "torch_parametric_sweep")


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"examples_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(capsys, name: str, argv=None) -> list:
    """The lines ``name``'s ``main`` prints; a reference example takes no
    arguments."""
    mod = _example(name)
    mod.main() if argv is None else mod.main(argv)
    return [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]


def _losses(line: str) -> list:
    m = re.fullmatch(r"final per-task losses: \[(.*)\]", line)
    assert m, line
    return [float(x.strip(" '")) for x in m.group(1).split(",")]


def test_quickstart_on_the_cpu(capsys, monkeypatch):
    # every lane of both runs starts from the reference's LeNet init at key 0
    start = jax.tree_util.tree_map(np.asarray,
                                   jlenet.init(jax.random.PRNGKey(0)))
    monkeypatch.setattr(jlenet, "init", lambda key: jax.tree_util.tree_map(
        jax.numpy.asarray, start))
    monkeypatch.setattr(lenet, "init", lambda generator, device=None:
                        params_from_numpy(start, "cpu"))
    lines = _run(capsys, "torch_quickstart", ["--device", "cpu"])
    want = _run(capsys, "quickstart")
    node = JNodeSpec(chips_per_node=1, hbm_per_chip=16e9)
    trip = JTriples(nnode=1, nppn=8, ntpp=1)
    p = jplan(n_tasks=8, triples=trip, node_spec=node)
    assert lines[0] == want[0] == (f"pack factor: {p.pack_factor} tasks/chip "
                                   f"(sharing={trip.is_sharing(node)})")
    for ln in (lines[1], want[1]):
        assert re.fullmatch(r"per-task memory: \d+\.\d MB -> 8 packed ≈ \d+ "
                            r"MB \(fits 16GB: True\)", ln), ln
    got, ref = _losses(lines[2]), _losses(want[2])
    assert len(got) == len(ref) == 8
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3 + 1e-9)
    assert len(lines) == len(want) == 3


def test_serve_batch_on_the_cpu(capsys):
    lines = _run(capsys, "torch_serve_batch", ["--device", "cpu"])
    assert re.fullmatch(r"served 6 requests, 48 tokens in \d+\.\d\ds "
                        r"\(\d+\.\d tok/s on CPU\)", lines[0]), lines[0]
    assert len(lines) == 7
    for i, ln in enumerate(lines[1:]):
        m = re.fullmatch(rf"  req{i}: \[([\d, ]+)\]", ln)
        assert m and len(m.group(1).split(",")) == 8, ln


def test_train_lm_on_the_cpu(capsys, tmp_path):
    ckpt = tmp_path / "ckpt"
    lines = _run(capsys, "torch_train_lm",
                 ["--device", "cpu", "--steps", "3", "--seq", "64",
                  "--ckpt", str(ckpt)])
    mod, ref = _example("torch_train_lm"), _example("train_lm")
    assert mod.PRESETS == ref.PRESETS
    jcfg = dataclasses.replace(jconfigs.get("stablelm-1.6b"),
                               **ref.PRESETS["5m"])
    assert lines[0] == f"model: {jcfg.param_count()/1e6:.1f}M params"
    assert re.fullmatch(r"\[trainer\] step 0 loss \d+\.\d{4} \(\d+ ms\)",
                        lines[1]), lines[1]
    assert re.fullmatch(r"loss: \d+\.\d{3} -> \d+\.\d{3} \(\d+ ms/step\)",
                        lines[-1]), lines[-1]
    assert any(ckpt.iterdir())


def test_parametric_sweep_on_the_cpu(capsys):
    lines = _run(capsys, "torch_parametric_sweep",
                 ["--device", "cpu", "--tasks", "2", "--steps", "3"])
    assert re.fullmatch(r"sweep done in \d+\.\ds at pack factor 2 "
                        r"\(backoffs: 0\)", lines[0]), lines[0]
    for ln, lr in zip(lines[1:3], ("0.001", "0.002")):
        assert re.fullmatch(rf"  lr={lr} +first=\d+\.\d{{3}} "
                            rf"last=\d+\.\d{{3}}", ln), ln
    assert lines[3] in ("best lr: 0.001", "best lr: 0.002")
    assert len(lines) == 4


@pytest.mark.parametrize("name", EXAMPLES)
def test_without_a_card_a_script_stops(monkeypatch, capsys, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        _example(name).main([])
    assert exc.value.code not in (0, None)
    assert "--device cpu" in capsys.readouterr().err
