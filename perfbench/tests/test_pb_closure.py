"""What a run loads: in a fresh process, a whole run of a tiny cell
(every harness module, the drivers, the references and the port code they
reach) leaves no module whose top-level name is jax, jaxlib, flax or
repro (the JAX package; ``repro_torch`` is another name)."""
from __future__ import annotations

import json
import subprocess
import sys

from perfbench.tests.helpers import ROOT, env

SCRIPT = """
import json, pkgutil, importlib, sys
import perfbench
from perfbench.tests.helpers import SWEEP_S, run_tiny
for m in pkgutil.walk_packages(perfbench.__path__, "perfbench."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
run_tiny("serve", trace=1)
run_tiny("sweep", seconds=SWEEP_S)
from perfbench.run import forbidden_modules, _metric_reader
from perfbench import common
for m in common.benchmark()["per_layer"]:
    _metric_reader(m["name"])
print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))
print(json.dumps(forbidden_modules()))
"""


def test_a_run_loads_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         env=env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    loaded, forbidden = json.loads(lines[-2]), json.loads(lines[-1])
    assert forbidden == []
    assert "repro_torch" in loaded and "perfbench" in loaded
    assert not {"jax", "jaxlib", "flax", "repro"} & set(loaded)


def test_forbidden_names_are_compared_whole():
    from perfbench.run import forbidden_modules
    assert forbidden_modules(["repro_torch", "repro_torch.models", "jaxfoo",
                              "flaxen.x", "reproduce"]) == []
    assert forbidden_modules(["repro.core", "jax", "jaxlib.xla", "flax",
                              "repro_torch"]) == ["flax", "jax", "jaxlib",
                                                  "repro"]
