"""The reference's own policy-layer tests, run against the port.

Each test function of ``tests/test_scheduler.py``, ``test_tenancy.py``,
``test_spatial.py``, ``test_traces.py``, ``test_durability.py`` and the
scheduler and simulator tests of ``test_preemption.py`` (those that build
no JAX model) runs again with its module's globals bound to the port:

  * a reference module (``repro.core.simulate``) becomes the port's
    (``repro_torch.core.simulate``), a reference class or function the
    port's of the same name, and a reference dataclass instance (``SPEC =
    T.NodeSpec()``) the port's instance with the same fields;
  * the test module's own helpers, the ``prop`` helpers and the closures
    of ``given_cases`` wrappers are rebuilt over the same bound globals;
  * an import statement inside a function (``from repro.core.scheduler
    import _GangRun``) goes through an ``__import__`` that maps
    ``repro.*`` to ``repro_torch.*``;
  * tasks a module registers with the reference's ``register_task`` are
    registered again, rebound, in the port's ``TASK_REGISTRY``.

The reference's files are not changed; each case here is one of their
tests, on the port. ``test_traces.py::test_committed_suite_is_reproducible``
fails on the reference under Python 3.12 (ROADMAP C0) and passes here.
"""
from __future__ import annotations

import builtins
import dataclasses
import importlib
import os
import sys
import types

import pytest

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS_DIR)
for _p in (TESTS_DIR, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# every test function of these files ...
WHOLE_FILES = ["test_scheduler", "test_tenancy", "test_spatial",
               "test_traces", "test_durability"]
# ... and these of test_preemption.py (the others step a JAX model's pool)
PREEMPTION_TESTS = [
    "test_policy_eligibility_and_victim_score",
    "test_policy_min_nodes_elastic_floor",
    "test_pop_dispatchable_elastic_grant",
    "test_scheduler_preempts_checkpoints_and_resumes_elastically",
    "test_scheduler_gang_checkpoint_every_writes_cursors",
    "test_preempted_job_lane_backfill_resume_skips_completed_tasks",
    "test_preempt_outside_run_queued_raises",
    "test_simulator_preemption_cuts_waits_with_bounded_overhead",
    "test_simulator_preemption_deterministic_replay",
    "test_simulator_elastic_narrow_resume",
    "test_compare_modes_adds_preemptive_report",
    "test_wait_histogram_and_quantile",
]
# helper modules whose functions are rebuilt over the port as well
HELPER_MODULES = ("prop", "tests.prop")
REBOUND_MODULES = (*WHOLE_FILES, "test_preemption", *HELPER_MODULES)


def _is_ref(name: str) -> bool:
    return name == "repro" or name.startswith("repro.")


def _port_name(name: str) -> str:
    return "repro_torch" + name[len("repro"):]


def _port_import(name, globals=None, locals=None, fromlist=(), level=0):
    if level == 0 and _is_ref(name):
        name = _port_name(name)
    elif level == 0 and name in HELPER_MODULES and fromlist:
        return _rebound_module(importlib.import_module(name))
    return builtins.__import__(name, globals, locals, fromlist, level)


PORT_BUILTINS = dict(vars(builtins), __import__=_port_import)
_REBOUND: dict = {}


def _port_value(val):
    """``val`` as the port sees it."""
    if isinstance(val, types.ModuleType):
        if _is_ref(val.__name__):
            return importlib.import_module(_port_name(val.__name__))
        if val.__name__ in REBOUND_MODULES:
            return _rebound_module(val)
        return val
    if isinstance(val, types.FunctionType):
        src = val.__globals__.get("__name__", "")
        if src in REBOUND_MODULES:
            return _rebind_function(val, _rebound_module(sys.modules[src]))
        return _port_attr(val) if _is_ref(src) else val
    if isinstance(val, type):
        return _port_attr(val) if _is_ref(val.__module__) else val
    if (dataclasses.is_dataclass(val) and not isinstance(val, type)
            and _is_ref(type(val).__module__)):
        cls = _port_attr(type(val))
        return cls(**{f.name: _port_value(getattr(val, f.name))
                      for f in dataclasses.fields(val) if f.init})
    if type(val) in (list, tuple):
        return type(val)(_port_value(v) for v in val)
    return val


def _port_attr(obj):
    out = importlib.import_module(_port_name(obj.__module__))
    for part in obj.__qualname__.split("."):
        out = getattr(out, part)
    return out


def _rebind_function(fn: types.FunctionType, mod: types.ModuleType):
    """``fn`` over the globals of ``mod``, a rebound module; functions it
    closes over are rebound too (a ``given_cases`` wrapper closes over the
    test body)."""
    closure = None
    if fn.__closure__ is not None:
        closure = tuple(types.CellType(_port_value(c.cell_contents))
                        for c in fn.__closure__)
    new = types.FunctionType(fn.__code__, mod.__dict__, fn.__name__,
                             fn.__defaults__, closure)
    new.__kwdefaults__ = fn.__kwdefaults__
    new.__dict__.update(fn.__dict__)
    new.__qualname__ = fn.__qualname__
    return new


def _rebound_module(mod: types.ModuleType) -> types.ModuleType:
    """A copy of ``mod`` whose globals and functions are bound to the
    port (cached, so helpers that call each other share one namespace)."""
    if mod.__name__ in _REBOUND:
        return _REBOUND[mod.__name__]
    out = types.ModuleType(mod.__name__)
    _REBOUND[mod.__name__] = out
    g = out.__dict__
    g.update(vars(mod))
    g["__builtins__"] = PORT_BUILTINS
    for k, v in vars(mod).items():
        if not k.startswith("__"):
            g[k] = _port_value(v)
    _register_tasks(mod, g)
    return out


def _register_tasks(mod: types.ModuleType, g: dict):
    """Tasks ``mod`` registered with the reference, rebound, in the
    port's registry."""
    ref_cp = sys.modules.get("repro.core.controlplane")
    if ref_cp is None:
        return
    from repro_torch.core import controlplane as port_cp
    for name, fn in ref_cp.TASK_REGISTRY.items():
        if getattr(fn, "__module__", None) == mod.__name__:
            port_cp.TASK_REGISTRY[name] = g[fn.__name__]


def _cases():
    out = []
    for modname in WHOLE_FILES + ["test_preemption"]:
        mod = importlib.import_module(modname)
        names = ([n for n, v in vars(mod).items()
                  if n.startswith("test_") and callable(v)]
                 if modname != "test_preemption" else PREEMPTION_TESTS)
        for name in names:
            fn = getattr(mod, name)
            params = [()]
            argnames: tuple = ()
            for mark in getattr(fn, "pytestmark", []):
                if mark.name == "parametrize":
                    argnames = tuple(a.strip() for a in
                                     mark.args[0].split(","))
                    params = [v if isinstance(v, tuple) else (v,)
                              for v in mark.args[1]]
                else:
                    raise AssertionError(f"{modname}::{name}: unexpected "
                                         f"mark {mark.name}")
            for p in params:
                tag = f"{modname}::{name}" + (
                    f"[{'-'.join(map(str, p))}]" if p else "")
                out.append(pytest.param(modname, name, dict(zip(argnames, p)),
                                        id=tag))
    return out


CASES = _cases()


def test_case_list_covers_the_reference_files():
    """Every test of the five whole files is here, and the preemption
    list names tests that exist."""
    got = {c.values[0] + "::" + c.values[1] for c in CASES}
    for modname in WHOLE_FILES:
        mod = importlib.import_module(modname)
        for n, v in vars(mod).items():
            if n.startswith("test_") and callable(v):
                assert f"{modname}::{n}" in got
    pre = importlib.import_module("test_preemption")
    assert all(callable(getattr(pre, n)) for n in PREEMPTION_TESTS)
    assert len(got) == 108            # the reference files are frozen


@pytest.mark.parametrize("modname,name,params", CASES)
def test_reference_policy_test_on_port(modname, name, params, tmp_path,
                                       monkeypatch):
    fn = getattr(_rebound_module(importlib.import_module(modname)), name)
    g = fn.__globals__
    assert g["__builtins__"] is PORT_BUILTINS
    left = [k for k, v in g.items() if not k.startswith("__") and _is_ref(
        v.__name__ if isinstance(v, types.ModuleType)
        else getattr(v, "__module__", None) or "")]
    assert left == [], f"globals still bound to the reference: {left}"
    fixtures = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    kwargs = dict(params)
    for arg in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        if arg not in kwargs:
            kwargs[arg] = fixtures[arg]
    fn(**kwargs)
