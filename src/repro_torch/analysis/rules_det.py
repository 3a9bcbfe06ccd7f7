"""DET — determinism rules for decision-path modules.

The scheduler-quality gate (DESIGN.md §11) compares replay metrics
EXACTLY against BENCH_HISTORY.json; the preemption/repack seams promise
bit-identical resumes. Both only hold while every scheduling decision is
a pure function of recorded inputs. Each rule here bans one way real
nondeterminism has historically crept into such systems:

  DET001  any clock read on the decision path
  DET002  wall-clock used as a duration clock anywhere in src/
  DET003  unseeded RNG on the decision path
  DET004  iteration over a set feeding order-sensitive consumers
  DET005  id()-derived ordering / keying
  DET006  float == / != in scheduling gates
"""
from __future__ import annotations

import ast
from typing import Iterable, List

from repro_torch.analysis.core import (Finding, SourceModule, context_of,
                                 register, resolve_call_name)

# every clock in the stdlib that can observe the host at run time
_ALL_CLOCKS = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.process_time",
    "time.process_time_ns", "time.clock_gettime", "time.localtime",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.date.today",
}

# clocks that read the WALL (drift under NTP/suspend): never the right
# duration clock; time.perf_counter is the sanctioned one outside
# decision modules
_WALL_CLOCKS = {
    "time.time", "time.time_ns", "time.localtime",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.date.today",
}

_NP_LEGACY_RNG = {
    "rand", "randn", "randint", "random", "random_sample", "ranf",
    "sample", "choice", "shuffle", "permutation", "uniform", "normal",
    "standard_normal", "beta", "binomial", "poisson", "exponential",
    "gamma", "lognormal", "pareto", "seed", "bytes", "random_integers",
}

_NP_BITGENS = {
    "numpy.random.default_rng", "numpy.random.Philox",
    "numpy.random.PCG64", "numpy.random.PCG64DXSM",
    "numpy.random.MT19937", "numpy.random.SFC64",
    "numpy.random.Generator",
}


def _decision_mods(modules, config) -> Iterable[SourceModule]:
    for mod in modules:
        if config.is_decision(mod.relpath):
            yield mod


@register("DET001", "wall-clock-decision",
          "no clock reads inside decision-path modules")
def check_clock_decision(modules, config) -> List[Finding]:
    out: List[Finding] = []
    for mod in _decision_mods(modules, config):
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = resolve_call_name(mod, node.func)
            if name in _ALL_CLOCKS:
                out.append(mod.finding(
                    "DET001", "wall-clock-decision", node,
                    f"{name}() read inside decision-path module — a "
                    f"decision must be a pure function of recorded "
                    f"inputs; pragma telemetry-only reads with a reason",
                    context_of(mod, node)))
    return out


@register("DET002", "wall-clock-timing",
          "wall clock is never the duration clock; use time.perf_counter")
def check_wall_clock(modules, config) -> List[Finding]:
    out: List[Finding] = []
    for mod in modules:
        if config.is_decision(mod.relpath):
            continue   # DET001 already bans every clock there
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = resolve_call_name(mod, node.func)
            if name in _WALL_CLOCKS:
                out.append(mod.finding(
                    "DET002", "wall-clock-timing", node,
                    f"{name}() reads the wall clock — every other layer "
                    f"times with time.perf_counter(); unify (wall-clock "
                    f"timestamps drift under NTP/suspend)",
                    context_of(mod, node)))
    return out


@register("DET003", "unseeded-rng",
          "no unseeded randomness inside decision-path modules")
def check_unseeded_rng(modules, config) -> List[Finding]:
    out: List[Finding] = []
    for mod in _decision_mods(modules, config):
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = resolve_call_name(mod, node.func)
            if name is None:
                continue
            bad = None
            if name.startswith("random."):
                bad = ("stdlib random module is globally seeded mutable "
                       "state")
            elif (name.startswith("numpy.random.")
                  and name.rsplit(".", 1)[-1] in _NP_LEGACY_RNG):
                bad = "legacy numpy global RNG is shared mutable state"
            elif name in _NP_BITGENS and not node.args and not node.keywords:
                bad = ("bit generator constructed without an explicit "
                       "seed/key draws OS entropy")
            if bad:
                out.append(mod.finding(
                    "DET003", "unseeded-rng", node,
                    f"{name}() on the decision path: {bad}; thread an "
                    f"explicit seeded Generator (traces.py pattern: "
                    f"np.random.Generator(np.random.Philox(key=seed)))",
                    context_of(mod, node)))
    return out


# -- DET004: set iteration ---------------------------------------------------

_ORDER_SENSITIVE_WRAPPERS = {"list", "tuple", "enumerate", "iter", "next",
                             "reversed", "map", "filter", "zip"}

_SET_METHODS = {"union", "intersection", "difference",
                "symmetric_difference", "copy"}


class _SetTyping:
    """Best-effort, flow-insensitive inference of set-typed names within
    one scope (nested defs inherit the parent's typing)."""

    def __init__(self, parent_names=()):
        self.set_names = set(parent_names)

    def is_set_expr(self, node: ast.AST) -> bool:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Name) and fn.id in ("set", "frozenset"):
                return True
            if (isinstance(fn, ast.Attribute) and fn.attr in _SET_METHODS
                    and self.is_set_expr(fn.value)):
                return True
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
            return (self.is_set_expr(node.left)
                    or self.is_set_expr(node.right))
        if isinstance(node, ast.Name):
            return node.id in self.set_names
        return False

    def learn(self, stmt: ast.stmt):
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        elif isinstance(stmt, ast.AugAssign):
            # s |= {...} keeps set typing; anything else learns nothing
            if self.is_set_expr(stmt.value) and isinstance(
                    stmt.target, ast.Name):
                self.set_names.add(stmt.target.id)
            return
        else:
            return
        if self.is_set_expr(value):
            for t in targets:
                if isinstance(t, ast.Name):
                    self.set_names.add(t.id)
        else:
            for t in targets:
                if isinstance(t, ast.Name):
                    self.set_names.discard(t.id)


def _walk_scope(scope_node):
    """Walk a module/def body without descending into nested defs."""
    if isinstance(scope_node, ast.Lambda):
        roots = [scope_node.body]
    else:
        roots = list(getattr(scope_node, "body", []))
    stack = list(roots)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


@register("DET004", "set-iteration",
          "no iteration over sets feeding order-sensitive consumers")
def check_set_iteration(modules, config) -> List[Finding]:
    out: List[Finding] = []
    for mod in _decision_mods(modules, config):
        _scan_set_scope(mod, mod.tree, _SetTyping(), out)
    return out


def _scan_set_scope(mod: SourceModule, scope_node, parent: _SetTyping,
                    out: List[Finding]):
    typing = _SetTyping(parent.set_names)
    for sub in _walk_scope(scope_node):
        if isinstance(sub, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            typing.learn(sub)
    for sub in _walk_scope(scope_node):
        _flag_set_iter(mod, sub, typing, out)
    for sub in _walk_scope(scope_node):
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            _scan_set_scope(mod, sub, typing, out)


def _flag_set_iter(mod, node, typing: _SetTyping, out: List[Finding]):
    hits = []
    if isinstance(node, ast.For) and typing.is_set_expr(node.iter):
        hits.append(node.iter)
    elif isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.DictComp)):
        # SetComp over a set stays order-insensitive; these three leak
        # the iteration order into an ordered container / consumer
        for gen in node.generators:
            if typing.is_set_expr(gen.iter):
                hits.append(gen.iter)
    elif isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id in _ORDER_SENSITIVE_WRAPPERS:
            for arg in node.args:
                if typing.is_set_expr(arg):
                    hits.append(arg)
    for h in hits:
        out.append(mod.finding(
            "DET004", "set-iteration", h,
            "iterating a set here leaks hash order into an "
            "order-sensitive consumer — wrap in sorted(...); order-"
            "insensitive reductions (min/max/sum/any/all/set) are fine",
            context_of(mod, h)))


@register("DET005", "id-ordering",
          "no id()-derived ordering or keying on the decision path")
def check_id_ordering(modules, config) -> List[Finding]:
    out: List[Finding] = []
    for mod in _decision_mods(modules, config):
        if "id" in mod.import_aliases:
            continue   # shadowed by an import; not the builtin
        for node in ast.walk(mod.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "id"):
                out.append(mod.finding(
                    "DET005", "id-ordering", node,
                    "id() is a memory address — any ordering/keying "
                    "derived from it varies run to run; key on a stable "
                    "field (job id, submit_seq) instead",
                    context_of(mod, node)))
    return out


@register("DET006", "float-eq-gate",
          "no float == / != in scheduling gates")
def check_float_eq(modules, config) -> List[Finding]:
    out: List[Finding] = []
    for mod in _decision_mods(modules, config):
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Compare):
                continue
            if not any(isinstance(op, (ast.Eq, ast.NotEq))
                       for op in node.ops):
                continue
            operands = [node.left] + list(node.comparators)
            if any(isinstance(o, ast.Constant)
                   and isinstance(o.value, float) for o in operands):
                out.append(mod.finding(
                    "DET006", "float-eq-gate", node,
                    "float equality in a decision gate — accumulated "
                    "float state is platform/order sensitive; compare "
                    "with an explicit tolerance or gate on the integer "
                    "event that set the value",
                    context_of(mod, node)))
    return out
