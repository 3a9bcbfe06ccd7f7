"""Lint framework core: findings, pragmas, rule registry, module model.

A *finding* is one rule violation anchored to a file/line. Its
``fingerprint`` intentionally omits the line *number* (it keys on the
enclosing scope plus the normalized source text) so the committed
baseline survives unrelated edits above a tolerated finding.

Suppression is per-line and must carry a reason::

    t0 = time.perf_counter()  # lint: disable=DET001(telemetry only)

and in a CUDA source (``.cu``, ``.cuh``), as a ``//`` comment::

    atomicAdd(&sum, v);  // lint: disable=CUD405(reason)

A pragma with no reason, an unknown rule id, or a pragma that suppresses
nothing is itself a finding (LNT001 / LNT002) — stale suppressions rot
into blind spots otherwise.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# --------------------------------------------------------------------------
# findings
# --------------------------------------------------------------------------

_WS = re.compile(r"\s+")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""
    rule: str                 # e.g. "DET001"
    name: str                 # mnemonic, e.g. "wall-clock-decision"
    path: str                 # root-relative, forward slashes
    line: int                 # 1-based physical line of the anchor node
    message: str
    context: str = "<module>"  # enclosing def/class qualname
    line_text: str = ""        # stripped source of the anchor line

    @property
    def fingerprint(self) -> str:
        """Line-number-free identity used by the baseline file."""
        norm = _WS.sub(" ", self.line_text.strip())
        return f"{self.rule}|{self.path}|{self.context}|{norm}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule}[{self.name}] "
                f"{self.message}")


# --------------------------------------------------------------------------
# pragmas
# --------------------------------------------------------------------------

PRAGMA_RE = re.compile(r"#\s*lint:\s*disable=(?P<entries>.+?)\s*$")
PRAGMA_CUDA_RE = re.compile(r"^//\s*lint:\s*disable=(?P<entries>.+?)\s*$")
CUDA_SUFFIXES = (".cu", ".cuh")
PRAGMA_ENTRY_RE = re.compile(r"(?P<rule>[A-Z]{3}\d{3})\((?P<reason>[^()]*)\)")
PRAGMA_TOKEN_RE = re.compile(r"[A-Z]{3}\d{3}")


@dataclasses.dataclass
class Pragma:
    """One ``RULE(reason)`` suppression entry on one line."""
    line: int
    rule: str
    reason: str
    used: bool = False


def _comment_tokens(source: str) -> List[Tuple[int, str]]:
    """(line, comment_text) for every real COMMENT token — pragma text
    inside string literals/docstrings must not count."""
    import io
    import tokenize
    out: List[Tuple[int, str]] = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out.append((tok.start[0], tok.string))
    except (tokenize.TokenError, IndentationError):
        pass   # ast.parse already vets syntax; partial scans are fine
    return out


def parse_pragmas(source: str,
                  known_rules: Optional[set] = None,
                  comments: Optional[List[Tuple[int, str]]] = None,
                  ) -> Tuple[List[Pragma], List[Tuple[int, str]]]:
    """Scan comment tokens for suppression pragmas (``comments``, when
    given, are a CUDA source's ``//`` comments as ``(line, text)``).

    Returns ``(pragmas, malformed)`` where ``malformed`` is a list of
    ``(line, problem)`` — entries with an empty reason, bare rule tokens
    without a ``(reason)``, or unknown rule ids.
    """
    pragmas: List[Pragma] = []
    malformed: List[Tuple[int, str]] = []
    pattern = PRAGMA_RE if comments is None else PRAGMA_CUDA_RE
    for i, text in (_comment_tokens(source) if comments is None
                    else comments):
        m = pattern.search(text)
        if not m:
            continue
        entries = m.group("entries")
        seen_spans = []
        for em in PRAGMA_ENTRY_RE.finditer(entries):
            seen_spans.append(em.span())
            rule, reason = em.group("rule"), em.group("reason").strip()
            if not reason:
                malformed.append(
                    (i, f"pragma for {rule} has an empty reason"))
                continue
            if known_rules is not None and rule not in known_rules:
                malformed.append((i, f"pragma names unknown rule {rule}"))
                continue
            pragmas.append(Pragma(line=i, rule=rule, reason=reason))
        # bare rule tokens outside any RULE(reason) span lack a reason
        for tm in PRAGMA_TOKEN_RE.finditer(entries):
            if not any(s <= tm.start() < e for s, e in seen_spans):
                malformed.append(
                    (i, f"pragma for {tm.group(0)} is missing a "
                        f"(reason)"))
    return pragmas, malformed


# --------------------------------------------------------------------------
# source module model
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SourceModule:
    """A parsed source file plus everything rules need to inspect it."""
    path: str                       # absolute
    relpath: str                    # root-relative, forward slashes
    source: str
    lines: List[str]
    tree: ast.Module
    pragmas: List[Pragma]
    malformed_pragmas: List[Tuple[int, str]]
    import_aliases: Dict[str, str]  # local name -> canonical dotted prefix
    cuda: Optional[object] = None   # cuda_model.CudaSource of a .cu/.cuh
                                    # (its Python tree is then empty)

    @classmethod
    def load(cls, path, root, known_rules: Optional[set] = None
             ) -> "SourceModule":
        import os
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        lines = source.splitlines()
        if str(path).endswith(CUDA_SUFFIXES):
            from repro_torch.analysis import cuda_model
            cu = cuda_model.load(str(path), rel)
            pragmas, malformed = parse_pragmas(source, known_rules,
                                               comments=cu.comments)
            return cls(path=str(path), relpath=rel, source=source,
                       lines=lines, tree=ast.Module(body=[], type_ignores=[]),
                       pragmas=pragmas, malformed_pragmas=malformed,
                       import_aliases={}, cuda=cu)
        tree = ast.parse(source, filename=rel)
        pragmas, malformed = parse_pragmas(source, known_rules)
        return cls(path=str(path), relpath=rel, source=source, lines=lines,
                   tree=tree, pragmas=pragmas, malformed_pragmas=malformed,
                   import_aliases=collect_import_aliases(tree))

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, rule: str, name: str, node_or_line, message: str,
                context: str = "<module>") -> Finding:
        line = (node_or_line if isinstance(node_or_line, int)
                else getattr(node_or_line, "lineno", 1))
        return Finding(rule=rule, name=name, path=self.relpath, line=line,
                       message=message, context=context,
                       line_text=self.line_text(line))


def collect_import_aliases(tree: ast.Module) -> Dict[str, str]:
    """Map local names to canonical dotted prefixes.

    ``import numpy as np`` -> {"np": "numpy"};
    ``from time import perf_counter as pc`` -> {"pc": "time.perf_counter"}.
    Star imports are ignored (unresolvable statically).
    """
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            if node.module is None or node.level:
                continue   # relative imports: keep local resolution only
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def dotted_name(node: ast.AST) -> Optional[str]:
    """Render a Name/Attribute chain as ``a.b.c`` (None if not a chain)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def resolve_call_name(mod: SourceModule, func: ast.AST) -> Optional[str]:
    """Canonical dotted name of a call target, expanding import aliases.

    ``np.random.default_rng`` -> ``numpy.random.default_rng`` under
    ``import numpy as np``. A bare local name maps through a from-import
    (``from time import time`` makes ``time()`` -> ``time.time``).
    """
    dn = dotted_name(func)
    if dn is None:
        return None
    head, _, rest = dn.partition(".")
    canon = mod.import_aliases.get(head)
    if canon is None:
        return dn
    return f"{canon}.{rest}" if rest else canon


def enclosing_context(tree: ast.Module) -> Dict[int, str]:
    """Map every node id to its enclosing def/class qualname."""
    ctx: Dict[int, str] = {}

    def visit(node: ast.AST, qual: str):
        for child in ast.iter_child_nodes(node):
            q = qual
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                q = f"{qual}.{child.name}" if qual != "<module>" \
                    else child.name
            ctx[id(child)] = qual
            visit(child, q)
    ctx[id(tree)] = "<module>"
    visit(tree, "<module>")
    return ctx


def context_of(mod: SourceModule, node: ast.AST) -> str:
    table = getattr(mod, "_ctx_table", None)
    if table is None:
        table = enclosing_context(mod.tree)
        mod._ctx_table = table
    return table.get(id(node), "<module>")


# --------------------------------------------------------------------------
# rule registry
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Rule:
    """A registered check. ``check(modules, config)`` sees the full module
    set so cross-file rules (MASK dispatcher coverage, ACC symmetry) can
    correlate; per-file rules just loop."""
    id: str
    name: str
    doc: str
    check: Callable


RULES: Dict[str, Rule] = {}


def register(rule_id: str, name: str, doc: str):
    def deco(fn):
        if rule_id in RULES:
            raise ValueError(f"duplicate rule id {rule_id}")
        RULES[rule_id] = Rule(id=rule_id, name=name, doc=doc, check=fn)
        return fn
    return deco


def all_rule_ids() -> set:
    _ensure_rules_loaded()
    return set(RULES) | {"LNT001", "LNT002"}


def _ensure_rules_loaded():
    # rule modules self-register on import; idempotent
    from repro_torch.analysis import rules_acc    # noqa: F401
    from repro_torch.analysis import rules_cuda   # noqa: F401
    from repro_torch.analysis import rules_det    # noqa: F401
    from repro_torch.analysis import rules_mask   # noqa: F401


def run_rules(modules: Sequence[SourceModule], config
              ) -> Tuple[List[Finding], List[Finding], List[Pragma]]:
    """Run every registered rule, then apply pragma suppression.

    Returns ``(active, suppressed, pragmas)``. Active findings include
    LNT001 (malformed pragma) and LNT002 (pragma that suppressed
    nothing) hygiene findings.
    """
    _ensure_rules_loaded()
    raw: List[Finding] = []
    for rule in sorted(RULES.values(), key=lambda r: r.id):
        raw.extend(rule.check(modules, config))

    by_file: Dict[str, List[Pragma]] = {}
    for mod in modules:
        by_file[mod.relpath] = mod.pragmas

    active: List[Finding] = []
    suppressed: List[Finding] = []
    for f in raw:
        hit = None
        for p in by_file.get(f.path, ()):
            if p.line == f.line and p.rule == f.rule:
                hit = p
                break
        if hit is not None:
            hit.used = True
            suppressed.append(f)
        else:
            active.append(f)

    for mod in modules:
        for line, problem in mod.malformed_pragmas:
            active.append(mod.finding(
                "LNT001", "malformed-pragma", line,
                f"{problem} — use `{'//' if mod.cuda else '#'} lint: "
                f"disable=RULE(reason)`"))
        for p in mod.pragmas:
            if not p.used:
                active.append(mod.finding(
                    "LNT002", "unused-pragma", p.line,
                    f"pragma disables {p.rule} but nothing on this line "
                    f"triggers it; delete the stale suppression"))

    # LNT findings are themselves suppressible (rarely needed, but keeps
    # the mechanism uniform)
    final_active: List[Finding] = []
    for f in active:
        if f.rule.startswith("LNT"):
            hit = None
            for p in by_file.get(f.path, ()):
                if p.line == f.line and p.rule == f.rule:
                    hit = p
                    break
            if hit is not None:
                hit.used = True
                suppressed.append(f)
                continue
        final_active.append(f)

    order = lambda f: (f.path, f.line, f.rule)
    final_active.sort(key=order)
    suppressed.sort(key=order)
    all_pragmas = [p for mod in modules for p in mod.pragmas]
    return final_active, suppressed, all_pragmas
