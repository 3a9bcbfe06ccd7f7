"""A stdlib-only model of the ``__global__`` kernels in a CUDA source.

The counterpart of the reference's ``pallas_model`` (which reads
``pallas_call`` sites out of Python ASTs) for the port's hand-written
sm_90a kernels. It is fitted to the repository's own idiom, not to C++ at
large: comments and string literals are blanked (offsets kept, so a
position maps back to its line), preprocessor lines are dropped, braces
are matched into namespace, struct, function and block scopes, and each
function's statements are read token by token. For each kernel it records

  * file, line, template parameters and ``__launch_bounds__``;
  * the ``blockIdx`` axes its body reads;
  * each ``kernel<<<grid, block, smem, stream>>>`` launch in the file:
    the rank of the ``dim3`` grid and the dynamic shared-memory argument;
  * the lane-predicate test ``active != nullptr && active[...] == 0``
    (``p.active`` too), the position of the early exit under it, and the
    outputs that branch writes;
  * the position of the first global load, TMA issue, ``cp.async`` or
    MMA outside that branch;
  * its static ``__shared__`` arrays, and whether it takes dynamic ones;
  * the atomics in its body and in the device functions it calls.

Shared-memory sizes come from a small evaluator of the integer constant
expressions the sources use: ``constexpr`` names by namespace, struct
templates' ``static constexpr`` members, ``using`` aliases, ``sizeof``,
casts, ``?:``, and straight-line functions such as ``ssd::make_plan``.
Names it cannot resolve raise :class:`Unresolved`.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# lexing
# ---------------------------------------------------------------------------

_TOKEN = re.compile(r"""
  (?P<ws>\s+)
| (?P<num>0[xX][0-9a-fA-F]+[uUlL]*|(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?[uUlLfF]*)
| (?P<id>[A-Za-z_]\w*)
| (?P<str>"[^"\n]*"|'[^'\n]*')
| (?P<op><<<|>>>|::|->|\+\+|--|<<=|>>=|<<|>>|<=|>=|==|!=|&&|\|\||[-+*/%&|^]=
        |[{}()\[\];,.<>=+\-*/%&|^!~?:#@\\])
""", re.X)


@dataclasses.dataclass(frozen=True)
class Tok:
    kind: str   # "num", "id", "str", "op"
    text: str
    pos: int    # offset into the source


def strip_source(text: str) -> Tuple[str, List[Tuple[int, str]]]:
    """``text`` with comments, string-literal contents and preprocessor
    lines blanked to spaces (newlines and offsets kept), and the comments
    as ``(line, text)``."""
    out = list(text)
    comments: List[Tuple[int, str]] = []
    i, n, line = 0, len(text), 1
    line_start = True
    while i < n:
        c = text[i]
        if c == "\n":
            line += 1
            line_start = True
            i += 1
            continue
        if line_start and c == "#":          # a preprocessor line
            j = i
            while j < n and text[j] != "\n":
                if text[j] == "\\" and j + 1 < n and text[j + 1] == "\n":
                    j += 2
                    line += 1
                    continue
                j += 1
            for k in range(i, j):
                if out[k] != "\n":
                    out[k] = " "
            i = j
            continue
        if not c.isspace():
            line_start = False
        if text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            comments.append((line, text[i:j]))
            for k in range(i, j):
                out[k] = " "
            i = j
            continue
        if text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            comments.append((line, text[i:j]))
            for k in range(i, j):
                if text[k] == "\n":
                    line += 1
                else:
                    out[k] = " "
            i = j
            continue
        if c in "\"'":
            j = i + 1
            while j < n and text[j] != c and text[j] != "\n":
                j += 2 if text[j] == "\\" else 1
            for k in range(i + 1, min(j, n)):
                out[k] = " "
            i = j + 1
            continue
        i += 1
    return "".join(out), comments


def tokenize(code: str) -> List[Tok]:
    toks = []
    for m in _TOKEN.finditer(code):
        kind = m.lastgroup
        if kind != "ws":
            toks.append(Tok(kind, m.group(), m.start()))
    return toks


# ---------------------------------------------------------------------------
# scopes
# ---------------------------------------------------------------------------

_CONTROL = {"if", "for", "while", "switch", "else", "do", "try", "catch",
            "return"}


@dataclasses.dataclass
class Param:
    name: str
    type: str       # the type's tokens joined with spaces
    pointer: bool


@dataclasses.dataclass
class Scope:
    kind: str                      # "namespace", "struct", "function",
                                   # "block"
    name: str
    ns: Tuple[str, ...]            # enclosing namespaces, outermost first
    start: int                     # token index after "{"
    end: int = -1                  # token index of the matching "}"
    head: Tuple[int, int] = (0, 0)  # token range of the head
    template: List[Tuple[str, str]] = dataclasses.field(
        default_factory=list)      # (kind, name): "typename" or a type
    params: List[Param] = dataclasses.field(default_factory=list)
    quals: Tuple[str, ...] = ()
    launch_bounds: Tuple[str, ...] = ()
    parent: Optional["Scope"] = None
    children: List["Scope"] = dataclasses.field(default_factory=list)


def _match(toks: Sequence[Tok], i: int, open_: str, close: str) -> int:
    """Index of the token closing the group opened at ``i``."""
    depth = 0
    for j in range(i, len(toks)):
        t = toks[j].text
        if t == open_:
            depth += 1
        elif t == close:
            depth -= 1
            if depth == 0:
                return j
    raise ValueError(f"unbalanced {open_!r} at offset {toks[i].pos}")


def _match_angle(toks: Sequence[Tok], i: int) -> int:
    """Index of the ``>`` closing the template list opened at ``i``
    (``>>`` closes two; parentheses nest)."""
    depth, paren = 0, 0
    for j in range(i, len(toks)):
        t = toks[j].text
        if t in "([":
            paren += 1
        elif t in ")]":
            paren -= 1
        elif paren == 0 and t == "<":
            depth += 1
        elif paren == 0 and t in (">", ">>", ">>>"):
            depth -= len(t)
            if depth <= 0:
                return j
        elif paren == 0 and t in (";", "{", "}"):
            break
    raise ValueError(f"unbalanced template list at offset {toks[i].pos}")


def split_top(toks: Sequence[Tok], sep: str = ",") -> List[List[Tok]]:
    """``toks`` split at ``sep`` outside (), [], {} and template lists
    (``<`` right after a name opens one when a matching ``>`` closes it
    before a ``;``)."""
    parts, cur, depth = [], [], 0
    angle = 0
    for k, t in enumerate(toks):
        if t.text in "([{":
            depth += 1
        elif t.text in ")]}":
            depth -= 1
        elif t.text == "<" and k and toks[k - 1].kind == "id":
            angle += 1
        elif t.text in (">", ">>") and angle:
            angle = max(0, angle - len(t.text))
        if t.text == sep and depth == 0 and angle == 0:
            parts.append(cur)
            cur = []
        else:
            cur.append(t)
    parts.append(cur)
    return parts


def _parse_params(toks: Sequence[Tok]) -> List[Param]:
    out = []
    for part in split_top(list(toks)):
        ids = [t for t in part if t.kind == "id"]
        if not ids or [t.text for t in part] == ["void"]:
            continue
        cut = next((k for k, t in enumerate(part) if t.text == "="),
                   len(part))
        decl = part[:cut]
        names = [t for t in decl if t.kind == "id"]
        name = names[-1].text
        type_toks = [t.text for t in decl[:-1]]
        out.append(Param(name=name, type=" ".join(type_toks),
                         pointer="*" in type_toks or "&" in type_toks))
    return out


def _template_list(toks: Sequence[Tok], i: int) -> Tuple[list, int]:
    """``template <...>`` at ``i``: its (kind, name) list and the index
    after it."""
    end = _match_angle(toks, i + 1)
    params = []
    for part in split_top(list(toks[i + 2:end])):
        ids = [t.text for t in part if t.kind == "id"]
        if ids:
            params.append((ids[0] if len(ids) > 1 else "typename", ids[-1]))
    return params, end + 1


def _classify(toks: Sequence[Tok], a: int, b: int, parent: Scope,
              start: int) -> Scope:
    """The scope opened by the ``{`` at ``b``, whose head is ``toks[a:b]``."""
    head = list(toks[a:b])
    ns = parent.ns + ((parent.name,) if parent.kind == "namespace"
                      and parent.name is not None else ())
    ns = tuple(x for x in ns if x is not None)
    texts = [t.text for t in head]
    mk = lambda kind, name="", **kw: Scope(kind=kind, name=name, ns=ns,
                                           start=start, head=(a, b),
                                           parent=parent, **kw)
    if texts[:1] == ["namespace"] or texts[:2] == ["inline", "namespace"]:
        k = texts.index("namespace")
        name = texts[k + 1] if k + 1 < len(texts) else ""
        return mk("namespace", name)
    if texts[:1] == ["extern"] and len(texts) == 2 and head[1].kind == "str":
        return mk("namespace", None)
    template, k = [], 0
    if texts[:1] == ["template"] and len(texts) > 1 and texts[1] == "<":
        template, k = _template_list(head, 0)
    rest = texts[k:]
    if rest[:1] and rest[0] in ("struct", "class", "union") \
            and "(" not in rest and "=" not in rest:
        return mk("struct", rest[1] if len(rest) > 1 else "",
                  template=template)
    if not rest or rest[0] in _CONTROL or "=" in rest[:1]:
        return mk("block")
    trail = len(head)
    while trail > k and texts[trail - 1] in ("const", "noexcept", "override",
                                             "mutable"):
        trail -= 1
    if trail <= k or texts[trail - 1] != ")" or parent.kind == "function" \
            or parent.kind == "block":
        return mk("block")
    depth, op = 0, None
    for j in range(trail - 1, k - 1, -1):
        if texts[j] == ")":
            depth += 1
        elif texts[j] == "(":
            depth -= 1
            if depth == 0:
                op = j
                break
    if op is None or op == k or head[op - 1].kind != "id":
        return mk("block")
    name = texts[op - 1]
    if "=" in texts[k:op] or "[" in texts[k:op]:
        return mk("block")
    quals = tuple(t for t in texts[k:op] if t.startswith("__")
                  or t in ("inline", "static", "extern"))
    bounds: Tuple[str, ...] = ()
    if "__launch_bounds__" in texts[k:op]:
        lb = texts.index("__launch_bounds__", k)
        lend = _match(head, lb + 1, "(", ")")
        bounds = tuple(" ".join(t.text for t in part)
                       for part in split_top(head[lb + 2:lend]))
    return mk("function", name, template=template,
              params=_parse_params(head[op + 1:trail - 1]), quals=quals,
              launch_bounds=bounds)


def build_scopes(toks: Sequence[Tok]) -> Scope:
    root = Scope(kind="namespace", name=None, ns=(), start=0,
                 end=len(toks))
    stack = [root]
    head_start, paren = 0, 0
    i = 0
    while i < len(toks):
        t = toks[i].text
        if t in "([":
            paren += 1
        elif t in ")]":
            paren -= 1
        elif t == "{" and paren == 0:
            cur = stack[-1]
            prev = toks[i - 1] if i else None
            is_init = (prev is not None and i - 1 >= head_start
                       and (prev.kind in ("id", "num")
                            and toks[head_start].text not in _CONTROL
                            and toks[head_start].text not in (
                                "namespace", "struct", "class", "union",
                                "template", "inline", "extern", "do",
                                "else", "try")
                            or prev.text in ("=", ",", "(", "{", "return")))
            if is_init and cur.kind in ("function", "block"):
                i = _match(toks, i, "{", "}") + 1
                continue
            if is_init and cur.kind in ("namespace", "struct") and \
                    prev.text in ("=", ","):
                i = _match(toks, i, "{", "}") + 1
                continue
            scope = _classify(toks, head_start, i, cur, i + 1)
            cur.children.append(scope)
            stack.append(scope)
            head_start = i + 1
        elif t == "}" and paren == 0:
            if len(stack) > 1:
                stack.pop().end = i
            head_start = i + 1
        elif t == ";" and paren == 0:
            head_start = i + 1
        elif t == ":" and paren == 0 and i and toks[i - 1].text in (
                "public", "private", "protected") \
                and stack[-1].kind == "struct":
            head_start = i + 1
        i += 1
    return root


def walk_scopes(scope: Scope):
    yield scope
    for c in scope.children:
        yield from walk_scopes(c)


def direct_statements(toks: Sequence[Tok], scope: Scope
                      ) -> List[Tuple[int, int]]:
    """Token ranges of the statements directly in ``scope`` that end with
    ``;`` (a child scope's braces are skipped; an initializer's are kept)."""
    spans = []
    a = scope.start
    i = scope.start
    end = scope.end
    kids = {c.head[1]: c.end for c in scope.children}
    paren = 0
    while i < end:
        t = toks[i].text
        if i in kids:
            i = kids[i] + 1
            a = i
            continue
        if t in "([":
            paren += 1
        elif t in ")]":
            paren -= 1
        elif t == "{" and paren == 0:
            i = _match(toks, i, "{", "}") + 1
            continue
        elif t == ";" and paren == 0:
            spans.append((a, i))
            a = i + 1
        i += 1
    return spans


# ---------------------------------------------------------------------------
# constant expressions
# ---------------------------------------------------------------------------

class Unresolved(ValueError):
    """A name or form the evaluator does not know."""


@dataclasses.dataclass(frozen=True)
class TypeVal:
    name: str
    args: tuple = ()


_SIZEOF = {
    "char": 1, "bool": 1, "uint8_t": 1, "int8_t": 1,
    "short": 2, "half": 2, "__half": 2, "bf16": 2, "__nv_bfloat16": 2,
    "int": 4, "unsigned": 4, "float": 4, "uint32_t": 4, "int32_t": 4,
    "double": 8, "long": 8, "size_t": 8, "uint64_t": 8, "int64_t": 8,
    "float2": 8, "float4": 16, "int4": 16, "uint4": 16,
    "__nv_bfloat162": 4, "CUtensorMap": 128,
}
_INT_TYPES = {"int", "long", "unsigned", "size_t", "uint32_t", "int32_t",
              "uint64_t", "int64_t", "short", "char"}
_CASTS = {"static_cast", "reinterpret_cast", "const_cast"}


def _num(text: str):
    t = text.rstrip("uUlL")
    if t.lower().startswith("0x"):
        return int(t, 16)
    if any(c in t for c in ".eE") or text.endswith(("f", "F")):
        return float(t.rstrip("fF"))
    return int(t)


def _cdiv(a, b):
    if isinstance(a, int) and isinstance(b, int):
        q = abs(a) // abs(b)
        return q if (a >= 0) == (b >= 0) else -q
    return a / b


def _cmod(a, b):
    return a - _cdiv(a, b) * b


_BINOPS = [
    ("||",), ("&&",), ("|",), ("^",), ("&",), ("==", "!="),
    ("<", ">", "<=", ">="), ("<<", ">>"), ("+", "-"), ("*", "/", "%"),
]


class Evaluator:
    """Evaluates the constant expressions of one source (and the headers it
    includes from the same directory) at given bindings."""

    def __init__(self, model: "CudaSource"):
        self.m = model

    # -- parsing -------------------------------------------------------------

    def parse(self, toks: Sequence[Tok]):
        self._t = [t for t in toks if t.text != "__align__"]
        self._i = 0
        node = self._ternary()
        if self._i != len(self._t):
            raise Unresolved("trailing tokens: "
                             + " ".join(t.text for t in self._t[self._i:]))
        return node

    def _peek(self, k: int = 0) -> Optional[str]:
        j = self._i + k
        return self._t[j].text if j < len(self._t) else None

    def _take(self, want: Optional[str] = None) -> Tok:
        if self._i >= len(self._t):
            raise Unresolved("unexpected end of expression")
        t = self._t[self._i]
        if want is not None and t.text != want:
            raise Unresolved(f"expected {want!r}, got {t.text!r}")
        self._i += 1
        return t

    def _ternary(self):
        cond = self._binary(0)
        if self._peek() == "?":
            self._take()
            a = self._ternary()
            self._take(":")
            b = self._ternary()
            return ("?", cond, a, b)
        return cond

    def _binary(self, level: int):
        if level == len(_BINOPS):
            return self._unary()
        node = self._binary(level + 1)
        while self._peek() in _BINOPS[level]:
            op = self._take().text
            node = ("bin", op, node, self._binary(level + 1))
        return node

    def _is_type_start(self) -> bool:
        k = 0
        while self._peek(k) in ("const", "unsigned", "signed", "long"):
            k += 1
        t = self._peek(k)
        if k and t == ")":
            return True                          # "(long long)", "(unsigned)"
        return t is not None and (t in _SIZEOF or t in _INT_TYPES)

    def _unary(self):
        t = self._peek()
        if t in ("-", "+", "!", "~"):
            self._take()
            return ("un", t, self._unary())
        if t == "sizeof":
            self._take()
            self._take("(")
            ty = self._type_until(")")
            self._take(")")
            return ("sizeof", ty)
        if t == "(":
            save = self._i
            self._take()
            if self._is_type_start():
                ty = self._type_until(")")
                if self._peek() == ")":
                    self._take()
                    return ("cast", ty, self._unary())
            self._i = save
        return self._postfix(self._primary())

    def _type_until(self, stop: str):
        parts = []
        while self._peek() is not None and self._peek() != stop:
            parts.append(self._take().text)
        return " ".join(p for p in parts if p not in ("const", "volatile"))

    def _template_args(self):
        self._take("<")
        args, cur, depth = [], [], 0
        while True:
            t = self._take()
            if t.text == "<":
                depth += 1
            elif t.text in (">", ">>"):
                n = len(t.text)
                if depth - n < 0:
                    if n == 2 and depth == 1:   # ">>" closes ours and one
                        cur.append(Tok("op", ">", t.pos))
                    break
                depth -= n
            if t.text == "," and depth == 0:
                args.append(cur)
                cur = []
                continue
            cur.append(t)
        args.append(cur)
        return [a for a in args if a]

    def _primary(self):
        t = self._take()
        if t.kind == "num":
            return ("num", _num(t.text))
        if t.text == "(":
            node = self._ternary()
            self._take(")")
            return node
        if t.text in ("true", "false"):
            return ("num", 1 if t.text == "true" else 0)
        if t.kind != "id" and t.text != "::":
            raise Unresolved(f"unexpected token {t.text!r}")
        parts = [t.text] if t.kind == "id" else []
        if t.text == "::":
            parts.append(self._take().text)
        targs = None
        while True:
            if self._peek() == "<" and (parts[-1] in _CASTS
                                        or self.m.is_template(parts[-1])):
                targs = self._template_args()
                if parts[-1] in _CASTS:
                    self._take("(")
                    inner = self._ternary()
                    self._take(")")
                    ty = " ".join(x.text for x in targs[0])
                    return ("cast", ty, inner)
            if self._peek() == "::":
                self._take()
                parts = [("tmpl", tuple(parts), targs)] if targs else parts
                targs = None
                parts.append(self._take().text)
                continue
            break
        return ("name", tuple(parts), targs)

    def _postfix(self, node):
        while True:
            t = self._peek()
            if t == "(":
                self._take()
                args = []
                if self._peek() != ")":
                    while True:
                        args.append(self._ternary())
                        if self._peek() == ",":
                            self._take()
                            continue
                        break
                self._take(")")
                node = ("call", node, args)
            elif t == ".":
                self._take()
                node = ("member", node, self._take().text)
            elif t == "[":
                self._take()
                idx = self._ternary()
                self._take("]")
                node = ("index", node, idx)
            else:
                return node

    # -- evaluation ------------------------------------------------------------

    def eval_tokens(self, toks: Sequence[Tok], env: "Env"):
        return self.eval(self.parse(toks), env)

    def eval_text(self, text: str, env: "Env"):
        return self.eval_tokens(tokenize(strip_source(text)[0]), env)

    def eval(self, node, env: "Env"):
        kind = node[0]
        if kind == "num":
            return node[1]
        if kind == "?":
            return self.eval(node[2] if self.eval(node[1], env)
                             else node[3], env)
        if kind == "un":
            v = self.eval(node[2], env)
            return {"-": lambda: -v, "+": lambda: v, "!": lambda: int(not v),
                    "~": lambda: ~v}[node[1]]()
        if kind == "bin":
            op = node[1]
            a = self.eval(node[2], env)
            if op == "&&":
                return int(bool(a) and bool(self.eval(node[3], env)))
            if op == "||":
                return int(bool(a) or bool(self.eval(node[3], env)))
            b = self.eval(node[3], env)
            return {
                "*": lambda: a * b, "/": lambda: _cdiv(a, b),
                "%": lambda: _cmod(a, b), "+": lambda: a + b,
                "-": lambda: a - b, "<<": lambda: a << b,
                ">>": lambda: a >> b, "<": lambda: int(a < b),
                ">": lambda: int(a > b), "<=": lambda: int(a <= b),
                ">=": lambda: int(a >= b), "==": lambda: int(a == b),
                "!=": lambda: int(a != b), "&": lambda: a & b,
                "|": lambda: a | b, "^": lambda: a ^ b,
            }[op]()
        if kind == "sizeof":
            return self.sizeof(node[1], env)
        if kind == "cast":
            v = self.eval(node[2], env)
            base = node[1].replace("*", "").split()
            if "*" in node[1]:
                return v
            if base and (base[-1] in _INT_TYPES or base[-1] == "long"):
                return int(v)
            if base and base[-1] in ("float", "double"):
                return float(v)
            return v
        if kind == "name":
            return env.lookup(node[1], node[2])
        if kind == "member":
            obj = self.eval(node[1], env)
            if isinstance(obj, dict):
                if node[2] not in obj:
                    raise Unresolved(f"no member {node[2]}")
                return obj[node[2]]
            if isinstance(obj, TypeVal):
                return self.member(obj, node[2], env)
            raise Unresolved(f".{node[2]} of {obj!r}")
        if kind == "index":
            obj = self.eval(node[1], env)
            idx = self.eval(node[2], env)
            if isinstance(obj, dict) and idx in obj:
                return obj[idx]
            raise Unresolved(f"index {idx} of {obj!r}")
        if kind == "call":
            fn = node[1]
            if fn[0] != "name":
                raise Unresolved("call of an expression")
            args = [self.eval(a, env) for a in node[2]]
            return self.call(fn[1], fn[2], args, env)
        raise Unresolved(f"node {kind}")

    def sizeof(self, ty: str, env: "Env") -> int:
        words = [w for w in ty.replace("*", " * ").split()
                 if w not in ("const", "volatile", "unsigned", "signed")]
        if "*" in words:
            return 8
        if not words:
            return 4
        name = words[-1].split("::")[-1]
        if name in _SIZEOF:
            return 8 if words.count("long") >= 1 and name == "long" \
                else _SIZEOF[name]
        v = env.lookup((name,), None)
        if isinstance(v, TypeVal) and v.name.split("::")[-1] in _SIZEOF:
            return _SIZEOF[v.name.split("::")[-1]]
        raise Unresolved(f"sizeof({ty})")

    def type_of(self, toks: Sequence[Tok], env: "Env") -> TypeVal:
        """A type named by ``toks`` (``Tile<128, 64, 8, 4>``, ``float``,
        an alias), its template arguments evaluated."""
        words = [t for t in toks if t.text not in (
            "const", "typename", "struct", "class", "volatile")]
        if not words:
            raise Unresolved("empty type")
        lt = next((k for k, t in enumerate(words) if t.text == "<"), None)
        name_toks = words if lt is None else words[:lt]
        name = "".join(t.text for t in name_toks)
        if lt is None:
            bare = name.split("::")[-1]
            if bare in _SIZEOF or bare in _INT_TYPES:
                return TypeVal(bare)
            try:
                v = env.lookup(tuple(name.split("::")), None)
            except Unresolved:
                v = None
            if isinstance(v, TypeVal):
                return v
            if self.m.struct(bare) is not None:
                return TypeVal(bare)
            raise Unresolved(f"type {name}")
        end = _match_angle(words, lt)
        args = []
        for part in split_top(words[lt + 1:end]):
            args.append(self.template_arg(part, env))
        return TypeVal(name.split("::")[-1], tuple(args))

    def template_arg(self, toks: Sequence[Tok], env: "Env"):
        try:
            return self.type_of(toks, env)
        except Unresolved:
            return self.eval_tokens(toks, env)

    def member(self, ty: TypeVal, name: str, env: "Env"):
        st = self.m.struct(ty.name)
        if st is None:
            raise Unresolved(f"{ty.name}::{name}")
        decls = self.m.struct_decls(st)
        if name not in decls:
            raise Unresolved(f"{ty.name}::{name}")
        bind = {p[1]: a for p, a in zip(st.template, ty.args)}
        inner = Env(self, st, bind, decls)
        return inner.lookup((name,), None)

    def call(self, parts, targs, args, env: "Env"):
        name = parts[-1] if isinstance(parts[-1], str) else None
        if name in ("min", "max") and len(args) == 2:
            return min(args) if name == "min" else max(args)
        fn = self.m.function(name) if name else None
        if fn is None:
            raise Unresolved(f"call of {name}")
        bind = {p.name: a for p, a in zip(fn.params, args)}
        if targs:
            for (_, tname), ta in zip(fn.template, targs):
                bind[tname] = self.template_arg(ta, env)
        return self.run(fn, bind)

    def run(self, fn: Scope, bind: Dict):
        """Run a straight-line function: declarations, assignments to
        locals and their members, and one ``return``."""
        toks = fn._src.toks
        local = dict(bind)
        env = Env(self, fn, local, {})
        if fn.children:
            raise Unresolved(f"{fn.name} is not straight-line")
        for a, b in direct_statements(toks, fn):
            st = toks[a:b]
            texts = [t.text for t in st]
            if texts[:1] == ["return"]:
                return self.eval_tokens(st[1:], env)
            eq = next((k for k, x in enumerate(texts) if x == "="), None)
            if eq is None:                       # "Plan pl;"
                if len(st) >= 2 and st[-1].kind == "id":
                    local[st[-1].text] = {}
                    continue
                raise Unresolved(f"statement {' '.join(texts)}")
            lhs = st[:eq]
            value = self.eval_tokens(st[eq + 1:], env)
            if len(lhs) == 1 or lhs[-1].kind == "id" and lhs[-2].text != ".":
                local[lhs[-1].text] = value         # a declaration
                continue
            self._assign(lhs, value, local, env)
        raise Unresolved(f"{fn.name} returns nothing")

    def _assign(self, lhs, value, local, env):
        """``a.b = v`` or ``a.b[i] = v`` on a local struct."""
        obj = local.setdefault(lhs[0].text, {})
        k = 1
        while k < len(lhs):
            if lhs[k].text == ".":
                key = lhs[k + 1].text
                k += 2
            elif lhs[k].text == "[":
                close = _match(lhs, k, "[", "]")
                key = self.eval_tokens(lhs[k + 1:close], env)
                k = close + 1
            else:
                raise Unresolved("assignment target")
            if k >= len(lhs):
                obj[key] = value
                return
            obj = obj.setdefault(key, {})


class Env:
    """Name lookup: the given bindings, then the scope's own declarations
    (evaluated when first asked for), then each enclosing scope's, then
    the file's namespaces (the innermost first, then any that holds the
    name once)."""

    def __init__(self, ev: Evaluator, scope: Optional[Scope], bind: Dict,
                 decls: Dict[str, Tuple[str, List[Tok]]]):
        self.ev, self.scope, self.bind, self.decls = ev, scope, bind, decls
        self.cache: Dict[str, object] = {}

    def lookup(self, parts, targs):
        ev, m = self.ev, self.ev.m
        if isinstance(parts[0], tuple):          # Tmpl<args>::member
            _, tparts, args = parts[0]
            ty = TypeVal(tparts[-1], tuple(ev.template_arg(a, self)
                                           for a in args))
            v = ty
            for p in parts[1:]:
                v = ev.member(v, p, self)
            return v
        if targs is not None:
            ty = TypeVal(parts[-1], tuple(ev.template_arg(a, self)
                                          for a in targs))
            return ty
        head = parts[0]
        if len(parts) > 1:
            # a namespace path or a type's member: the last name in the
            # scope named by the others
            try:
                first = self.lookup((head,), None)
            except Unresolved:
                first = None
            if isinstance(first, TypeVal):
                v = first
                for p in parts[1:]:
                    v = ev.member(v, p, self)
                return v
            st = m.struct(parts[-2])
            if st is not None:
                return ev.member(TypeVal(parts[-2]), parts[-1], self)
            return m.constant(parts[-1], tuple(parts[:-1]), self.ev)
        if head in self.bind:
            return self.bind[head]
        if head in self.cache:
            return self.cache[head]
        if head in self.decls:
            kind, toks = self.decls[head]
            self.cache[head] = None
            v = (ev.type_of(toks, self) if kind == "type"
                 else ev.eval_tokens(toks, self))
            self.cache[head] = v
            return v
        scope = self.scope.parent if self.scope is not None else None
        while scope is not None and scope.kind != "namespace":
            if scope.kind in ("function", "struct", "block"):
                decls = m.local_decls(scope) if scope.kind != "struct" \
                    else m.struct_decls(scope)
                if head in decls:
                    return Env(ev, scope, {}, decls).lookup(parts, targs)
            scope = scope.parent
        return m.constant(head, None, ev, prefer=self._ns())

    def _ns(self) -> Tuple[str, ...]:
        s = self.scope
        while s is not None and s.kind != "namespace":
            s = s.parent
        if s is None:
            return ()
        return s.ns + ((s.name,) if s.name else ())


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

_GATE = re.compile(r"^(?:(\w+) \. )?active != nullptr && (?:\1 \. )?active "
                   r"\[ .+ \] == 0$")
_LOAD_CALLS = re.compile(r"^(?:wgmma\w*|warp_mma|mma\w*|cp_async\w*|"
                         r"tma_load\w*)$")
_LOAD_ASM = re.compile(r"cp\.async|wgmma\.mma_async|mma\.sync|"
                       r"cp\.async\.bulk|ld\.global")
_ATOMIC_CALL = re.compile(r"^(?:atomic[A-Z]\w*|__atomic\w*|atomic_ref)$")
_ATOMIC_ASM = re.compile(r"\b(?:atom|red)\.")


@dataclasses.dataclass
class Launch:
    kernel: str
    line: int
    grid_rank: Optional[int]
    targs: List[List[Tok]]
    smem: List[Tok]            # the dynamic shared-memory argument
    scope: Scope               # the function that launches


@dataclasses.dataclass
class Kernel:
    name: str
    line: int
    scope: Scope
    template: List[Tuple[str, str]]
    launch_bounds: Tuple[str, ...]
    params: List[Param]
    block_axes: Tuple[str, ...]
    gate_line: Optional[int]          # the lane-predicate test
    gate_exits: bool                  # a return under it
    gate_writes: Tuple[str, ...]      # names it writes zeros to
    first_load_line: Optional[int]
    first_load_what: str
    gated_before_load: bool           # the test and its return come first
    static_shared: List[Tuple[str, str, List[List[Tok]]]]   # (name, type,
                                                            # dims)
    dynamic_shared: bool
    atomics: List[Tuple[int, str]]
    launches: List[Launch] = dataclasses.field(default_factory=list)


class CudaSource:
    """One CUDA file and the ``csrc`` headers it includes."""

    def __init__(self, relpath: str, text: str,
                 headers: Sequence[Tuple[str, str]] = ()):
        self.relpath = relpath
        self.text = text
        self.code, self.comments = strip_source(text)
        self.toks = tokenize(self.code)
        self.root = build_scopes(self.toks)
        for sc in walk_scopes(self.root):
            sc._src = self
        self.headers = [CudaSource(name, htext) for name, htext in headers]
        self._lines = _line_starts(text)
        self._decl_cache: Dict[int, Dict] = {}
        self.ev = Evaluator(self)
        self.kernels = [self._kernel(s) for s in walk_scopes(self.root)
                        if s.kind == "function" and "__global__" in s.quals]
        self._find_launches()

    # -- symbols ---------------------------------------------------------------

    def line_of(self, pos: int) -> int:
        import bisect
        return bisect.bisect_right(self._lines, pos)

    def tok_line(self, i: int) -> int:
        return self.line_of(self.toks[i].pos)

    def _sources(self):
        return [self] + self.headers

    def is_template(self, name: str) -> bool:
        for src in self._sources():
            for s in walk_scopes(src.root):
                if s.name == name and s.template and s.kind in (
                        "struct", "function"):
                    return True
        return False

    def struct(self, name: str) -> Optional[Scope]:
        for src in self._sources():
            for s in walk_scopes(src.root):
                if s.kind == "struct" and s.name == name:
                    s._src = src
                    return s
        return None

    def function(self, name: str) -> Optional[Scope]:
        for src in self._sources():
            for s in walk_scopes(src.root):
                if s.kind == "function" and s.name == name:
                    s._src = src
                    return s
        return None

    def _decls(self, scope: Scope, src=None) -> Dict:
        src = src or getattr(scope, "_src", self)
        key = id(scope)
        if key in src._decl_cache:
            return src._decl_cache[key]
        out: Dict[str, Tuple[str, List[Tok]]] = {}
        for a, b in direct_statements(src.toks, scope):
            st = src.toks[a:b]
            texts = [t.text for t in st]
            if texts[:1] == ["using"] and len(texts) > 3 and texts[2] == "=":
                out[texts[1]] = ("type", st[3:])
                continue
            if texts[:1] == ["template"]:
                continue
            # [static] [const|constexpr] TYPE NAME = expr (, NAME = expr)*
            if "=" not in texts or texts[0] in _CONTROL:
                continue
            first = texts.index("=")
            if first < 2 or texts[first - 1] in ("]", ")") or \
                    st[first - 1].kind != "id" or "." in texts[:first] \
                    or "[" in texts[:first] or "*" in texts[:first] \
                    or "&" in texts[:first]:
                continue
            decl_start = first - 1
            pieces = [st[decl_start:]]
            # split "A = x, B = y" at commas followed by "NAME ="
            out_pieces, cur, depth = [], [], 0
            body = pieces[0]
            for k, t in enumerate(body):
                if t.text in "([{":
                    depth += 1
                elif t.text in ")]}":
                    depth -= 1
                if (t.text == "," and depth == 0 and k + 2 < len(body)
                        and body[k + 1].kind == "id"
                        and body[k + 2].text == "="):
                    out_pieces.append(cur)
                    cur = []
                    continue
                cur.append(t)
            out_pieces.append(cur)
            for piece in out_pieces:
                if len(piece) >= 3 and piece[1].text == "=":
                    out[piece[0].text] = ("value", piece[2:])
        src._decl_cache[key] = out
        return out

    def struct_decls(self, scope: Scope) -> Dict:
        return self._decls(scope)

    def local_decls(self, scope: Scope) -> Dict:
        """The declarations of a function body at any depth, the first of
        each name."""
        src = getattr(scope, "_src", self)
        out: Dict = {}
        for s in walk_scopes(scope):
            for k, v in self._decls(s, src).items():
                out.setdefault(k, v)
        return out

    def constant(self, name: str, qual: Optional[Tuple[str, ...]],
                 ev: Evaluator, prefer: Tuple[str, ...] = ()):
        """A namespace-scope ``constexpr`` or alias: the one in the
        innermost namespace of ``prefer`` that has it, else the only one in
        the file and its headers (``qual`` narrows by namespace)."""
        found = []
        for src in self._sources():
            for s in walk_scopes(src.root):
                if s.kind != "namespace":
                    continue
                path = s.ns + ((s.name,) if s.name else ())
                if qual and tuple(path[-len(qual):]) != tuple(qual):
                    continue
                d = self._decls(s, src)
                if name in d:
                    found.append((path, s, src, d[name]))
        if not found:
            if self.struct(name) is not None:
                return TypeVal(name)
            raise Unresolved(f"name {name}")
        best = None
        for cand in found:
            if tuple(prefer[:len(cand[0])]) == tuple(cand[0]):
                if best is None or len(cand[0]) > len(best[0]):
                    best = cand
        if best is None:
            if len(found) > 1:
                raise Unresolved(f"name {name} is ambiguous")
            best = found[0]
        path, scope, src, (kind, toks) = best
        scope._src = src
        env = Env(ev, scope, {}, {})
        return ev.type_of(toks, env) if kind == "type" \
            else ev.eval_tokens(toks, env)

    # -- kernels ---------------------------------------------------------------

    def _body_statements(self, scope: Scope) -> List[Tuple[int, int]]:
        """Every simple statement of a body in order: split at ``;`` and
        at the braces of child scopes (a control head such as
        ``if (...)`` is a statement of its own)."""
        toks = self.toks
        spans, a, paren = [], scope.start, 0
        i = scope.start
        heads = {}
        for s in walk_scopes(scope):
            if s is not scope:
                heads[s.head[1]] = s
        while i < scope.end:
            t = toks[i].text
            if t in "([":
                paren += 1
            elif t in ")]":
                paren -= 1
            if paren == 0 and (i in heads or t == "}" or t == ";"):
                if i > a:
                    spans.append((a, i))
                a = i + 1
            elif paren == 0 and t == ")" and toks[a].text in (
                    "if", "for", "while") and _match(toks, a + 1, "(",
                                                     ")") == i:
                spans.append((a, i + 1))         # a control head alone
                a = i + 1
            i += 1
        if a < scope.end:
            spans.append((a, scope.end))
        return [(x, y) for x, y in spans if y > x]

    def _kernel(self, scope: Scope) -> Kernel:
        toks = self.toks
        body = range(scope.start, scope.end)
        axes = sorted({toks[i + 2].text for i in body
                       if toks[i].text == "blockIdx"
                       and toks[i + 1].text == "."})
        # the lane-predicate test and the statement under it
        gate = None
        for i in body:
            if toks[i].text == "if" and toks[i + 1].text == "(":
                close = _match(toks, i + 1, "(", ")")
                cond = " ".join(t.text for t in toks[i + 2:close])
                if _GATE.match(cond):
                    if toks[close + 1].text == "{":
                        gend = _match(toks, close + 1, "{", "}")
                    else:
                        gend = next(j for j in range(close + 1, scope.end)
                                    if toks[j].text == ";")
                    gate = (i, close + 1, gend)
                    break
        gate_exits = False
        writes: Tuple[str, ...] = ()
        if gate is not None:
            gate_exits = any(toks[j].text == "return"
                             for j in range(gate[1], gate[2] + 1))
            writes = tuple(sorted(self._zero_writes(gate[1], gate[2] + 1)))
        # global handles and the first load outside the gate
        ptr_fields = self._pointer_fields(scope)
        handles = {p.name for p in scope.params
                   if p.pointer or "CUtensorMap" in p.type}
        structs = {p.name: p.type.split()[-1] for p in scope.params
                   if not p.pointer and p.type.split()
                   and p.type.split()[-1] in ptr_fields}
        first, what = None, ""
        for a, b in self._body_statements(scope):
            if gate is not None and gate[0] <= a <= gate[2]:
                continue
            hit = self._load_in(a, b, handles, structs, ptr_fields)
            if hit is not None:
                first, what = hit
                break
        static, dynamic = [], False
        for a, b in self._body_statements(scope):
            texts = [t.text for t in toks[a:b]]
            if "__shared__" not in texts:
                continue
            if "extern" in texts:
                dynamic = True
                continue
            static.extend(self._shared_decl(toks[a:b]))
        k = Kernel(
            name=scope.name, line=self.tok_line(scope.head[0]), scope=scope,
            template=scope.template, launch_bounds=scope.launch_bounds,
            params=scope.params, block_axes=tuple(axes),
            gate_line=self.tok_line(gate[0]) if gate else None,
            gate_exits=gate_exits, gate_writes=writes,
            first_load_line=self.tok_line(first) if first is not None
            else None, first_load_what=what,
            gated_before_load=gate is not None and gate_exits and (
                first is None or gate[0] < first),
            static_shared=static, dynamic_shared=dynamic,
            atomics=self._atomics(scope))
        return k

    def _pointer_fields(self, kernel: Scope) -> Dict[str, set]:
        """struct name -> its pointer members (``const void* q``), the
        structs of the kernel's own namespace first."""
        out: Dict[str, set] = {}
        structs = [s for s in walk_scopes(self.root) if s.kind == "struct"]
        structs.sort(key=lambda s: s.ns == kernel.ns)
        for s in structs:
            names = set()
            for a, b in direct_statements(self.toks, s):
                texts = [t.text for t in self.toks[a:b]]
                if "*" in texts and "(" not in texts:
                    names.update(self.toks[k].text
                                 for k in range(a, b)
                                 if self.toks[k].kind == "id"
                                 and (k + 1 == b or self.toks[k + 1].text
                                      in (",", ";", "=")))
            out[s.name] = names
        return out

    def _mentions(self, a, b, handles, structs, ptr_fields):
        toks = self.toks
        out = []
        for k in range(a, b):
            t = toks[k]
            if t.kind != "id":
                continue
            if k > a and toks[k - 1].text in (".", "::", "->"):
                continue
            if t.text in handles:
                out.append((k, k))
            elif t.text in structs and k + 2 < b and \
                    toks[k + 1].text == "." and \
                    toks[k + 2].text in ptr_fields[structs[t.text]]:
                out.append((k, k + 2))
        return out

    def _load_in(self, a, b, handles, structs, ptr_fields):
        """The first load in statement ``toks[a:b]``, as (token index,
        what); a declaration of a pointer (or of an object holding one)
        from global handles adds the name to ``handles`` instead."""
        toks = self.toks
        texts = [t.text for t in toks[a:b]]
        for k in range(a, b):
            t = toks[k]
            if t.kind == "id" and _LOAD_CALLS.match(t.text) and \
                    k + 1 < b and toks[k + 1].text in ("(", "<"):
                return k, t.text
            if t.kind == "id" and t.text == "asm":
                close = _match(toks, k + 1 + (toks[k + 1].text == "volatile"),
                               "(", ")") if k + 1 < b else k
                if _LOAD_ASM.search(self.text[t.pos:toks[close].pos]):
                    return k, "asm"
        mentions = self._mentions(a, b, handles, structs, ptr_fields)
        if not mentions:
            return None
        # "T* name = <global> ..." or "Type name{<global> ...}"
        eq = next((k for k in range(a, b) if toks[k].text == "="), None)
        brace = next((k for k in range(a, b) if toks[k].text == "{"), None)
        if eq is not None and eq - 2 >= a and toks[eq - 1].kind == "id":
            j = eq - 2
            while j >= a and toks[j].text in ("const", "__restrict__"):
                j -= 1
            if j >= a and toks[j].text == "*" and all(
                    not self._is_read(m, a, b, eq) for m in mentions):
                handles.add(toks[eq - 1].text)
                return None
        if brace is not None and brace - 1 >= a and \
                toks[brace - 1].kind == "id" and (eq is None or eq > brace) \
                and brace - 2 >= a and toks[brace - 2].kind == "id":
            handles.add(toks[brace - 1].text)
            return None
        for m in mentions:
            if self._is_read(m, a, b, eq):
                return m[0], " ".join(texts[m[0] - a:m[1] - a + 1])
        return None

    def _is_read(self, m, a, b, eq) -> bool:
        """Whether the mention ``m`` (token span) reads through the handle:
        a subscript or dereference outside an assignment's target, or an
        argument of a call that is not a cast."""
        toks = self.toks
        first, last = m
        lhs = eq is not None and first < eq and toks[eq].text == "="
        nxt = toks[last + 1].text if last + 1 < b else ""
        if nxt in ("!=", "==") and last + 2 < b and \
                toks[last + 2].text == "nullptr":
            return False
        if first > a and toks[first - 1].text in ("!=", "==") and \
                toks[first - 2].text == "nullptr":
            return False
        if nxt == "[" and not lhs:
            return True
        if nxt == "[" and lhs:
            close = _match(toks, last + 1, "[", "]")
            return close + 1 != eq  # part of the target's index
        if first > a and toks[first - 1].text == "*" and (
                first - 1 == a or toks[first - 2].kind == "op"
                and toks[first - 2].text not in (")", "]")):
            return not lhs                       # *name
        # the innermost call, subscript or dereference around it
        depth = 0
        for k in range(first - 1, a - 1, -1):
            t = toks[k].text
            if t in (")", "]"):
                depth += 1
                continue
            if t not in ("(", "["):
                continue
            if depth:
                depth -= 1
                continue
            if t == "[":
                return not lhs
            callee = toks[k - 1] if k > a else None
            if callee is not None and callee.text == ">":
                callee = toks[_open_angle(toks, k - 1, a) - 1]
            if callee is not None and callee.kind == "id":
                if callee.text in _CASTS or callee.text in _SIZEOF:
                    continue                     # a cast: look further out
                return True                      # an argument of a call
            if callee is not None and callee.text == "*":
                return not lhs                   # *(name + off)
        return False

    def _zero_writes(self, a: int, b: int, depth: int = 0) -> set:
        """Names written only zeros in ``toks[a:b]``: ``n[...] = 0``,
        ``*n = make_float4(0.f, ...)``, or a device function called with
        ``n`` (``n + off``) in the place of a parameter it zeroes."""
        toks = self.toks
        out = set()
        for i in range(a, b):
            if toks[i].text != "=":
                continue
            j = i - 1
            if toks[j].text == "]":
                d = 0
                while j > a:
                    if toks[j].text == "]":
                        d += 1
                    elif toks[j].text == "[":
                        d -= 1
                        if d == 0:
                            break
                    j -= 1
                target = toks[j - 1]
            elif toks[j].kind == "id" and j > a and toks[j - 1].text == "*":
                target = toks[j]
            else:
                continue
            end = next(k for k in range(i, b + 1) if k == b
                       or toks[k].text == ";")
            if target.kind == "id" and _is_zero(toks[i + 1:end]):
                out.add(target.text)
        if depth < 2:
            for i in range(a, b - 1):
                fn = self.function(toks[i].text) if toks[i].kind == "id" \
                    else None
                if fn is None or "__global__" in fn.quals:
                    continue
                j = i + 1
                if toks[j].text == "<":
                    j = _match_angle(toks, j) + 1
                if j >= b or toks[j].text != "(":
                    continue
                close = _match(toks, j, "(", ")")
                args = split_top(toks[j + 1:close])
                src = getattr(fn, "_src", self)
                inner = src._zero_writes(fn.start, fn.end, depth + 1)
                for p, arg in zip(fn.params, args):
                    if p.name in inner and arg and arg[0].kind == "id":
                        out.add(arg[0].text)
        return out

    def _shared_decl(self, st: Sequence[Tok]):
        texts = [t.text for t in st]
        k = texts.index("__shared__") + 1
        if k < len(texts) and texts[k] == "__align__":
            k = _match(st, k + 1, "(", ")") + 1
        rest = st[k:]
        lb = next((j for j, t in enumerate(rest) if t.text == "["),
                  len(rest))
        name = rest[lb - 1].text
        ty = " ".join(t.text for t in rest[:lb - 1])
        dims = []
        j = lb
        while j < len(rest) and rest[j].text == "[":
            close = _match(rest, j, "[", "]")
            dims.append(list(rest[j + 1:close]))
            j = close + 1
        return [(name, ty, dims)]

    def _atomics(self, scope: Scope, seen=None) -> List[Tuple[int, str]]:
        """Atomics in ``scope``'s body and in the device functions of this
        file it calls, at any depth."""
        seen = set() if seen is None else seen
        seen.add(scope.name)
        toks = self.toks
        out = []
        for i in range(scope.start, scope.end):
            t = toks[i]
            if t.kind != "id":
                continue
            if _ATOMIC_CALL.match(t.text):
                out.append((self.tok_line(i), t.text))
            elif t.text == "asm":
                j = i + 1 + (toks[i + 1].text == "volatile")
                close = _match(toks, j, "(", ")")
                if _ATOMIC_ASM.search(self.text[t.pos:toks[close].pos]):
                    out.append((self.tok_line(i), "asm"))
            elif t.text not in seen and i + 1 < scope.end and \
                    toks[i + 1].text in ("(", "<"):
                for s in walk_scopes(self.root):
                    if s.kind == "function" and s.name == t.text and \
                            "__device__" in s.quals:
                        out.extend(self._atomics(s, seen))
        return sorted(set(out))

    def _find_launches(self):
        toks = self.toks
        by_name = {k.name: k for k in self.kernels}
        for s in walk_scopes(self.root):
            if s.kind != "function":
                continue
            for i in range(s.start, s.end):
                if toks[i].text != "<<<":
                    continue
                j = i - 1
                targs: List[List[Tok]] = []
                if toks[j].text == ">":
                    d = 0
                    while j > s.start:
                        if toks[j].text in (">", ">>"):
                            d += len(toks[j].text)
                        elif toks[j].text == "<":
                            d -= 1
                            if d == 0:
                                break
                        j -= 1
                    targs = split_top(toks[j + 1:i - 1])
                    j -= 1
                name = toks[j].text
                if name not in by_name:
                    continue
                close = next(k for k in range(i, s.end)
                             if toks[k].text == ">>>")
                args = split_top(toks[i + 1:close])
                rank = self._grid_rank(s, args[0], i)
                smem = args[2] if len(args) > 2 else []
                by_name[name].launches.append(Launch(
                    kernel=name, line=self.tok_line(i), grid_rank=rank,
                    targs=targs, smem=smem, scope=s))

    def _grid_rank(self, fn: Scope, arg: List[Tok], before: int
                   ) -> Optional[int]:
        toks = self.toks
        if len(arg) == 1 and arg[0].kind == "id":
            name = arg[0].text
            for k in range(before - 1, fn.start, -1):
                if toks[k].text == name and toks[k - 1].text == "dim3" and \
                        toks[k + 1].text in ("(", "{"):
                    close = _match(toks, k + 1, toks[k + 1].text,
                                   ")" if toks[k + 1].text == "(" else "}")
                    return len(split_top(toks[k + 2:close]))
            return 1 if name not in ("dim3",) else None
        if arg and arg[0].text == "dim3" and len(arg) > 1:
            close = _match(arg, 1, "(", ")")
            return len(split_top(arg[2:close]))
        return 1

    # -- shared memory ---------------------------------------------------------

    def kernel_env(self, kernel: Kernel, targs: Sequence) -> Env:
        bind = {name: v for (_, name), v in zip(kernel.template, targs)}
        return Env(self.ev, kernel.scope, bind, self.local_decls(
            kernel.scope))

    def static_shared_bytes(self, kernel: Kernel, targs: Sequence) -> int:
        env = self.kernel_env(kernel, targs)
        total = 0
        for _, ty, dims in kernel.static_shared:
            n = self.ev.sizeof(ty, env)
            for d in dims:
                n *= self.ev.eval_tokens(d, env)
            total += n
        return total

    def launch_bytes(self, launch: Launch, nominal: Dict) -> Tuple[int, tuple]:
        """(dynamic shared memory, the kernel's template arguments) of a
        launch, in the launching function's scope with ``nominal`` bound
        (a value, or the text of an expression or type)."""
        env = Env(self.ev, launch.scope, {}, self.local_decls(launch.scope))
        for k, v in nominal.items():
            if isinstance(v, str):
                try:
                    v = self.ev.type_of(tokenize(v), env)
                except Unresolved:
                    v = self.ev.eval_text(v, env)
            env.bind[k] = v
        dyn = self.ev.eval_tokens(launch.smem, env) if launch.smem else 0
        targs = tuple(self.ev.template_arg(t, env) for t in launch.targs)
        return int(dyn), targs

    def shared_bytes(self, kernel: Kernel, nominal: Dict) -> int:
        """Shared memory per CTA at ``nominal``: the kernel's static arrays
        and the largest dynamic size any of its launches passes."""
        best = None
        for launch in kernel.launches:
            dyn, targs = self.launch_bytes(launch, nominal)
            total = dyn + self.static_shared_bytes(kernel, targs)
            best = total if best is None else max(best, total)
        if best is None:
            raise Unresolved(f"{kernel.name} is never launched")
        return best

    def uses_shared(self) -> bool:
        """Whether any kernel of the file declares shared memory (a module
        that does gets the runtime's reserved 1 KB per CTA)."""
        return any(k.static_shared or k.dynamic_shared for k in self.kernels)


def _open_angle(toks: Sequence[Tok], j: int, lo: int) -> int:
    """Index of the ``<`` opening the template list closed at ``j``."""
    d = 0
    while j > lo:
        if toks[j].text in (">", ">>"):
            d += len(toks[j].text)
        elif toks[j].text == "<":
            d -= 1
            if d <= 0:
                return j
        j -= 1
    return j


def _is_zero(toks: Sequence[Tok]) -> bool:
    """An expression of zero literals, calls and template lists only:
    ``0.f``, ``from_f32<T>(0.f)``, ``make_float4(0.f, 0.f, 0.f, 0.f)``."""
    seen_zero = False
    for k, t in enumerate(toks):
        if t.kind == "num":
            try:
                if _num(t.text) != 0:
                    return False
            except ValueError:
                return False
            seen_zero = True
        elif t.kind == "id":
            nxt = toks[k + 1].text if k + 1 < len(toks) else ""
            inside = any(x.text == "<" for x in toks[:k]) and any(
                x.text == ">" for x in toks[k + 1:])
            if nxt not in ("(", "<", "::") and not inside:
                return False
        elif t.text not in ("(", ")", ",", "<", ">", "::"):
            return False
    return seen_zero


def _line_starts(text: str) -> List[int]:
    out = [0]
    for i, c in enumerate(text):
        if c == "\n":
            out.append(i + 1)
    return out


_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def load(path: str, relpath: str) -> CudaSource:
    """Read ``path`` and the ``"..."`` headers it includes from its own
    directory (followed through headers, each once)."""
    import os
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    base = os.path.dirname(path)
    headers, seen, todo = [], set(), list(_INCLUDE.findall(text))
    while todo:
        inc = todo.pop(0)
        hp = os.path.join(base, inc)
        if inc in seen or not os.path.exists(hp):
            continue
        seen.add(inc)
        with open(hp, "r", encoding="utf-8") as f:
            htext = f.read()
        headers.append((inc, htext))
        todo.extend(_INCLUDE.findall(htext))
    return CudaSource(relpath, text, headers)
