"""A Common Expression Language (CEL) subset for ResourceClaim selectors.

The paper (§III.A) leans on CEL as *the* mechanism for expressive user
intent: "Users request resources via ResourceClaim objects, using the
powerful Common Expression Language for selection." DRA evaluates one CEL
expression per selector against a ``device`` environment; the expression
must yield a bool.

This is a from-scratch lexer / Pratt parser / tree-walking evaluator for
the subset DRA actually uses:

* literals: int, float, string ('..' or ".."), bool, null, list, map
* member access ``a.b.c``, indexing ``a["k"]`` / ``a[0]``
* unary ``!`` ``-``; binary ``* / % + -``; comparisons
  ``== != < <= > >= in``; logical ``&&`` ``||`` (short-circuit);
  ternary ``cond ? x : y``
* calls: ``size(x)``, ``has(a.b)`` (presence macro), string methods
  ``startsWith/endsWith/contains/matches`` (also as functions),
  ``min/max/abs``, casts ``int/double/string/bool``,
  list macros ``l.exists(v, pred)`` / ``l.all(v, pred)`` /
  ``l.filter(v, pred)`` / ``l.map(v, expr)``

Comparison semantics over :class:`Quantity` / :class:`Version` follow their
rich-comparison dunders, so ``device.capacity["hbm"] >= "16Gi"`` works.

The port's own copy of the JAX package's ``core/cel.py`` (that module
imports no JAX, but the port imports nothing of that package).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from functools import lru_cache
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .attributes import AttributeSet, Quantity, Version

__all__ = ["CelError", "CelProgram", "compile_expr", "evaluate",
           "compile_cache_info", "compile_cache_clear"]


class CelError(Exception):
    """Raised on lex/parse/eval failure of a CEL expression."""


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<float>\d+\.\d+(?:[eE][+-]?\d+)?|\d+[eE][+-]?\d+)
  | (?P<int>\d+)
  | (?P<string>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op>\|\||&&|==|!=|<=|>=|[-+*/%!<>?:.,()\[\]{}])
    """,
    re.VERBOSE,
)

_KEYWORDS = {"true": True, "false": False, "null": None}


@dataclass(frozen=True)
class Token:
    kind: str  # 'float' | 'int' | 'string' | 'ident' | 'op' | 'eof'
    text: str
    pos: int


def _lex(src: str) -> List[Token]:
    tokens: List[Token] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise CelError(f"unexpected character {src[pos]!r} at {pos} in {src!r}")
        pos = m.end()
        kind = m.lastgroup or ""
        if kind == "ws":
            continue
        tokens.append(Token(kind, m.group(), m.start()))
    tokens.append(Token("eof", "", len(src)))
    return tokens


def _unescape(s: str) -> str:
    body = s[1:-1]
    return (
        body.replace("\\\\", "\x00")
        .replace("\\\"", "\"").replace("\\'", "'")
        .replace("\\n", "\n").replace("\\t", "\t")
        .replace("\x00", "\\")
    )


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Node:
    pass


@dataclass(frozen=True)
class Lit(Node):
    value: Any


@dataclass(frozen=True)
class Ident(Node):
    name: str


@dataclass(frozen=True)
class Member(Node):
    obj: Node
    name: str


@dataclass(frozen=True)
class Index(Node):
    obj: Node
    index: Node


@dataclass(frozen=True)
class Call(Node):
    fn: str
    args: Tuple[Node, ...]
    receiver: Optional[Node] = None  # method-call receiver


@dataclass(frozen=True)
class Unary(Node):
    op: str
    operand: Node


@dataclass(frozen=True)
class Binary(Node):
    op: str
    left: Node
    right: Node


@dataclass(frozen=True)
class Ternary(Node):
    cond: Node
    then: Node
    other: Node


@dataclass(frozen=True)
class ListLit(Node):
    items: Tuple[Node, ...]


@dataclass(frozen=True)
class MapLit(Node):
    items: Tuple[Tuple[Node, Node], ...]


# macros receive unevaluated args
_MACROS = {"has", "exists", "all", "filter", "map"}

# binding power table (Pratt)
_BINARY_PREC = {
    "||": 1, "&&": 2,
    "==": 3, "!=": 3, "<": 3, "<=": 3, ">": 3, ">=": 3, "in": 3,
    "+": 4, "-": 4,
    "*": 5, "/": 5, "%": 5,
}


class _Parser:
    def __init__(self, tokens: List[Token], src: str):
        self.toks = tokens
        self.i = 0
        self.src = src

    def peek(self) -> Token:
        return self.toks[self.i]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, text: str) -> Token:
        t = self.next()
        if t.text != text:
            raise CelError(f"expected {text!r} at {t.pos}, got {t.text!r} in {self.src!r}")
        return t

    # entry -----------------------------------------------------------------
    def parse(self) -> Node:
        node = self.parse_expr(0)
        t = self.peek()
        if t.kind != "eof":
            raise CelError(f"trailing input at {t.pos}: {t.text!r} in {self.src!r}")
        return node

    def parse_expr(self, min_prec: int) -> Node:
        node = self.parse_unary()
        while True:
            t = self.peek()
            text = t.text
            if text == "?" and min_prec == 0:
                self.next()
                then = self.parse_expr(0)
                self.expect(":")
                other = self.parse_expr(0)
                node = Ternary(node, then, other)
                continue
            op = text if text in _BINARY_PREC else ("in" if (t.kind == "ident" and text == "in") else None)
            if op is None:
                break
            prec = _BINARY_PREC[op]
            if prec < min_prec:
                break
            self.next()
            rhs = self.parse_expr(prec + 1)
            node = Binary(op, node, rhs)
        return node

    def parse_unary(self) -> Node:
        t = self.peek()
        if t.text in ("!", "-"):
            self.next()
            return Unary(t.text, self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self) -> Node:
        node = self.parse_primary()
        while True:
            t = self.peek()
            if t.text == ".":
                self.next()
                name_tok = self.next()
                if name_tok.kind != "ident":
                    raise CelError(f"expected member name at {name_tok.pos} in {self.src!r}")
                if self.peek().text == "(":
                    node = self.parse_call(name_tok.text, receiver=node)
                else:
                    node = Member(node, name_tok.text)
            elif t.text == "[":
                self.next()
                idx = self.parse_expr(0)
                self.expect("]")
                node = Index(node, idx)
            else:
                break
        return node

    def parse_call(self, fn: str, receiver: Optional[Node]) -> Node:
        self.expect("(")
        args: List[Node] = []
        if self.peek().text != ")":
            while True:
                args.append(self.parse_expr(0))
                if self.peek().text == ",":
                    self.next()
                    continue
                break
        self.expect(")")
        return Call(fn, tuple(args), receiver)

    def parse_primary(self) -> Node:
        t = self.next()
        if t.kind == "int":
            return Lit(int(t.text))
        if t.kind == "float":
            return Lit(float(t.text))
        if t.kind == "string":
            return Lit(_unescape(t.text))
        if t.kind == "ident":
            if t.text in _KEYWORDS:
                return Lit(_KEYWORDS[t.text])
            if self.peek().text == "(":
                return self.parse_call(t.text, receiver=None)
            return Ident(t.text)
        if t.text == "(":
            node = self.parse_expr(0)
            self.expect(")")
            return node
        if t.text == "[":
            items: List[Node] = []
            if self.peek().text != "]":
                while True:
                    items.append(self.parse_expr(0))
                    if self.peek().text == ",":
                        self.next()
                        continue
                    break
            self.expect("]")
            return ListLit(tuple(items))
        if t.text == "{":
            pairs: List[Tuple[Node, Node]] = []
            if self.peek().text != "}":
                while True:
                    k = self.parse_expr(0)
                    self.expect(":")
                    v = self.parse_expr(0)
                    pairs.append((k, v))
                    if self.peek().text == ",":
                        self.next()
                        continue
                    break
            self.expect("}")
            return MapLit(tuple(pairs))
        raise CelError(f"unexpected token {t.text!r} at {t.pos} in {self.src!r}")


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------


def _member_get(obj: Any, name: str) -> Any:
    if isinstance(obj, AttributeSet):
        sentinel = object()
        v = obj.get(name, sentinel)
        if v is sentinel:
            raise CelError(f"no such attribute: {name!r}")
        return v
    if isinstance(obj, dict):
        if name in obj:
            return obj[name]
        raise CelError(f"no such key: {name!r}")
    try:
        return getattr(obj, name)
    except AttributeError as e:
        raise CelError(f"no such member: {name!r} on {type(obj).__name__}") from e


def _index_get(obj: Any, idx: Any) -> Any:
    try:
        if isinstance(obj, AttributeSet):
            return obj[idx]
        return obj[idx]
    except (KeyError, IndexError, TypeError) as e:
        raise CelError(f"bad index {idx!r}: {e}") from e


def _truthy(v: Any) -> bool:
    if not isinstance(v, bool):
        raise CelError(f"expected bool, got {type(v).__name__}: {v!r}")
    return v


_BUILTIN_FNS: Dict[str, Callable[..., Any]] = {
    "size": lambda x: len(x),
    "startsWith": lambda s, p: str(s).startswith(p),
    "endsWith": lambda s, p: str(s).endswith(p),
    "contains": lambda s, sub: sub in s,
    "matches": lambda s, pat: re.search(pat, str(s)) is not None,
    "min": lambda *a: min(a[0]) if len(a) == 1 and isinstance(a[0], (list, tuple)) else min(a),
    "max": lambda *a: max(a[0]) if len(a) == 1 and isinstance(a[0], (list, tuple)) else max(a),
    "abs": lambda x: abs(x),
    "int": lambda x: int(float(x)) if isinstance(x, str) else int(x),
    "double": lambda x: float(x),
    "string": lambda x: str(x),
    "bool": lambda x: bool(x),
    "quantity": lambda x: Quantity.parse(x),
    "semver": lambda x: Version.parse(x),
}


def _binary_eval(op: str, l: Any, r: Any) -> Any:
    if op == "==":
        return l == r
    if op == "!=":
        return l != r
    if op == "in":
        try:
            return l in r
        except TypeError as e:
            raise CelError(f"'in' unsupported for {type(r).__name__}") from e
    try:
        if op == "<":
            return l < r
        if op == "<=":
            return l <= r
        if op == ">":
            return l > r
        if op == ">=":
            return l >= r
        if op == "+":
            return l + r
        if op == "-":
            return l - r
        if op == "*":
            return l * r
        if op == "/":
            if isinstance(l, int) and isinstance(r, int):
                if r == 0:
                    raise CelError("division by zero")
                return l // r
            return l / r
        if op == "%":
            return l % r
    except CelError:
        raise
    except TypeError as e:
        raise CelError(f"operator {op!r} unsupported for "
                       f"{type(l).__name__} and {type(r).__name__}") from e
    except ZeroDivisionError as e:
        raise CelError("division by zero") from e
    raise CelError(f"unknown operator {op!r}")


class _Evaluator:
    def __init__(self, env: Dict[str, Any]):
        self.env = env

    def eval(self, node: Node) -> Any:
        if isinstance(node, Lit):
            return node.value
        if isinstance(node, Ident):
            if node.name in self.env:
                return self.env[node.name]
            raise CelError(f"unknown identifier: {node.name!r}")
        if isinstance(node, Member):
            return _member_get(self.eval(node.obj), node.name)
        if isinstance(node, Index):
            return _index_get(self.eval(node.obj), self.eval(node.index))
        if isinstance(node, ListLit):
            return [self.eval(i) for i in node.items]
        if isinstance(node, MapLit):
            return {self.eval(k): self.eval(v) for k, v in node.items}
        if isinstance(node, Unary):
            v = self.eval(node.operand)
            if node.op == "!":
                return not _truthy(v)
            if node.op == "-":
                return -v
            raise CelError(f"unknown unary {node.op!r}")
        if isinstance(node, Binary):
            if node.op == "&&":
                return _truthy(self.eval(node.left)) and _truthy(self.eval(node.right))
            if node.op == "||":
                return _truthy(self.eval(node.left)) or _truthy(self.eval(node.right))
            return _binary_eval(node.op, self.eval(node.left), self.eval(node.right))
        if isinstance(node, Ternary):
            return self.eval(node.then) if _truthy(self.eval(node.cond)) else self.eval(node.other)
        if isinstance(node, Call):
            return self.eval_call(node)
        raise CelError(f"unknown node {node!r}")

    # macros + functions ------------------------------------------------
    def eval_call(self, node: Call) -> Any:
        fn = node.fn
        if fn == "has":
            # presence macro: has(a.b) / has(a["k"]) -> bool, unevaluated arg
            target = node.args[0] if node.receiver is None else node.receiver
            if len(node.args) != 1 and node.receiver is None:
                raise CelError("has() takes exactly one argument")
            try:
                self.eval(target)
                return True
            except CelError:
                return False
        if fn in ("exists", "all", "filter", "map") and node.receiver is not None:
            coll = self.eval(node.receiver)
            if not isinstance(coll, (list, tuple)):
                raise CelError(f"{fn}() requires a list receiver")
            if len(node.args) != 2:
                raise CelError(f"{fn}(var, expr) takes exactly two arguments")
            var_node, body = node.args
            if not isinstance(var_node, Ident):
                raise CelError(f"{fn}() first argument must be an identifier")
            var = var_node.name
            saved = self.env.get(var, _MISSING)
            out: Any
            try:
                if fn == "exists":
                    out = False
                    for item in coll:
                        self.env[var] = item
                        if _truthy(self.eval(body)):
                            out = True
                            break
                elif fn == "all":
                    out = True
                    for item in coll:
                        self.env[var] = item
                        if not _truthy(self.eval(body)):
                            out = False
                            break
                elif fn == "filter":
                    out = []
                    for item in coll:
                        self.env[var] = item
                        if _truthy(self.eval(body)):
                            out.append(item)
                else:  # map
                    out = []
                    for item in coll:
                        self.env[var] = item
                        out.append(self.eval(body))
            finally:
                if saved is _MISSING:
                    self.env.pop(var, None)
                else:
                    self.env[var] = saved
            return out
        # plain/method function call
        args = [self.eval(a) for a in node.args]
        if node.receiver is not None:
            args = [self.eval(node.receiver)] + args
        if fn in _BUILTIN_FNS:
            try:
                return _BUILTIN_FNS[fn](*args)
            except CelError:
                raise
            except Exception as e:  # noqa: BLE001 - surface as CelError
                raise CelError(f"{fn}() failed: {e}") from e
        raise CelError(f"unknown function: {fn!r}")


_MISSING = object()


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


class CelProgram:
    """A compiled CEL expression, reusable across environments."""

    def __init__(self, source: str, ast: Node):
        self.source = source
        self.ast = ast

    def evaluate(self, env: Optional[Dict[str, Any]] = None, **kwargs: Any) -> Any:
        merged = dict(env or {})
        merged.update(kwargs)
        return _Evaluator(merged).eval(self.ast)

    def evaluate_bool(self, env: Optional[Dict[str, Any]] = None, **kwargs: Any) -> bool:
        v = self.evaluate(env, **kwargs)
        if not isinstance(v, bool):
            raise CelError(
                f"selector must evaluate to bool, got {type(v).__name__} "
                f"for {self.source!r}")
        return v

    def __repr__(self) -> str:
        return f"CelProgram({self.source!r})"


@lru_cache(maxsize=4096)
def _compile_cached(source: str) -> CelProgram:
    return CelProgram(source, _Parser(_lex(source), source).parse())


def compile_expr(source: str) -> CelProgram:
    """Compile ``source``, memoized module-wide.

    Identical selector strings appear on every claim stamped from a
    template and on every DeviceClass re-instantiation; the lexer +
    Pratt parser dominate selector cost, so they run once per distinct
    string. Safe to share: :class:`CelProgram` holds only the immutable
    AST — each ``evaluate()`` builds its own environment.
    """
    return _compile_cached(source)


def compile_cache_info():
    """(hits, misses, maxsize, currsize) of the compile cache."""
    return _compile_cached.cache_info()


def compile_cache_clear() -> None:
    _compile_cached.cache_clear()


def evaluate(source: str, env: Optional[Dict[str, Any]] = None, **kwargs: Any) -> Any:
    return compile_expr(source).evaluate(env, **kwargs)
