"""Symbolic differentiation of formula strings.

Rebuild of the reference's expression differentiator (reference:
src/phyc/symdiff.c ``differentiate(expr, dx)`` over an expression stack,
symdiff.h:36 — a standalone utility off the hot path). Here a small
recursive-descent parser builds an AST; differentiation and constant-folding
simplification run on the tree, and the result prints back to a formula
string. ``compile_torch`` additionally turns any expression into a function
of tensors that autograd differentiates — the numeric path is autograd, so
symbolic derivatives serve as documentation/cross-checks, as in the
reference. Port of ``physher_tpu/utils/symdiff.py``.

Grammar: numbers, variables, + - * / ^ (right-assoc), unary minus, parens,
and sin cos tan sinh cosh tanh exp log sqrt.
"""

from __future__ import annotations

import math
import re

_TOKEN = re.compile(r"\s*(?:(\d+\.?\d*(?:[eE][+-]?\d+)?)|([A-Za-z_]\w*)"
                    r"|([-+*/^(),]))")

_FUNCS = {"sin", "cos", "tan", "sinh", "cosh", "tanh", "exp", "log", "sqrt"}


# -- AST: tuples ("num", v) | ("var", name) | ("call", fn, arg)
#         | (op, left, right) | ("neg", arg)

def tokenize(s: str):
    out, pos = [], 0
    while pos < len(s):
        m = _TOKEN.match(s, pos)
        if not m or m.end() == pos:
            if s[pos:].strip() == "":
                break
            raise ValueError(f"bad token at {s[pos:]!r}")
        num, name, op = m.groups()
        if num:
            out.append(("num", float(num)))
        elif name:
            out.append(("name", name))
        else:
            out.append(("op", op))
        pos = m.end()
    return out


def parse(s: str):
    toks = tokenize(s)
    pos = 0

    def peek():
        return toks[pos] if pos < len(toks) else (None, None)

    def eat(kind, val=None):
        nonlocal pos
        t = peek()
        if t[0] != kind or (val is not None and t[1] != val):
            raise ValueError(f"expected {kind} {val}, got {t}")
        pos += 1
        return t

    def expr():
        node = term()
        while peek() == ("op", "+") or peek() == ("op", "-"):
            op = eat("op")[1]
            node = (op, node, term())
        return node

    def term():
        node = unary()
        while peek() == ("op", "*") or peek() == ("op", "/"):
            op = eat("op")[1]
            node = (op, node, unary())
        return node

    def unary():
        if peek() == ("op", "-"):
            eat("op", "-")
            return ("neg", unary())
        if peek() == ("op", "+"):
            eat("op", "+")
            return unary()
        return power()

    def power():
        node = atom()
        if peek() == ("op", "^"):
            eat("op", "^")
            return ("^", node, unary())   # right associative
        return node

    def atom():
        t = peek()
        if t[0] == "num":
            eat("num")
            return ("num", t[1])
        if t[0] == "name":
            eat("name")
            if t[1] in _FUNCS and peek() == ("op", "("):
                eat("op", "(")
                arg = expr()
                eat("op", ")")
                return ("call", t[1], arg)
            return ("var", t[1])
        if t == ("op", "("):
            eat("op", "(")
            node = expr()
            eat("op", ")")
            return node
        raise ValueError(f"unexpected token {t}")

    node = expr()
    if pos != len(toks):
        raise ValueError(f"trailing tokens {toks[pos:]}")
    return node


def diff(node, x: str):
    kind = node[0]
    if kind == "num":
        return ("num", 0.0)
    if kind == "var":
        return ("num", 1.0 if node[1] == x else 0.0)
    if kind == "neg":
        return ("neg", diff(node[1], x))
    if kind == "+":
        return ("+", diff(node[1], x), diff(node[2], x))
    if kind == "-":
        return ("-", diff(node[1], x), diff(node[2], x))
    if kind == "*":
        u, v = node[1], node[2]
        return ("+", ("*", diff(u, x), v), ("*", u, diff(v, x)))
    if kind == "/":
        u, v = node[1], node[2]
        return ("/", ("-", ("*", diff(u, x), v), ("*", u, diff(v, x))),
                ("^", v, ("num", 2.0)))
    if kind == "^":
        u, v = node[1], node[2]
        if v[0] == "num":                       # power rule
            return ("*", ("*", v, ("^", u, ("num", v[1] - 1.0))), diff(u, x))
        # general: u^v * (v' log u + v u'/u)
        return ("*", node,
                ("+", ("*", diff(v, x), ("call", "log", u)),
                 ("/", ("*", v, diff(u, x)), u)))
    if kind == "call":
        fn, u = node[1], node[2]
        du = diff(u, x)
        inner = {
            "sin": ("call", "cos", u),
            "cos": ("neg", ("call", "sin", u)),
            "tan": ("/", ("num", 1.0), ("^", ("call", "cos", u), ("num", 2.0))),
            "sinh": ("call", "cosh", u),
            "cosh": ("call", "sinh", u),
            "tanh": ("-", ("num", 1.0), ("^", ("call", "tanh", u), ("num", 2.0))),
            "exp": node,
            "log": ("/", ("num", 1.0), u),
            "sqrt": ("/", ("num", 0.5), ("call", "sqrt", u)),
        }[fn]
        return ("*", inner, du)
    raise ValueError(kind)


def simplify(node):
    kind = node[0]
    if kind in ("num", "var"):
        return node
    if kind == "neg":
        a = simplify(node[1])
        if a[0] == "num":
            return ("num", -a[1])
        if a[0] == "neg":
            return a[1]
        return ("neg", a)
    if kind == "call":
        a = simplify(node[2])
        if a[0] == "num":
            return ("num", getattr(math, node[1])(a[1]))
        return ("call", node[1], a)
    a, b = simplify(node[1]), simplify(node[2])
    an, bn = a[0] == "num", b[0] == "num"
    if an and bn:
        v = {"+": a[1] + b[1], "-": a[1] - b[1], "*": a[1] * b[1],
             "/": a[1] / b[1] if b[1] != 0 else math.nan,
             "^": a[1] ** b[1]}[kind]
        return ("num", v)
    if kind == "+":
        if an and a[1] == 0:
            return b
        if bn and b[1] == 0:
            return a
    if kind == "-":
        if bn and b[1] == 0:
            return a
        if an and a[1] == 0:
            return simplify(("neg", b))
    if kind == "*":
        if (an and a[1] == 0) or (bn and b[1] == 0):
            return ("num", 0.0)
        if an and a[1] == 1:
            return b
        if bn and b[1] == 1:
            return a
    if kind == "/":
        if an and a[1] == 0:
            return ("num", 0.0)
        if bn and b[1] == 1:
            return a
    if kind == "^":
        if bn and b[1] == 1:
            return a
        if bn and b[1] == 0:
            return ("num", 1.0)
    return (kind, a, b)


def to_string(node) -> str:
    kind = node[0]
    if kind == "num":
        v = node[1]
        return str(int(v)) if v == int(v) and abs(v) < 1e15 else repr(v)
    if kind == "var":
        return node[1]
    if kind == "neg":
        return f"-{_paren(node[1], above=1)}"
    if kind == "call":
        return f"{node[1]}({to_string(node[2])})"
    prec = {"+": 1, "-": 1, "*": 2, "/": 2, "^": 3}[kind]
    left = _paren(node[1], above=prec - 1 if kind in "+-*" else prec)
    tight = prec if kind in ("-", "/", "^") else prec - 1
    right = _paren(node[2], above=tight)
    return f"{left} {kind} {right}" if kind in "+-" else f"{left}{kind}{right}"


def _paren(node, above: int) -> str:
    prec = {"+": 1, "-": 1, "neg": 1, "*": 2, "/": 2, "^": 3,
            "num": 9, "var": 9, "call": 9}[node[0]]
    s = to_string(node)
    return f"({s})" if prec <= above else s


def differentiate(expression: str, x: str) -> str:
    """d(expression)/dx as a formula string (reference: symdiff.h:36)."""
    return to_string(simplify(diff(parse(expression), x)))


def evaluate(expression: str, env: dict) -> float:
    """Numeric evaluation with variable bindings."""
    def ev(node):
        kind = node[0]
        if kind == "num":
            return node[1]
        if kind == "var":
            return float(env[node[1]])
        if kind == "neg":
            return -ev(node[1])
        if kind == "call":
            return getattr(math, node[1])(ev(node[2]))
        a, b = ev(node[1]), ev(node[2])
        return {"+": a + b, "-": a - b, "*": a * b, "/": a / b,
                "^": a ** b}[kind]
    return ev(parse(expression))


def compile_torch(expression: str, variables: list):
    """Compile a formula to a function of tensors ``variables`` (in order),
    differentiable by autograd: calls are ``torch.<name>``."""
    import torch

    ast = parse(expression)

    def fn(*args):
        env = dict(zip(variables, args))

        def ev(node):
            kind = node[0]
            if kind == "num":
                return node[1]
            if kind == "var":
                return env[node[1]]
            if kind == "neg":
                return -ev(node[1])
            if kind == "call":
                x = ev(node[2])
                if not isinstance(x, torch.Tensor):
                    # a call of a constant: a 0-d float64 tensor, which does
                    # not promote the tensors it meets
                    x = torch.tensor(x, dtype=torch.float64)
                return getattr(torch, node[1])(x)
            a, b = ev(node[1]), ev(node[2])
            if kind == "^":
                return a ** b
            return {"+": a + b, "-": a - b, "*": a * b, "/": a / b}[kind]

        return ev(ast)

    return fn
