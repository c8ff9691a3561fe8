"""A program's expression, its plain reference, its control and the comparison.

A program (``programs/<name>.json``) is an element-wise expression over its
arguments, such as ``a * b + c``, of one element type.  The same expression
becomes three things here:

* the function handed to ``repro_torch.pim.compile`` (:func:`as_lambda`);
* the plain reference (:func:`reference`): NumPy, one rounding or wrap per
  operation as the type states; it imports nothing of the program and takes
  only the inputs the benchmark made;
* the control (:func:`control`): the same expression computed in the
  nearest lower precision (bfloat16 for float32, ``fixed(n/2)`` for
  ``fixed(n)``), on the card in plain PyTorch, put in the program's place to
  show that the comparison fails it.

:func:`wrong_rows` counts the rows whose result differs from the reference:
float32 bit for bit, NaN as NaN; fixed point by value.
"""

from __future__ import annotations

import ast
import dataclasses
import re

import numpy as np

_BINOPS = {ast.Add: "add", ast.Sub: "sub", ast.Mult: "mul", ast.Div: "div"}


@dataclasses.dataclass(frozen=True)
class ElemType:
    """``kind`` is ``float32`` or ``fixed``; ``nbits`` the width."""

    name: str
    kind: str
    nbits: int


def elem_type(name: str) -> ElemType:
    if name == "f32":
        return ElemType(name, "float32", 32)
    m = re.fullmatch(r"(?:int|fixed)(\d+)", name)
    if m and 1 <= int(m.group(1)) <= 32:
        return ElemType(name, "fixed", int(m.group(1)))
    raise ValueError(f"no plain reference for element type {name!r}")


def parse(expr: str, args: list[str]) -> ast.expr:
    """The expression's tree; only the arguments, numeric constants, unary
    minus and ``+ - * /`` are allowed."""
    if not all(a.isidentifier() for a in args):
        raise ValueError(f"bad argument names {args!r}")
    tree = ast.parse(expr, mode="eval").body
    for node in ast.walk(tree):
        ok = (isinstance(node, (ast.BinOp, *_BINOPS, ast.USub, ast.UnaryOp, ast.Load))
              or (isinstance(node, ast.Name) and node.id in args)
              or (isinstance(node, ast.Constant) and type(node.value) in (int, float)))
        if not ok or (isinstance(node, ast.UnaryOp) and not isinstance(node.op, ast.USub)):
            raise ValueError(f"{ast.dump(node)} is not allowed in a program's expression")
    return tree


def as_lambda(program: dict):
    """The program as a Python function of its arguments, for ``pim.compile``."""
    parse(program["expr"], program["args"])
    return eval(f"lambda {', '.join(program['args'])}: {program['expr']}",
                {"__builtins__": {}})


def _evaluate(node: ast.expr, env: dict, const, binop, neg):
    if isinstance(node, ast.Name):
        return env[node.id]
    if isinstance(node, ast.Constant):
        return const(node.value)
    if isinstance(node, ast.UnaryOp):
        return neg(_evaluate(node.operand, env, const, binop, neg))
    return binop(_BINOPS[type(node.op)],
                 _evaluate(node.left, env, const, binop, neg),
                 _evaluate(node.right, env, const, binop, neg))


def _wrap(v, nbits: int):
    """Two's-complement wrap to ``nbits`` (NumPy or torch integers)."""
    half = 1 << (nbits - 1)
    return ((v + half) & ((1 << nbits) - 1)) - half


def _int_binop(nbits: int):
    def binop(op, x, y):
        if op == "div":
            raise NotImplementedError("no plain reference for fixed-point division")
        r = x + y if op == "add" else x - y if op == "sub" else x * y
        return _wrap(r, nbits)
    return binop


def _float_binop(op, x, y):
    return x + y if op == "add" else x - y if op == "sub" else x * y if op == "mul" else x / y


def reference(program: dict, inputs: list[np.ndarray]) -> np.ndarray:
    """The program over ``inputs`` in NumPy: float32 with one IEEE rounding
    an operation, or fixed point wrapped after each operation (int32 up to
    16 bits, int64 above)."""
    t = elem_type(program["dtype"])
    tree = parse(program["expr"], program["args"])
    if t.kind == "float32":
        env = dict(zip(program["args"], (np.asarray(x, dtype=np.float32) for x in inputs)))
        with np.errstate(all="ignore"):
            return np.asarray(_evaluate(tree, env, lambda v: np.float32(float(v)), _float_binop,
                                        np.negative), dtype=np.float32)
    # Each operation's operands are wrapped to nbits, so its exact result is
    # at most 2 ** (2 * nbits - 2) in size: int32 holds it, and the wrap's
    # offset, up to 16 bits.
    carrier = np.int32 if t.nbits <= 16 else np.int64
    env = dict(zip(program["args"], (_wrap(np.asarray(x, dtype=carrier), t.nbits)
                                     for x in inputs)))
    return _evaluate(tree, env, lambda v: _wrap(carrier(int(v)), t.nbits),
                     _int_binop(t.nbits), lambda v: _wrap(-v, t.nbits))


def control(program: dict, inputs):
    """The program over torch tensors ``inputs`` in the nearest lower
    precision: every input and operation in bfloat16 for float32 (returned as
    float32), or wrapped to ``nbits // 2`` for ``fixed(nbits)`` (int32)."""
    import torch

    t = elem_type(program["dtype"])
    tree = parse(program["expr"], program["args"])
    if t.kind == "float32":
        env = dict(zip(program["args"], (x.to(torch.bfloat16) for x in inputs)))
        out = _evaluate(tree, env, lambda v: float(v), _float_binop, torch.neg)
        return out.to(torch.float32)
    low = max(t.nbits // 2, 1)
    env = dict(zip(program["args"], (_wrap(x.to(torch.int32), low) for x in inputs)))
    return _evaluate(tree, env, lambda v: _wrap(int(v), low), _int_binop(low),
                     lambda v: _wrap(-v, low)).to(torch.int32)


def wrong_mask(program: dict, got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Which rows of ``got`` differ from the reference ``want`` (same shape)."""
    if elem_type(program["dtype"]).kind == "float32":
        got = np.asarray(got, dtype=np.float32)
        nan_got, nan_want = np.isnan(got), np.isnan(want)
        return (nan_got != nan_want) | (~nan_want & (got.view(np.uint32) != want.view(np.uint32)))
    return np.asarray(got, dtype=np.int64) != want


def wrong_rows(program: dict, got: np.ndarray, want: np.ndarray) -> int:
    """Rows of ``got`` that differ from the reference ``want``; every row
    when the shapes differ."""
    if got.shape != want.shape:
        return int(max(got.size, want.size))
    return int(np.count_nonzero(wrong_mask(program, got, want)))
