"""Lower a ``Map``'s torch function to a tape the fused kernels run.

The reference's fused kernel calls a ``Map`` callable on the tile inside
the kernel; a CUDA kernel cannot call Python. So the port traces the
function per ``(Map.name, dtype)`` with ``make_fx`` on a one-element
tensor and keeps it when the trace is a DAG of at most :data:`TAPE_MAX`
element-wise aten ops from a closed list. An op's operands are earlier
values of the tape (*slots*: slot 0 the map's input, slot ``k + 1`` the
result of op ``k``; a value may feed any number of later ops) or Python
numbers (and the 0-dim constants ``torch.where`` makes of them). Every
value keeps the map's dtype and shape, but comparisons and the logical
ops, whose values are bool and which ``where`` consumes. Ops whose
results do not reach the output are dropped, so the output is the last
op's result.

K4b and K5 (``tile_epilogue.cuh``) evaluate the tape on register values
as PyTorch's CUDA kernel for each aten op computes it: float32 and
float64 ops in their type, rounded once an op (a division by a constant
is a product with its reciprocal, as PyTorch's CUDA ``div`` computes it);
bfloat16 and float16 ops in float, rounded to the type after each op;
integer ops (8, 16 and 32 bits) in int narrowed to the type's width after
each op, so they wrap where torch wraps; int64 and uint64 in 64 bits
(bool: ``~`` as an XOR with 1, and only ``&``, ``|``, ``^`` and ``*``,
which keep 0 and 1). A number operand is held as the CUDA kernel holds it:
in the op's compute type for arithmetic, rounded to the dtype where torch
casts it there (comparisons, ``where``, ``clamp``, ``remainder``,
``fmod``), and a ``pow`` exponent whole, since PyTorch picks its kernel
by the exponent's value. K5 takes the map's gradient by reverse mode over
the tape (:func:`tape_vjp`): each op's derivative is autograd's formula
for it, and the cotangents of a value that feeds several ops are summed
in the order autograd's engine receives them (the last consumer first).

A function the list does not cover, one whose trace fails (``.item()``,
data-dependent Python branches), casts (``.float()``, ``.to``), holds a
tensor constant, or is longer than :data:`TAPE_MAX` ops is not lowered
(``Tape.ops is None``): a cluster that holds it runs stage by stage and
counts a fused fallback. A float function lowers for float32, bfloat16,
float16 and float64 alike or for none of them. An op torch does not
define for a type (most of them for uint16, uint32 and uint64 on the
CPU; the activations for the integers) fails the trace or changes the
dtype, so the map is not lowered for that type. Tapes are kept in a
bounded cache by ``(Map.name, dtype)``, each holding its function
(another function under a cached name is lowered anew), and dropped by
``combinators.clear_caches``.
"""
from __future__ import annotations

import math
import threading
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np
import torch

TAPE_MAX = 32     # ops a tape may hold (K5 keeps each op's result a value)
CONST_MAX = 64    # distinct constants a tape may hold (6-bit operand index)

S, C = 0, 2       # operand kinds: a slot of the tape, a constant

# opcodes, kept equal to tile_epilogue.cuh
(OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_NEG, OP_ABS, OP_MAXC, OP_MINC, OP_RELU,
 OP_EXP, OP_EXPM1, OP_LOG, OP_LOG1P, OP_SQRT, OP_RSQRT, OP_TANH, OP_SIGMOID,
 OP_NOT, OP_AND, OP_OR, OP_XOR, OP_SHL, OP_SHR, OP_SIN, OP_COS,
 OP_EQ, OP_NE, OP_LT, OP_LE, OP_GT, OP_GE, OP_LNOT, OP_LAND, OP_LOR,
 OP_WHERE, OP_MAXIMUM, OP_MINIMUM, OP_POW, OP_RECIP, OP_FLOOR, OP_CEIL,
 OP_TRUNC, OP_ROUND, OP_SIGN, OP_ERF, OP_LOG2, OP_EXP2, OP_GELU,
 OP_GELU_TANH, OP_SILU, OP_SOFTPLUS, OP_LEAKY, OP_HARDTANH, OP_FLOORDIV,
 OP_TRUNCDIV, OP_REM, OP_FMOD) = range(57)

_FLOATS = (torch.float32, torch.bfloat16, torch.float16, torch.float64)
_INTS = (torch.int32, torch.int8, torch.uint8, torch.int16, torch.uint16,
         torch.uint32, torch.bool, torch.int64, torch.uint64)
_WIDE = (torch.int64, torch.uint64, torch.float64)   # 64-bit constants
_UNARY_FLOAT = {
    "exp": OP_EXP, "expm1": OP_EXPM1, "log": OP_LOG, "log1p": OP_LOG1P,
    "sqrt": OP_SQRT, "rsqrt": OP_RSQRT, "tanh": OP_TANH,
    "sigmoid": OP_SIGMOID, "sin": OP_SIN, "cos": OP_COS, "erf": OP_ERF,
    "log2": OP_LOG2, "exp2": OP_EXP2, "reciprocal": OP_RECIP,
    "silu": OP_SILU}
_ROUNDING = {"floor": OP_FLOOR, "ceil": OP_CEIL, "trunc": OP_TRUNC,
             "round": OP_ROUND, "sign": OP_SIGN}
_BINARY = {"add": OP_ADD, "sub": OP_SUB, "mul": OP_MUL, "div": OP_DIV,
           "bitwise_and": OP_AND, "bitwise_or": OP_OR,
           "bitwise_xor": OP_XOR}
_COMPARE = {"eq": OP_EQ, "ne": OP_NE, "lt": OP_LT, "le": OP_LE, "gt": OP_GT,
            "ge": OP_GE}
_LOGICAL = {"logical_not": OP_LNOT, "logical_and": OP_LAND,
            "logical_or": OP_LOR}
_INT_ONLY = (OP_NOT, OP_AND, OP_OR, OP_XOR, OP_SHL, OP_SHR)
_BOOL_OPS = (OP_AND, OP_OR, OP_XOR, OP_MUL)   # and OP_NOT, as an XOR
_BOOL_RESULT = tuple(_COMPARE.values()) + tuple(_LOGICAL.values())
# numbers torch casts to the tensor's dtype before the op
_CAST_CONST = _BOOL_RESULT + (OP_MAXC, OP_MINC, OP_WHERE, OP_REM, OP_FMOD)


class Tape:
    """A map lowered for one dtype: ``ops`` a tuple of ``(op, operands)``,
    each operand ``(S, slot)`` or ``(C, number)`` (see the module
    docstring), or None when ``fn`` is not lowered; ``grads[s]`` says
    whether op ``s`` lies on a differentiable path to the output (its
    backward runs); ``nodiff`` whether such an op has no derivative in
    autograd (``floor_divide``). ``name`` and ``fn`` are the ``Map``'s."""

    __slots__ = ("name", "fn", "dtype", "ops", "grads", "nodiff")

    def __init__(self, name: str, fn: Callable, dtype, ops, grads=(),
                 nodiff=False):
        self.name, self.fn, self.dtype, self.ops = name, fn, dtype, ops
        self.grads, self.nodiff = tuple(grads), nodiff

    @property
    def lowered(self) -> bool:
        return self.ops is not None


_CACHE: "OrderedDict" = OrderedDict()   # (name, dtype) -> Tape, LRU
_CACHE_MAX = 256
_STATS = {"hits": 0, "misses": 0}
_LOCK = threading.Lock()


def lower_map(name: str, fn: Callable, dtype) -> Tape:
    """The tape of ``fn`` for ``dtype``; ``.ops`` is None when the function
    is not lowered. Kept by ``(name, dtype)`` (a ``Map`` compares by name)
    in a bounded LRU cache; a cached tape of another function under the
    same name is lowered anew and replaced, so the tape returned always
    holds ``fn``."""
    key = (name, str(dtype))
    with _LOCK:
        got = _CACHE.get(key)
        if got is not None and got.fn is fn:
            _CACHE.move_to_end(key)
            _STATS["hits"] += 1
            return got
        _STATS["misses"] += 1
    ops, nodiff = _lower(fn, dtype) or (None, False)
    got = Tape(name, fn, dtype, ops,
               _grad_ops(ops) if ops is not None else (), nodiff)
    with _LOCK:
        _CACHE[key] = got
        _CACHE.move_to_end(key)
        while len(_CACHE) > _CACHE_MAX:
            _CACHE.popitem(last=False)
    return got


def clear_cache() -> None:
    with _LOCK:
        _CACHE.clear()
        _STATS.update(hits=0, misses=0)


def cache_info() -> tuple:
    """(hits, misses, maxsize, currsize), as ``lru_cache`` reports them."""
    with _LOCK:
        return (_STATS["hits"], _STATS["misses"], _CACHE_MAX, len(_CACHE))


def _shape(ops) -> list:
    """A tape's ops and slots, its constants left out."""
    return [(op, tuple(o if o[0] == S else C for o in opnds))
            for op, opnds in ops]


def _lower(fn: Callable, dtype) -> Optional[tuple]:
    """(ops, nodiff) of ``fn`` for ``dtype``. A float function is lowered
    only when its float32, bfloat16, float16 and float64 traces are the
    same ops on the same operands (constants may round differently), so
    whether a map runs in the kernels, and with it the round-trip model,
    does not depend on which float type it meets."""
    if dtype not in _FLOATS:
        return _trace(fn, dtype) if dtype in _INTS else None
    got = _trace(fn, dtype)
    if got is None:
        return None
    for other in _FLOATS:
        o = _trace(fn, other) if other != dtype else got
        if o is None or _shape(got[0]) != _shape(o[0]):
            return None
    return got


def _trace(fn: Callable, dtype) -> Optional[tuple]:
    from torch.fx.experimental.proxy_tensor import make_fx
    try:
        gm = make_fx(lambda v: fn(v), tracing_mode="real")(
            torch.ones(1, dtype=dtype))
    except Exception:   # any trace failure: the function is not lowered
        return None
    nodes = list(gm.graph.nodes)
    ph = [nd for nd in nodes if nd.op == "placeholder"]
    (out,) = [nd for nd in nodes if nd.op == "output"]
    if len(ph) != 1:
        return None
    slot = {ph[0]: 0}      # node -> slot
    consts = {}            # node -> number (a 0-dim constant of the dtype)
    bools = [False]        # slot -> bool values
    ops, nodiff = [], set()
    for nd in nodes:
        if nd.op in ("placeholder", "output"):
            continue
        if nd.op != "call_function":
            return None
        val = nd.meta.get("val")
        if not isinstance(val, torch.Tensor):
            return None
        c = _scalar_const(nd, val, dtype)
        if c is not None:
            consts[nd] = c
            continue
        is_bool = val.dtype == torch.bool and dtype != torch.bool
        if (val.dtype != dtype and not is_bool) or tuple(val.shape) != (1,):
            return None
        got = _op(nd, slot, consts, bools, dtype)
        if not got:
            return None
        for op, opnds in got:
            opnds = tuple((S, len(ops)) if o == (S, -1) else o
                          for o in opnds)      # the group's previous op
            ops.append((op, opnds))
            bools.append(op in _BOOL_RESULT)
        if bools[-1] != is_bool:
            return None
        if "floor_divide" in str(nd.target):
            nodiff.add(len(ops) - 1)
        slot[nd] = len(ops)
    res = out.args[0]
    if not isinstance(res, torch.fx.Node) or res not in slot or bools[
            slot[res]]:
        return None
    ops, kept = _prune(ops, slot[res])
    if len(ops) > TAPE_MAX or len(tape_constants(
            Tape("", None, dtype, ops))) > CONST_MAX:
        return None
    grads = _grad_ops(tuple(ops))
    return tuple(ops), any(grads[kept.index(s)] for s in nodiff
                           if s in kept)


def _scalar_const(nd, val, dtype):
    """The number of a 0-dim constant the trace makes of a Python number
    (``torch.where``'s ``scalar_tensor``) in the map's dtype, rounded to
    it; None for any other node."""
    name = getattr(nd.target, "__name__", str(nd.target))
    if name != "scalar_tensor.default" or val.dtype != dtype or val.dim():
        return None
    c = nd.args[0]
    if isinstance(c, bool) or not isinstance(c, (int, float)) or (
            isinstance(c, float) and math.isnan(c)):
        return None
    return _cast(c, dtype)


def _cast(c, dtype):
    """Number ``c`` as torch casts it to ``dtype`` (through float32 for the
    half floats); None where the dtype cannot hold it."""
    if dtype in _INTS:
        if dtype == torch.bool or not isinstance(c, int) or not (
                torch.iinfo(dtype).min <= c <= torch.iinfo(dtype).max):
            return None
        return int(c)
    return float(torch.tensor(float(c), dtype=dtype))


def _prune(ops, res: int):
    """Drop the ops whose results do not reach slot ``res`` and renumber
    the slots; (ops, the trace's indices of the ops kept)."""
    live = {res}
    for s in range(len(ops) - 1, -1, -1):
        if s + 1 in live:
            live.update(x for k, x in ops[s][1] if k == S)
    kept = [s for s in range(len(ops)) if s + 1 in live]
    new = {0: 0}
    for i, s in enumerate(kept):
        new[s + 1] = i + 1
    out = [(ops[s][0], tuple((S, new[x]) if k == S else (k, x)
                             for k, x in ops[s][1])) for s in kept]
    return out, kept


def _diff_operands(op) -> tuple:
    """The operand positions autograd sends a cotangent to."""
    if op in _BOOL_RESULT:
        return ()
    if op == OP_WHERE:
        return (1, 2)
    return (0, 1)


def _grad_ops(ops) -> tuple:
    """Per op: does its result reach the output through ops that
    differentiate it (so autograd runs its backward)?"""
    n = len(ops)
    if not n:
        return ()
    live = [False] * (n + 1)
    live[n] = True
    bools = [False] + [op in _BOOL_RESULT for op, _ in ops]
    for s in range(n - 1, -1, -1):
        if not live[s + 1]:
            continue
        op, opnds = ops[s]
        for i in _diff_operands(op):
            if i < len(opnds) and opnds[i][0] == S and not bools[
                    opnds[i][1]]:
                live[opnds[i][1]] = True
    return tuple(live[1:])


def _operand(arg, slot, consts, dtype):
    """(kind, slot or number) of one argument, or None."""
    if isinstance(arg, torch.fx.Node):
        if arg in slot:
            return S, slot[arg]
        if arg in consts:
            return C, consts[arg]
        return None
    if isinstance(arg, bool) or not isinstance(arg, (int, float)):
        return None
    if dtype in _INTS:
        if (dtype == torch.bool or not isinstance(arg, int)
                or not torch.iinfo(dtype).min <= arg <= torch.iinfo(dtype).max):
            return None
        return C, int(arg)
    if math.isnan(float(arg)):
        return None
    return C, float(arg)


def _op(nd, slot, consts, bools, dtype) -> Optional[list]:
    """The tape ops ``(op, operands)`` of one aten node, or None; an
    operand ``(S, -1)`` is the result of the group's previous op."""
    target = nd.target
    name = getattr(target, "__name__", str(target))   # e.g. "add.Tensor"
    base, _, overload = name.partition(".")
    args = list(nd.args)
    kw = dict(nd.kwargs)
    if kw.pop("alpha", 1) != 1:
        return None
    approx = kw.pop("approximate", "none")
    mode = kw.pop("rounding_mode", None)
    if kw:
        return None
    opnds = []
    for a in args:
        got = None if a is None else _operand(a, slot, consts, dtype)
        if got is None and a is not None:
            return None
        opnds.append(got)      # None: an argument left out (clamp's)
    is_float = dtype in _FLOATS
    wide_int = dtype in _INTS

    def is_b(o):
        return o is not None and o[0] == S and o[1] >= 0 and bools[o[1]]

    def one(op, *xs):
        xs = list(xs)
        if not xs or None in xs:
            return None
        if xs[0][0] == C and not (op == OP_SUB and xs[1][0] == S):
            return None      # a constant comes first only in rsub's c - x
        if op in _INT_ONLY and is_float:
            return None
        if dtype == torch.bool:
            if op == OP_NOT:    # ~ on 0 and 1: an XOR with 1
                return (OP_XOR, (xs[0], (C, 1)))
            if op not in _BOOL_OPS:
                return None
        if op in (OP_SHL, OP_SHR) and not (
                xs[1][0] == C and 0 <= xs[1][1] < (64 if dtype in _WIDE
                                                   else 32)):
            return None
        # bool values feed only the ops made for them, and a product
        if any(is_b(o) for o in xs) and op not in (
                OP_LNOT, OP_LAND, OP_LOR, OP_WHERE, OP_MUL):
            return None
        if op == OP_WHERE and not (is_b(xs[0]) and not is_b(xs[1])
                                   and not is_b(xs[2])):
            return None
        if op in (OP_LNOT, OP_LAND, OP_LOR) and not all(map(is_b, xs)):
            return None
        if op in _CAST_CONST:
            xs = [(C, _cast(x, dtype)) if k == C else (k, x) for k, x in xs]
            if any(k == C and x is None for k, x in xs):
                return None
        return (op, tuple(xs))

    ops = []
    n_args = len(args)
    if base in _BINARY and overload in ("Tensor", "Scalar") and n_args == 2:
        ops.append(one(_BINARY[base], *opnds))
    elif base == "rsub" and overload == "Scalar" and n_args == 2:
        ops.append(one(OP_SUB, opnds[1], opnds[0]))      # c - x
    elif base in ("neg", "abs", "relu", "bitwise_not") and n_args == 1:
        op = {"neg": OP_NEG, "abs": OP_ABS, "relu": OP_RELU,
              "bitwise_not": OP_NOT}[base]
        ops.append(one(op, opnds[0]))
    elif base in _UNARY_FLOAT and n_args == 1 and is_float:
        ops.append(one(_UNARY_FLOAT[base], opnds[0]))
    elif (base in _ROUNDING and n_args == 1 and overload in ("", "default")
          and dtype != torch.bool):
        ops.append(one(_ROUNDING[base], opnds[0]))
    elif base in _COMPARE and overload in ("Tensor", "Scalar") and n_args == 2:
        if dtype == torch.bool or is_b(opnds[0]) or is_b(opnds[1]):
            return None
        ops.append(one(_COMPARE[base], *opnds))
    elif base in _LOGICAL and n_args == (1 if base == "logical_not" else 2):
        ops.append(one(_LOGICAL[base], *opnds))
    elif base == "where" and overload == "self" and n_args == 3:
        ops.append(one(OP_WHERE, *opnds))
    elif base in ("maximum", "minimum") and n_args == 2:
        if not (opnds[0][0] == S and opnds[1][0] == S) or dtype == torch.bool:
            return None
        ops.append(one(OP_MAXIMUM if base == "maximum" else OP_MINIMUM,
                       *opnds))
    elif base == "pow" and overload == "Tensor_Scalar" and n_args == 2:
        e = args[1]
        if opnds[1][0] != C or dtype == torch.bool or (
                not is_float and not (isinstance(e, int) and e >= 0)):
            return None
        ops.append(one(OP_POW, opnds[0], (C, e)))
    elif base == "gelu" and n_args == 1 and is_float and approx in (
            "none", "tanh"):
        ops.append(one(OP_GELU if approx == "none" else OP_GELU_TANH,
                       opnds[0]))
    elif base == "softplus" and 1 <= n_args <= 3 and is_float:
        beta = opnds[1] if n_args > 1 else (C, 1.0)
        thr = opnds[2] if n_args > 2 else (C, 20.0)
        if beta[0] != C or thr[0] != C:
            return None
        ops.append(one(OP_SOFTPLUS, opnds[0], beta, thr))
    elif base == "leaky_relu" and 1 <= n_args <= 2 and is_float:
        slope = opnds[1] if n_args > 1 else (C, 0.01)
        if slope[0] != C:
            return None
        ops.append(one(OP_LEAKY, opnds[0], slope))
    elif base == "hardtanh" and 1 <= n_args <= 3 and dtype != torch.bool:
        lo = opnds[1] if n_args > 1 else (C, -1.0 if is_float else -1)
        hi = opnds[2] if n_args > 2 else (C, 1.0 if is_float else 1)
        if lo[0] != C or hi[0] != C:
            return None
        ops.append(one(OP_HARDTANH, opnds[0], lo, hi))
    elif (base in ("floor_divide", "remainder", "fmod")
          or (base == "div" and overload in ("Tensor_mode", "Scalar_mode")
              and mode in ("floor", "trunc"))) and n_args == 2:
        if opnds[1][0] != C or dtype == torch.bool or (
                wide_int and opnds[1][1] == 0):
            return None
        op = {"floor_divide": OP_FLOORDIV, "remainder": OP_REM,
              "fmod": OP_FMOD}.get(base) if base != "div" else (
            OP_FLOORDIV if mode == "floor" else OP_TRUNCDIV)
        ops.append(one(op, *opnds))
    elif base in ("clamp", "clamp_min", "clamp_max") and 2 <= n_args <= 3:
        # clamp(x, lo, hi) as clamp_min(x, lo) then clamp_max(., hi): the
        # same values and the same gradient (x >= lo and x <= hi)
        bounds = {"clamp": (opnds[1], opnds[2] if n_args == 3 else None),
                  "clamp_min": (opnds[1], None),
                  "clamp_max": (None, opnds[1])}[base]
        x = opnds[0]
        for op, bound in zip((OP_MAXC, OP_MINC), bounds):
            if bound is None:
                continue
            if bound[0] != C:
                return None
            ops.append(one(op, x, bound))
            x = (S, -1)
        if not ops:
            return None
    elif base in ("__lshift__", "__rshift__", "bitwise_left_shift",
                  "bitwise_right_shift") and n_args == 2:
        op = OP_SHL if "left" in base or base == "__lshift__" else OP_SHR
        ops.append(one(op, *opnds))
    else:
        return None
    if any(o is None for o in ops):
        return None
    return ops


# ---------------------------------------------------------------------------
# the tape as kernel words, and its plain emulation
# ---------------------------------------------------------------------------

def _const_bits(tape: Tape, op: int, c) -> int:
    """The 64 bits of constant ``c`` of op ``op`` as the kernels hold it:
    the integer's two's complement; float64's bits; for the types of 32
    bits and less float32's bits in the low word, but a ``pow`` exponent
    whole (float64), as PyTorch picks its kernel by its value."""
    if tape.dtype in _INTS:
        return int(c) & 0xFFFFFFFFFFFFFFFF
    if tape.dtype == torch.float64 or op == OP_POW:
        return int(np.float64(c).view(np.uint64))
    return int(np.float32(c).view(np.uint32))


def _int32(w: int) -> int:
    w &= 0xFFFFFFFF
    return w - (1 << 32) if w >= 1 << 31 else w


def tape_constants(tape: Tape) -> list:
    """The tape's distinct constant bit patterns, in the order the words
    hold them (two words each)."""
    pool = []
    for op, opnds in tape.ops:
        for k, x in opnds:
            b = _const_bits(tape, op, x) if k == C else None
            if b is not None and b not in pool:
                pool.append(b)
    return pool


def tape_words(tape: Tape) -> list:
    """The tape as int32 words: its gradient mask (bit ``s``: op ``s``'s
    backward runs, :attr:`Tape.grads`), one word an op, then two words a
    constant (low, high; :func:`tape_constants`). An op's word is ``op |
    keep << 7 | a << 8 | b << 16 | c << 24``: ``keep`` says that a later op
    other than the next reads its result, and each operand byte is a slot
    (``0 .. 32``), ``0x40 | k`` constant ``k``, or ``0xC0`` none."""
    pool = tape_constants(tape)
    n = len(tape.ops)
    keep = [False] * (n + 1)
    for s, (_, opnds) in enumerate(tape.ops):
        for k, x in opnds:
            if k == S and x != s:
                keep[x] = True
    words = [_int32(sum(1 << s for s, g in enumerate(tape.grads) if g))]
    for s, (op, opnds) in enumerate(tape.ops):
        w = op | int(keep[s + 1]) << 7
        for i in range(3):
            if i >= len(opnds):
                byte = 0xC0
            elif opnds[i][0] == S:
                byte = opnds[i][1]
            else:
                byte = 0x40 | pool.index(_const_bits(tape, op, opnds[i][1]))
            w |= byte << (8 + 8 * i)
        words.append(_int32(w))
    for b in pool:
        words += [_int32(b), _int32(b >> 32)]
    return words


def _torch_op(op: int, args: list, dtype, dev):
    """Op ``op`` on torch operands (tensors or numbers) as the trace holds
    it, in ``dtype`` on ``dev``."""
    def t(x):   # a number as the 0-dim constant of the dtype
        return x if isinstance(x, torch.Tensor) else torch.scalar_tensor(
            x, dtype=dtype, device=dev)
    a = args[0]
    b = args[1] if len(args) > 1 else None
    if op in _TORCH_UNARY:
        return _TORCH_UNARY[op](a)
    if op in (OP_ADD, OP_MUL, OP_AND, OP_OR, OP_XOR) and not isinstance(
            a, torch.Tensor):
        a, b = b, a                       # a number first: commutative
    if op == OP_SUB and not isinstance(a, torch.Tensor):
        return torch.rsub(b, a)
    if op in _TORCH_BINARY:
        return _TORCH_BINARY[op](a, b)
    if op == OP_WHERE:
        return torch.where(a, t(b), t(args[2]))
    if op == OP_POW:
        return torch.pow(a, b)
    if op == OP_GELU_TANH:
        return torch.nn.functional.gelu(a, approximate="tanh")
    if op == OP_SOFTPLUS:
        return torch.nn.functional.softplus(a, b, args[2])
    if op == OP_HARDTANH:
        return torch.ops.aten.hardtanh(a, b, args[2])
    if op == OP_FLOORDIV:
        return torch.div(a, b, rounding_mode="floor")
    if op == OP_TRUNCDIV:
        return torch.div(a, b, rounding_mode="trunc")
    raise ValueError(f"op {op}")


_TORCH_UNARY = {
    OP_NEG: torch.neg, OP_ABS: torch.abs, OP_RELU: torch.relu,
    OP_EXP: torch.exp, OP_EXPM1: torch.expm1, OP_LOG: torch.log,
    OP_LOG1P: torch.log1p, OP_SQRT: torch.sqrt, OP_RSQRT: torch.rsqrt,
    OP_TANH: torch.tanh, OP_SIGMOID: torch.sigmoid,
    OP_NOT: torch.bitwise_not, OP_SIN: torch.sin, OP_COS: torch.cos,
    OP_LNOT: torch.logical_not, OP_RECIP: torch.reciprocal,
    OP_FLOOR: torch.floor, OP_CEIL: torch.ceil, OP_TRUNC: torch.trunc,
    OP_ROUND: torch.round, OP_SIGN: torch.sign, OP_ERF: torch.erf,
    OP_LOG2: torch.log2, OP_EXP2: torch.exp2,
    OP_GELU: torch.nn.functional.gelu, OP_SILU: torch.nn.functional.silu}
_TORCH_BINARY = {
    OP_ADD: torch.add, OP_SUB: torch.sub, OP_MUL: torch.mul,
    OP_DIV: torch.div, OP_MAXC: torch.clamp_min, OP_MINC: torch.clamp_max,
    OP_AND: torch.bitwise_and, OP_OR: torch.bitwise_or,
    OP_XOR: torch.bitwise_xor, OP_SHL: torch.bitwise_left_shift,
    OP_SHR: torch.bitwise_right_shift, OP_EQ: torch.eq, OP_NE: torch.ne,
    OP_LT: torch.lt, OP_LE: torch.le, OP_GT: torch.gt, OP_GE: torch.ge,
    OP_LAND: torch.logical_and, OP_LOR: torch.logical_or,
    OP_MAXIMUM: torch.maximum, OP_MINIMUM: torch.minimum,
    OP_LEAKY: torch.nn.functional.leaky_relu, OP_REM: torch.remainder,
    OP_FMOD: torch.fmod}


def _values(tape: Tape, u: torch.Tensor) -> list:
    """Every slot's values: the input, then each op's result, as eager
    torch computes them on ``u``'s device in its dtype."""
    vals = [u]
    for op, opnds in tape.ops:
        args = [vals[x] if k == S else
                (bool(x) if u.dtype == torch.bool else x)   # bool's NOT
                for k, x in opnds]
        vals.append(_torch_op(op, args, u.dtype, u.device))
    return vals


def eval_tape(tape: Tape, u: torch.Tensor) -> torch.Tensor:
    """The tape's ops as eager torch ops on ``u``'s device, one by one in
    its dtype (constants as the trace held them): what the kernels
    compute, and equal to ``tape.fn(u)`` on every input."""
    return _values(tape, u)[-1] if tape.ops else u.clone()


def tape_vjp(tape: Tape, u: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """The map's VJP at ``u`` as eager autograd computes it on ``u``'s
    device, and K5 on the card: reverse mode over the tape, each op's
    cotangents by the aten ops of autograd's formula for it
    (``tools/autograd/derivatives.yaml``) in ``u``'s dtype, one cotangent a
    slot, the ops whose backward autograd runs (:attr:`Tape.grads`) last
    first, and the cotangents a slot receives summed in that order (as
    autograd's engine runs a graph's ops and sums what a tensor receives).
    Raises where autograd has no derivative (``floor_divide``)."""
    if not tape.ops:
        return ct.clone()
    if tape.nodiff:
        raise RuntimeError(f"map {tape.name!r}: derivative for "
                           f"aten::floor_divide is not implemented")
    vals = _values(tape, u)
    n = len(tape.ops)
    adj = [None] * (n + 1)
    adj[n] = ct
    for s in range(n - 1, -1, -1):
        if not tape.grads[s]:
            continue
        op, opnds = tape.ops[s]
        gs = _backward(op, adj[s + 1], [vals[x] if k == S else x
                                        for k, x in opnds], vals[s + 1])
        for i in _diff_operands(op):
            if i >= len(opnds) or opnds[i][0] != S or gs[i] is None:
                continue
            x = opnds[i][1]
            if x and tape.ops[x - 1][0] in _BOOL_RESULT:
                continue
            adj[x] = gs[i] if adj[x] is None else adj[x] + gs[i]
    return torch.zeros_like(ct) if adj[0] is None else adj[0]


def _backward(op, g, xs, y) -> tuple:
    """The operands' cotangents of one op from its output's cotangent
    ``g`` (None for an operand it sends none), by the aten ops of
    autograd's formula for it, in the tape's dtype: ``xs`` the operands
    (tensors, or the numbers of constants), ``y`` the op's result."""
    x = xs[0]
    b = xs[1] if len(xs) > 1 else None
    zero = torch.zeros_like(g)
    if op == OP_ADD:
        return g, g
    if op == OP_SUB:
        return g, -g
    if op == OP_MUL:
        return g * b, g * x
    if op == OP_DIV:
        return g / b, -g * ((x / b) / b)
    if op == OP_NEG:
        return -g, None
    if op == OP_ABS:
        return g * x.sgn(), None
    if op == OP_MAXC:
        return torch.where(x >= b, g, zero), None
    if op == OP_MINC:
        return torch.where(x <= b, g, zero), None
    if op == OP_RELU:
        return torch.ops.aten.threshold_backward(g, y, 0), None
    if op == OP_EXP:
        return g * y, None
    if op == OP_EXPM1:
        return g * (y + 1), None
    if op == OP_LOG:
        return g.div(x), None
    if op == OP_LOG1P:
        return g / (x + 1), None
    if op == OP_SQRT:
        return g / (2 * y), None
    if op == OP_RSQRT:
        return -0.5 * g * y.pow(3), None
    if op == OP_TANH:
        return torch.ops.aten.tanh_backward(g, y), None
    if op == OP_SIGMOID:
        return torch.ops.aten.sigmoid_backward(g, y), None
    if op == OP_SIN:
        return g * x.cos(), None
    if op == OP_COS:
        return g * -x.sin(), None
    if op == OP_WHERE:
        return None, torch.where(x, g, zero), torch.where(x, zero, g)
    if op in (OP_MAXIMUM, OP_MINIMUM):
        half = torch.where(x == b, g / 2, g)
        lo, hi = (x < b, x > b) if op == OP_MAXIMUM else (x > b, x < b)
        return half.masked_fill(lo, 0), half.masked_fill(hi, 0)
    if op == OP_POW:
        e = float(b)
        if e == 0.0:
            return zero, None
        return g * (e * x.pow(e - 1)), None
    if op == OP_RECIP:
        return -g * (y * y), None
    if op in (OP_FLOOR, OP_CEIL, OP_TRUNC, OP_ROUND, OP_SIGN, OP_FLOORDIV,
              OP_TRUNCDIV):
        return zero, None
    if op in (OP_REM, OP_FMOD):
        return g, None
    if op == OP_ERF:
        return 2.0 / math.sqrt(math.pi) * torch.exp(-(x.pow(2))) * g, None
    if op == OP_LOG2:
        return g / (x * 0.6931471805599453), None
    if op == OP_EXP2:
        return g * y * math.log(2.0), None
    if op in (OP_GELU, OP_GELU_TANH):
        return torch.ops.aten.gelu_backward(
            g, x, approximate="none" if op == OP_GELU else "tanh"), None
    if op == OP_SILU:
        return torch.ops.aten.silu_backward(g, x), None
    if op == OP_SOFTPLUS:
        return torch.ops.aten.softplus_backward(g, x, b, xs[2]), None
    if op == OP_LEAKY:
        return torch.ops.aten.leaky_relu_backward(g, x, b, False), None
    if op == OP_HARDTANH:
        return torch.ops.aten.hardtanh_backward(g, x, b, xs[2]), None
    raise ValueError(f"op {op} has no gradient")
