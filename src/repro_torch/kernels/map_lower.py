"""Lower a ``Map``'s torch function to a tape the fused kernels run.

The reference's fused kernel calls a ``Map`` callable on the tile inside
the kernel; a CUDA kernel cannot call Python. So the port traces the
function per ``(Map.name, dtype)`` with ``make_fx`` on a one-element
tensor and keeps it when the trace is a DAG of at most :data:`TAPE_MAX`
element-wise aten ops from a closed list. An op's operands are earlier
values of the tape (*slots*: slot 0 the map's input, slot ``k + 1`` the
result of op ``k``; a value may feed any number of later ops) or Python
numbers (and the 0-dim constants ``torch.where`` makes of them). Ops
whose results do not reach the output are dropped, so the output is the
last op's result, and it must have the map's dtype.

Every value has its own dtype (``Tape.types``), as the trace gives it:
a cast (``.float()``, ``.to(dtype)``, ``_to_copy``) is an op of the tape
(a cast to bool is ``x != 0``), and where an aten op's operands differ
in dtype, the trace's type promotion is written out as casts of the
operands to the op's compute dtype (``Tape.ctypes``), one cast a use, as
PyTorch's kernels cast each operand to the common dtype. A bool operand
of a product or the condition of ``where`` is read as 0 or 1. A tape
whose values all have the map's dtype (or are bool) and whose ops are the
register path's is *untyped* and runs there, in the base kernels; any
other tape is *typed* (:attr:`Tape.typed`: a cast, a value of another
dtype, an op past that list, a remainder by a value) and runs in K4b's
and K5's ext map kernels, each value a 64-bit word read as its own type
(no op of a typed tape computes in uint32 or uint64; casts to and from
them do).

K4b and K5 (``tile_epilogue.cuh``) evaluate the tape on register values
as PyTorch's CUDA kernel for each aten op computes it in the op's compute
dtype: float32 and float64 ops in their type, rounded once an op (a
division by a constant is a product with its reciprocal, as PyTorch's
CUDA ``div`` computes it); bfloat16 and float16 ops in float, rounded to
the type after each op; integer ops (8, 16 and 32 bits) in int narrowed to
the type's width after each op, so they wrap where torch wraps; int64 and
uint64 in 64 bits (bool: ``~`` as an XOR with 1, and only ``&``, ``|``,
``^`` and ``*``, which keep 0 and 1); a cast as ``c10::convert`` casts
(through float32 into the half floats, through int64 into uint8). A
number operand is held as the CUDA kernel holds it: in the op's compute
type for arithmetic, rounded to the dtype where torch casts it there
(comparisons, ``where``, ``clamp``, ``remainder``, ``fmod``, the shrinks,
``threshold``, ``nan_to_num``), and a ``pow`` exponent whole, since
PyTorch picks its kernel by the exponent's value. K5 takes the map's
gradient by reverse mode over the tape (:func:`tape_vjp`): each op's
derivative is autograd's formula for it (a cast's the cotangent cast back
to its source dtype; a cast to or from an integer or bool stops it), and
the cotangents of a value that feeds several ops are summed in its dtype
in the order autograd's engine receives them (the last consumer first).

A function the list does not cover, one whose trace fails (``.item()``,
data-dependent Python branches), holds a tensor constant, meets a dtype
the kernels do not hold (complex), or is longer than :data:`TAPE_MAX` ops
is not lowered (``Tape.ops is None``): a cluster that holds it runs stage
by stage and counts a fused fallback. A float function lowers for
float32, bfloat16, float16 and float64 alike or for none of them (their
traces compared with the casts left out). An op torch does not define for
a type (most of them for uint16, uint32 and uint64 on the CPU; the
activations for the integers) fails the trace, so the map is not lowered
for that type. Tapes are kept in a bounded cache by ``(Map.name, dtype)``,
each holding its function (another function under a cached name is
lowered anew), and dropped by ``combinators.clear_caches``.
"""
from __future__ import annotations

import math
import operator
import threading
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np
import torch

TAPE_MAX = 32     # ops a tape may hold (K5 keeps each op's result a value)
CONST_MAX = 64    # distinct constants a tape may hold (6-bit operand index)

S, C = 0, 2       # operand kinds: a slot of the tape, a constant
_G = 1            # (in a node's group while lowering: an op of the group)

# opcodes, kept equal to tile_epilogue.cuh
(OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_NEG, OP_ABS, OP_MAXC, OP_MINC, OP_RELU,
 OP_EXP, OP_EXPM1, OP_LOG, OP_LOG1P, OP_SQRT, OP_RSQRT, OP_TANH, OP_SIGMOID,
 OP_NOT, OP_AND, OP_OR, OP_XOR, OP_SHL, OP_SHR, OP_SIN, OP_COS,
 OP_EQ, OP_NE, OP_LT, OP_LE, OP_GT, OP_GE, OP_LNOT, OP_LAND, OP_LOR,
 OP_WHERE, OP_MAXIMUM, OP_MINIMUM, OP_POW, OP_RECIP, OP_FLOOR, OP_CEIL,
 OP_TRUNC, OP_ROUND, OP_SIGN, OP_ERF, OP_LOG2, OP_EXP2, OP_GELU,
 OP_GELU_TANH, OP_SILU, OP_SOFTPLUS, OP_LEAKY, OP_HARDTANH, OP_FLOORDIV,
 OP_TRUNCDIV, OP_REM, OP_FMOD,
 OP_CAST, OP_ISNAN, OP_ISINF, OP_SIGNBIT, OP_NAN_TO_NUM, OP_COPYSIGN,
 OP_POWT, OP_ATAN2, OP_HYPOT, OP_LERP, OP_ADDCMUL, OP_ADDCDIV, OP_ELU,
 OP_ELU_SCALED, OP_HARDSIGMOID, OP_HARDSWISH, OP_MISH, OP_LOGSIGMOID,
 OP_HARDSHRINK, OP_SOFTSHRINK, OP_THRESHOLD, OP_LOGIT, OP_TAN, OP_ATAN,
 OP_ASIN, OP_ACOS, OP_SINH, OP_COSH, OP_ASINH, OP_ACOSH, OP_ATANH,
 OP_ERFC, OP_ERFINV, OP_LOG10, OP_XLOGY, OP_SINC, OP_ROUND_DEC) = range(94)

_FLOATS = (torch.float32, torch.bfloat16, torch.float16, torch.float64)
_INTS = (torch.int32, torch.int8, torch.uint8, torch.int16, torch.uint16,
         torch.uint32, torch.bool, torch.int64, torch.uint64)
_WIDE = (torch.int64, torch.uint64, torch.float64)   # 64-bit constants
# a value's dtype as the kernels name it (bmmc_permute._ELEM_TYPE's codes;
# bool 12)
TYPE_CODE = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2,
             torch.float16: 3, torch.int8: 4, torch.uint8: 5,
             torch.int16: 6, torch.uint16: 7, torch.uint32: 8,
             torch.int64: 9, torch.uint64: 10, torch.float64: 11,
             torch.bool: 12}
_UNARY_FLOAT = {
    "exp": OP_EXP, "expm1": OP_EXPM1, "log": OP_LOG, "log1p": OP_LOG1P,
    "sqrt": OP_SQRT, "rsqrt": OP_RSQRT, "tanh": OP_TANH,
    "sigmoid": OP_SIGMOID, "sin": OP_SIN, "cos": OP_COS, "erf": OP_ERF,
    "log2": OP_LOG2, "exp2": OP_EXP2, "reciprocal": OP_RECIP,
    "silu": OP_SILU, "hardsigmoid": OP_HARDSIGMOID,
    "hardswish": OP_HARDSWISH, "mish": OP_MISH, "tan": OP_TAN,
    "atan": OP_ATAN, "asin": OP_ASIN, "acos": OP_ACOS, "sinh": OP_SINH,
    "cosh": OP_COSH, "asinh": OP_ASINH, "acosh": OP_ACOSH,
    "atanh": OP_ATANH, "erfc": OP_ERFC, "erfinv": OP_ERFINV,
    "log10": OP_LOG10, "sinc": OP_SINC}
_ROUNDING = {"floor": OP_FLOOR, "ceil": OP_CEIL, "trunc": OP_TRUNC,
             "round": OP_ROUND, "sign": OP_SIGN}
_BINARY = {"add": OP_ADD, "sub": OP_SUB, "mul": OP_MUL, "div": OP_DIV,
           "bitwise_and": OP_AND, "bitwise_or": OP_OR,
           "bitwise_xor": OP_XOR}
_COMPARE = {"eq": OP_EQ, "ne": OP_NE, "lt": OP_LT, "le": OP_LE, "gt": OP_GT,
            "ge": OP_GE}
_LOGICAL = {"logical_not": OP_LNOT, "logical_and": OP_LAND,
            "logical_or": OP_LOR}
_TESTS = {"isnan": OP_ISNAN, "isinf": OP_ISINF, "signbit": OP_SIGNBIT}
_INT_ONLY = (OP_NOT, OP_AND, OP_OR, OP_XOR, OP_SHL, OP_SHR)
_BOOL_OPS = (OP_AND, OP_OR, OP_XOR, OP_MUL)   # and OP_NOT, as an XOR
_BOOL_RESULT = tuple(_COMPARE.values()) + tuple(_LOGICAL.values()) + tuple(
    _TESTS.values())
# the ops past the register path's list (but a cast): a tape that holds
# one is typed and runs in the ext map kernels
_EXT_OPS = frozenset(range(OP_ISNAN, OP_ROUND_DEC + 1))
# dtypes no typed op computes in (their ops compare and divide unsigned)
_UNSIGNED_WIDE = (torch.uint32, torch.uint64)
# numbers torch casts to the tensor's dtype before the op
_CAST_CONST = _BOOL_RESULT + (OP_MAXC, OP_MINC, OP_WHERE, OP_REM, OP_FMOD,
                              OP_COPYSIGN, OP_HARDSHRINK, OP_SOFTSHRINK,
                              OP_THRESHOLD, OP_NAN_TO_NUM, OP_XLOGY)


class Tape:
    """A map lowered for one dtype: ``ops`` a tuple of ``(op, operands)``,
    each operand ``(S, slot)`` or ``(C, number)`` (see the module
    docstring), or None when ``fn`` is not lowered; ``types[s]`` slot
    ``s``'s dtype, ``ctypes[k]`` op ``k``'s compute dtype (a cast's:
    its source); ``grads[k]`` whether op ``k`` lies on a differentiable
    path to the output (its backward runs); ``nodiff`` whether such an op
    has no derivative in autograd (``floor_divide``). ``name`` and ``fn``
    are the ``Map``'s."""

    __slots__ = ("name", "fn", "dtype", "ops", "grads", "nodiff", "types",
                 "ctypes")

    def __init__(self, name: str, fn: Callable, dtype, ops, grads=(),
                 nodiff=False, types=None, ctypes=None):
        self.name, self.fn, self.dtype, self.ops = name, fn, dtype, ops
        self.grads, self.nodiff = tuple(grads), nodiff
        n = len(ops or ())
        self.types = tuple(types) if types is not None else (dtype,) * (n + 1)
        self.ctypes = tuple(ctypes) if ctypes is not None else (dtype,) * n

    @property
    def lowered(self) -> bool:
        return self.ops is not None

    @property
    def typed(self) -> bool:
        """Does the tape hold a value of another dtype than the map's (or
        bool), an op past the register path's list (:data:`_EXT_OPS`), or
        a remainder or fmod by a value? Such a tape runs in K4b's and K5's
        ext map kernels (``-DREPRO_MAP_EXT``, type words beside its ops);
        the others on the register path of the base kernels, as before."""
        own = (self.dtype, torch.bool)
        return bool(self.ops) and (
            any(t not in own for t in self.types + self.ctypes)
            or any(op in _EXT_OPS or (op in (OP_REM, OP_FMOD)
                                      and opnds[1][0] == S)
                   for op, opnds in self.ops))

    @property
    def mixed(self) -> bool:
        """A typed tape whose every value is float32, bfloat16, float16 or
        bool, of a map of one of the first three: the ext kernels run it on
        float registers, each op rounded to its own type."""
        fam = (torch.float32, torch.bfloat16, torch.float16, torch.bool)
        return self.typed and self.dtype in fam[:3] and all(
            t in fam for t in self.types + self.ctypes)


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
    low = _lower(fn, dtype)
    if low is None:
        got = Tape(name, fn, dtype, None)
    else:
        ops, types, ctypes, nodiff = low
        got = Tape(name, fn, dtype, ops, _grad_ops(ops, types), nodiff,
                   types, ctypes)
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
    """A tape's ops and slots with its casts left out (a cast's result
    read as its operand) and its constants: what the four float types'
    traces must share."""
    alias, out = {0: 0}, []
    for s, (op, opnds) in enumerate(ops):
        if op == OP_CAST:
            alias[s + 1] = alias[opnds[0][1]]
            continue
        out.append((op, tuple((S, alias[x]) if k == S else C
                              for k, x in opnds)))
        alias[s + 1] = len(out)
    return out


def _lower(fn: Callable, dtype) -> Optional[tuple]:
    """(ops, types, ctypes, nodiff) of ``fn`` for ``dtype``. A float
    function is lowered only when its float32, bfloat16, float16 and
    float64 traces are the same ops on the same operands once their casts
    are left out (a cast to the map's own dtype is no op of the trace;
    constants may round differently), so whether a map runs in the
    kernels, and with it the round-trip model, does not depend on which
    float type it meets."""
    if dtype not in _FLOATS and dtype not in _INTS:
        return None
    got = _trace(fn, dtype)
    if got is None or not _same_at_two_lengths(fn, dtype, got):
        return None
    if dtype not in _FLOATS:
        return got
    for other in _FLOATS:
        o = _trace(fn, other) if other != dtype else got
        if o is None or _shape(got[0]) != _shape(o[0]):
            return None
    return got


def _same_at_two_lengths(fn: Callable, dtype, got: tuple) -> bool:
    """Is ``got`` (the trace on one element) also the tape of ``fn`` on two
    elements? A function that reads its input's shape (``len(v)``,
    ``v.size(-1)``, ``v.numel()``) traces its length as a number, which
    the tape would keep while the function itself meets tiles and arrays
    of other lengths: such a map is not lowered."""
    other = _trace(fn, dtype, 2)
    if other is None:
        return False
    one, two = (tape_words(Tape("", None, dtype, ops, _grad_ops(ops, types),
                                types=types, ctypes=ctypes))
                for ops, types, ctypes, _ in (got, other))
    return one == two


def _name(nd) -> str:
    return getattr(nd.target, "__name__", str(nd.target))


def _trace(fn: Callable, dtype, length: int = 1) -> Optional[tuple]:
    from torch.fx.experimental.proxy_tensor import make_fx
    try:
        gm = make_fx(lambda v: fn(v), tracing_mode="real")(
            torch.ones(length, dtype=dtype))
    except Exception:   # any trace failure: the function is not lowered
        return None
    nodes = list(gm.graph.nodes)
    ph = [nd for nd in nodes if nd.op == "placeholder"]
    (out,) = [nd for nd in nodes if nd.op == "output"]
    if len(ph) != 1:
        return None
    slot = {ph[0]: 0}      # node -> slot
    types = [dtype]        # slot -> dtype
    consts = {}            # node -> number (a 0-dim constant)
    pairs = {}             # log_sigmoid_forward node -> its input
    ops, ctypes, nodiff = [], [], set()
    for nd in nodes:
        if nd.op in ("placeholder", "output"):
            continue
        if nd.op != "call_function":
            return None
        name = _name(nd)
        val = nd.meta.get("val")
        if name == "log_sigmoid_forward.default" and len(nd.args) == 1:
            pairs[nd] = nd.args[0]     # (out, buffer), read by getitem
            continue
        if nd.target is operator.getitem:
            src, idx = nd.args
            if src not in pairs or idx != 0:
                continue               # the buffer: an op reading it fails
            got = _Group(slot, types, consts, dtype).unary(
                OP_LOGSIGMOID, pairs[src], val.dtype)
        else:
            if not isinstance(val, torch.Tensor):
                return None
            c = _scalar_const(nd, val)
            if c is not None:
                consts[nd] = c
                continue
            if val.dtype not in TYPE_CODE or tuple(val.shape) != (length,):
                return None
            got = _op(nd, _Group(slot, types, consts, dtype), val.dtype)
        if not got:
            return None
        base = len(ops)
        for op, opnds, ct, rt in got:
            ops.append((op, tuple((S, base + x + 1) if k == _G else (k, x)
                                  for k, x in opnds)))
            ctypes.append(ct)
            types.append(rt)
        if types[-1] != val.dtype:
            return None
        if "floor_divide" in name:
            nodiff.add(len(ops) - 1)
        slot[nd] = len(ops)
    res = out.args[0]
    if not isinstance(res, torch.fx.Node) or res not in slot or types[
            slot[res]] != dtype:
        return None
    ops, kept = _prune(ops, slot[res])
    types = [dtype] + [types[s + 1] for s in kept]
    ctypes = [ctypes[s] for s in kept]
    tape = Tape("", None, dtype, ops, types=types, ctypes=ctypes)
    if len(ops) > TAPE_MAX or len(tape_constants(tape)) > CONST_MAX:
        return None
    if tape.typed and any(ct in _UNSIGNED_WIDE for (op, _), ct in zip(
            ops, ctypes) if op != OP_CAST):
        return None          # typed ops compute in int, int64 or floats
    grads = _grad_ops(tuple(ops), types)
    return (tuple(ops), tuple(types), tuple(ctypes),
            any(grads[kept.index(s)] for s in nodiff if s in kept))


def _scalar_const(nd, val):
    """The number of a 0-dim constant the trace makes of a Python number
    (``torch.where``'s ``scalar_tensor``), rounded to its dtype; None for
    any other node."""
    if _name(nd) != "scalar_tensor.default" or val.dim() or (
            val.dtype not in TYPE_CODE):
        return None
    c = nd.args[0]
    if isinstance(c, bool) or not isinstance(c, (int, float)) or (
            isinstance(c, float) and math.isnan(c)):
        return None
    return _cast(c, val.dtype)


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
    if op in (OP_ADDCMUL, OP_ADDCDIV):
        return (0, 1, 2)
    return (0, 1)


def _grad_ops(ops, types) -> tuple:
    """Per op: does its result reach the output through ops that
    differentiate it (so autograd runs its backward)? Only float values
    carry a gradient."""
    n = len(ops)
    if not n:
        return ()
    live = [False] * (n + 1)
    live[n] = True
    for s in range(n - 1, -1, -1):
        if not live[s + 1] or types[s + 1] not in _FLOATS:
            continue
        op, opnds = ops[s]
        for i in _diff_operands(op):
            if i < len(opnds) and opnds[i][0] == S and types[
                    opnds[i][1]] in _FLOATS:
                live[opnds[i][1]] = True
    return tuple(live[1:])


class _Group:
    """The tape ops of one aten node as they are made: ``(op, operands,
    compute dtype, result dtype)``, an operand ``(_G, j)`` the group's op
    ``j``; the trace's slots, their dtypes and its constant nodes."""

    def __init__(self, slot, types, consts, dtype):
        self.slot, self.types, self.consts = slot, types, consts
        self.dtype = dtype           # the map's
        self.ops = []

    def operand(self, arg):
        """(kind, slot or number) of one argument, or None."""
        if isinstance(arg, torch.fx.Node):
            if arg in self.slot:
                return S, self.slot[arg]
            if arg in self.consts:
                return C, self.consts[arg]
            return None
        if isinstance(arg, bool) or not isinstance(arg, (int, float)):
            return None
        return C, arg

    def type_of(self, o):
        if o is None or o[0] == C:
            return None
        return self.types[o[1]] if o[0] == S else self.ops[o[1]][3]

    def cast(self, o, to):
        """Operand ``o`` cast to ``to`` (a tape op), or None."""
        t = self.type_of(o)
        if t == to:
            return o
        if t not in TYPE_CODE or to not in TYPE_CODE:
            return None
        if to == torch.bool:        # bool(x) is x != 0
            self.ops.append((OP_NE, (o, (C, 0)), t, torch.bool))
        else:
            self.ops.append((OP_CAST, (o,), t, to))
        return _G, len(self.ops) - 1

    def emit(self, op, xs, ct, rt, bool_ok=()):
        """Op ``op`` on operands ``xs`` computed in ``ct`` into ``rt``:
        operands of another dtype cast to ``ct`` (a bool one kept at the
        positions ``bool_ok``), numbers held as the kernel holds them.
        The group's last op, or None where the op does not lower."""
        xs = list(xs)
        if not xs or None in xs or ct not in TYPE_CODE:
            return None
        if xs[0][0] == C and not (op == OP_SUB and xs[1][0] != C):
            return None      # a constant comes first only in rsub's c - x
        is_float = ct in _FLOATS
        if op in _INT_ONLY and is_float:
            return None
        if ct == torch.bool:
            if self.dtype != torch.bool and op not in (
                    OP_LAND, OP_LOR, OP_LNOT, OP_WHERE, OP_MUL, OP_NE):
                return None
            if self.dtype == torch.bool:
                if op == OP_NOT:    # ~ on 0 and 1: an XOR with 1
                    op, xs = OP_XOR, [xs[0], (C, 1)]
                elif op not in _BOOL_OPS + (OP_WHERE,):
                    return None
        if op in (OP_SHL, OP_SHR) and not (
                xs[1][0] == C and isinstance(xs[1][1], int)
                and 0 <= xs[1][1] < (64 if ct in _WIDE else 32)):
            return None
        for i, o in enumerate(xs):
            if o[0] == C:
                if op in _CAST_CONST or op == OP_XOR and ct == torch.bool:
                    c = _cast(o[1], ct) if ct != torch.bool else o[1]
                else:
                    c = _number(o[1], ct)
                if c is None:
                    return None
                xs[i] = (C, c)
                continue
            t = self.type_of(o)
            if t == ct or (t == torch.bool and i in bool_ok):
                continue
            xs[i] = self.cast(o, ct)
            if xs[i] is None:
                return None
        self.ops.append((op, tuple(xs), ct, rt))
        return _G, len(self.ops) - 1

    def unary(self, op, arg, rt):
        x = self.operand(arg)
        if x is None or rt not in _FLOATS:
            return None
        return self.ops if self.emit(op, [x], rt, rt) else None


def _number(c, ct):
    """A number operand of an arithmetic op computed in ``ct``, or None
    where the op's type cannot take it."""
    if ct == torch.bool:
        return None
    if ct in _INTS:
        if not isinstance(c, int) or not (
                torch.iinfo(ct).min <= c <= torch.iinfo(ct).max):
            return None
        return int(c)
    if math.isnan(float(c)):
        return None
    return c


def _promoted(g: _Group, xs) -> Optional[torch.dtype]:
    """The dtype torch computes two operands in (a tensor against a
    number by ``torch.result_type``'s rules)."""
    args = []
    for o in xs:
        if o is None:
            return None
        t = g.type_of(o)
        args.append(torch.ones(1, dtype=t) if t is not None else o[1])
    if len(args) == 1:
        return g.type_of(xs[0])
    if not any(isinstance(a, torch.Tensor) for a in args):
        return None
    return torch.result_type(*args)


def _op(nd, g: _Group, rt) -> Optional[list]:
    """The tape ops ``(op, operands, ctype, rtype)`` of one aten node
    (result dtype ``rt``), or None; an operand ``(_G, j)`` is the result
    of the group's op ``j``."""
    name = _name(nd)   # e.g. "add.Tensor"
    base, _, overload = name.partition(".")
    args = list(nd.args)
    kw = dict(nd.kwargs)
    if kw.pop("alpha", 1) != 1:
        return None
    approx = kw.pop("approximate", "none")
    mode = kw.pop("rounding_mode", None)
    value = kw.pop("value", 1)
    decimals = kw.pop("decimals", None)
    if base == "_to_copy":
        to = kw.pop("dtype", None)
        for k in ("layout", "device", "pin_memory", "memory_format"):
            kw.pop(k, None)
        if kw or len(args) != 1 or to != rt:
            return None
        x = g.operand(args[0])
        if x is None or x[0] != S or g.cast(x, rt) is None:
            return None
        return g.ops
    if kw:
        return None
    opnds = []
    for a in args:
        got = None if a is None else g.operand(a)
        if got is None and a is not None:
            return None
        opnds.append(got)      # None: an argument left out (clamp's)
    n_args = len(args)
    is_float = rt in _FLOATS

    def one(op, *xs, ct=rt, bool_ok=()):
        return g.emit(op, xs, ct, rt, bool_ok) is not None

    ok = True
    if base in _BINARY and overload in ("Tensor", "Scalar") and n_args == 2:
        op = _BINARY[base]
        if rt == torch.bool and g.dtype != torch.bool:   # on bools
            op = {OP_AND: OP_LAND, OP_OR: OP_LOR, OP_XOR: OP_NE}.get(op, op)
        ok = one(op, *opnds, bool_ok=(0, 1) if op == OP_MUL else ())
    elif base == "rsub" and overload == "Scalar" and n_args == 2:
        ok = one(OP_SUB, opnds[1], opnds[0])      # c - x
    elif base in ("neg", "abs", "relu", "bitwise_not") and n_args == 1:
        op = {"neg": OP_NEG, "abs": OP_ABS, "relu": OP_RELU,
              "bitwise_not": OP_NOT}[base]
        if op == OP_NOT and rt == torch.bool and g.dtype != torch.bool:
            op = OP_LNOT
        ok = one(op, opnds[0])
    elif base in _UNARY_FLOAT and n_args == 1 and overload in ("", "default"):
        ok = is_float and one(_UNARY_FLOAT[base], opnds[0])
    elif (base in _ROUNDING and n_args == 1 and overload in ("", "default")
          and rt != torch.bool):
        ok = one(_ROUNDING[base], opnds[0])
    elif base == "round" and overload == "decimals" and n_args == 1:
        if not is_float or not isinstance(decimals, int):
            return None
        ok = one(OP_ROUND_DEC, opnds[0], (C, math.pow(10, abs(decimals))),
                 (C, 1.0 if decimals < 0 else 0.0))
    elif base in _COMPARE and overload in ("Tensor", "Scalar") and n_args == 2:
        ct = _promoted(g, opnds)
        if ct is None or ct == torch.bool or any(
                g.type_of(o) == torch.bool for o in opnds):
            return None
        ok = one(_COMPARE[base], *opnds, ct=ct)
    elif base in _TESTS and n_args == 1:
        ct = g.type_of(opnds[0])
        if ct is None or ct == torch.bool:
            return None
        ok = one(_TESTS[base], opnds[0], ct=ct)
    elif base in _LOGICAL and n_args == (1 if base == "logical_not" else 2):
        xs = [g.cast(o, torch.bool) if o is not None and o[0] == S else None
              for o in opnds]
        ok = one(_LOGICAL[base], *xs, ct=torch.bool)
    elif base == "where" and overload == "self" and n_args == 3:
        if g.type_of(opnds[0]) != torch.bool:
            return None
        ok = one(OP_WHERE, *opnds, bool_ok=(0,))
    elif base in ("maximum", "minimum") and n_args == 2:
        if not (opnds[0][0] == S and opnds[1][0] == S) or rt == torch.bool:
            return None
        ok = one(OP_MAXIMUM if base == "maximum" else OP_MINIMUM, *opnds)
    elif base == "pow" and overload == "Tensor_Scalar" and n_args == 2:
        e = args[1]
        if opnds[1][0] != C or rt == torch.bool or (
                not is_float and not (isinstance(e, int) and e >= 0)):
            return None
        x = opnds[0] if g.type_of(opnds[0]) == rt else g.cast(opnds[0], rt)
        if x is None:
            return None
        g.ops.append((OP_POW, (x, (C, e)), rt, rt))   # the exponent whole
    elif base == "pow" and overload == "Tensor_Tensor" and n_args == 2:
        if rt == torch.bool or not all(o[0] == S for o in opnds):
            return None
        ok = one(OP_POWT, *opnds)
    elif base == "gelu" and n_args == 1 and is_float and approx in (
            "none", "tanh"):
        ok = one(OP_GELU if approx == "none" else OP_GELU_TANH, opnds[0])
    elif base == "softplus" and 1 <= n_args <= 3 and is_float:
        beta = opnds[1] if n_args > 1 else (C, 1.0)
        thr = opnds[2] if n_args > 2 else (C, 20.0)
        if beta[0] != C or thr[0] != C:
            return None
        ok = one(OP_SOFTPLUS, opnds[0], beta, thr)
    elif base == "leaky_relu" and 1 <= n_args <= 2 and is_float:
        slope = opnds[1] if n_args > 1 else (C, 0.01)
        if slope[0] != C:
            return None
        ok = one(OP_LEAKY, opnds[0], slope)
    elif base == "hardtanh" and 1 <= n_args <= 3 and rt != torch.bool:
        lo = opnds[1] if n_args > 1 else (C, -1.0 if is_float else -1)
        hi = opnds[2] if n_args > 2 else (C, 1.0 if is_float else 1)
        if lo[0] != C or hi[0] != C:
            return None
        ok = one(OP_HARDTANH, opnds[0], lo, hi)
    elif (base in ("floor_divide", "remainder", "fmod")
          or (base == "div" and overload in ("Tensor_mode", "Scalar_mode")
              and mode in ("floor", "trunc"))) and n_args == 2:
        op = {"floor_divide": OP_FLOORDIV, "remainder": OP_REM,
              "fmod": OP_FMOD}.get(base) if base != "div" else (
            OP_FLOORDIV if mode == "floor" else OP_TRUNCDIV)
        by_value = opnds[1][0] == S
        if rt == torch.bool or (by_value and op not in (OP_REM, OP_FMOD)) or (
                not by_value and not is_float and opnds[1][1] == 0):
            return None
        ok = one(op, *opnds)
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
            x = g.emit(op, (x, bound), rt, rt)
            if x is None:
                return None
        ok = bool(g.ops)
    elif base in ("__lshift__", "__rshift__", "bitwise_left_shift",
                  "bitwise_right_shift") and n_args == 2:
        op = OP_SHL if "left" in base or base == "__lshift__" else OP_SHR
        ok = one(op, *opnds)
    elif base == "nan_to_num" and 1 <= n_args <= 4 and is_float:
        fi = torch.finfo(rt)
        nan, pos, neg = (opnds[1:] + [None] * 3)[:3]
        ok = one(OP_NAN_TO_NUM, opnds[0], nan or (C, 0.0),
                 pos or (C, fi.max), neg or (C, fi.min))
    elif base == "copysign" and n_args == 2:
        ok = is_float and one(OP_COPYSIGN, *opnds)
    elif base in ("atan2", "hypot") and n_args == 2:
        if not all(o[0] == S for o in opnds):
            return None
        ok = is_float and one(OP_ATAN2 if base == "atan2" else OP_HYPOT,
                              *opnds)
    elif base == "lerp" and overload == "Scalar" and n_args == 3:
        if not (is_float and opnds[1][0] == S and opnds[2][0] == C):
            return None
        ok = one(OP_LERP, *opnds)
    elif base in ("addcmul", "addcdiv") and n_args == 3:
        if not is_float or not all(o[0] == S for o in opnds) or isinstance(
                value, bool) or not isinstance(value, (int, float)):
            return None
        ok = one(OP_ADDCMUL if base == "addcmul" else OP_ADDCDIV, *opnds,
                 (C, value))
    elif base in ("elu", "celu") and 1 <= n_args <= 4 and is_float:
        num = [a for a in args[1:]]
        if not all(isinstance(a, (int, float)) and not isinstance(a, bool)
                   for a in num):
            return None
        if base == "celu":       # elu(x, alpha, 1, 1 / alpha)
            alpha = float(num[0]) if num else 1.0
            if float(np.float32(alpha)) != alpha or alpha == 0:
                return None      # autograd's 1 / alpha is float32's
            num = [alpha, 1.0, 1.0 / alpha]
        alpha, scale, iscale = (list(map(float, num)) + [1.0, 1.0, 1.0][
            len(num):])[:3]
        if scale == 1.0:
            ok = one(OP_ELU, opnds[0], (C, alpha), (C, iscale))
        elif iscale == 1.0:
            ok = one(OP_ELU_SCALED, opnds[0], (C, alpha), (C, scale))
        else:
            return None
    elif base in ("hardshrink", "softshrink") and 1 <= n_args <= 2:
        lam = opnds[1] if n_args > 1 else (C, 0.5)
        if lam[0] != C or not is_float:
            return None
        ok = one(OP_HARDSHRINK if base == "hardshrink" else OP_SOFTSHRINK,
                 opnds[0], lam)
    elif base == "threshold" and n_args == 3:
        if opnds[1][0] != C or opnds[2][0] != C or rt == torch.bool:
            return None
        ok = one(OP_THRESHOLD, *opnds)
    elif base == "logit" and 1 <= n_args <= 2 and is_float:
        eps = args[1] if n_args > 1 else None
        eps = -1.0 if eps is None else eps
        if isinstance(eps, bool) or not isinstance(eps, (int, float)):
            return None
        ok = one(OP_LOGIT, opnds[0], (C, eps))
    elif base == "xlogy" and n_args == 2 and overload in (
            "Tensor", "Scalar_Other"):
        ok = is_float and one(OP_XLOGY, *opnds)
    else:
        return None
    if not ok or not g.ops:
        return None
    return g.ops


# ---------------------------------------------------------------------------
# the tape as kernel words, and its plain emulation
# ---------------------------------------------------------------------------

def _const_bits(ct, op: int, c) -> int:
    """The 64 bits of constant ``c`` of op ``op`` (computed in ``ct``) as
    the kernels hold it: the integer's two's complement; float64's bits;
    for the float types of 32 bits and less float32's bits in the low
    word, but a ``pow`` exponent whole (float64), as PyTorch picks its
    kernel by its value, and beside a ``lerp`` weight ``w`` float32's
    ``1 - w`` in the high word (autograd's ``grad * (1 - w)`` takes it
    from the double)."""
    if ct in _INTS:
        return int(c) & 0xFFFFFFFFFFFFFFFF
    if ct == torch.float64 or op == OP_POW:
        return int(np.float64(c).view(np.uint64))
    lo = int(np.float32(c).view(np.uint32))
    if op == OP_LERP:
        return lo | int(np.float32(1 - float(c)).view(np.uint32)) << 32
    return lo


def _int32(w: int) -> int:
    w &= 0xFFFFFFFF
    return w - (1 << 32) if w >= 1 << 31 else w


def tape_constants(tape: Tape) -> list:
    """The tape's distinct constant bit patterns, in the order the words
    hold them (two words each)."""
    pool = []
    for s, (op, opnds) in enumerate(tape.ops):
        for k, x in opnds:
            b = _const_bits(tape.ctypes[s], op, x) if k == C else None
            if b is not None and b not in pool:
                pool.append(b)
    return pool


def _operand_byte(tape, pool, s, o) -> int:
    if o[0] == S:
        return o[1]
    op = tape.ops[s][0]
    return 0x40 | pool.index(_const_bits(tape.ctypes[s], op, o[1]))


def tape_words(tape: Tape) -> list:
    """The tape as int32 words: its gradient mask (bit ``s``: op ``s``'s
    backward runs, :attr:`Tape.grads`), one word an op, for a typed tape
    (:attr:`Tape.typed`) one type word an op, then two words a constant
    (low, high; :func:`tape_constants`). An op's word is ``op | keep << 7
    | a << 8 | b << 16 | c << 24``: ``keep`` says that a later op other
    than the next reads its result, and each operand byte is a slot
    (``0 .. 32``), ``0x40 | k`` constant ``k``, or ``0xC0`` none. A type
    word is ``rt | ct << 4 | bools << 8 | d << 16``: the codes
    (:data:`TYPE_CODE`) of the op's result and compute dtypes, bit ``i``
    of ``bools`` set where operand ``i`` is a bool value read as 0 or 1,
    and ``d`` a fourth operand's byte (``0xC0`` none)."""
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
            byte = (0xC0 if i >= len(opnds)
                    else _operand_byte(tape, pool, s, opnds[i]))
            w |= byte << (8 + 8 * i)
        words.append(_int32(w))
    if tape.typed:
        for s, (op, opnds) in enumerate(tape.ops):
            ct = tape.ctypes[s]
            bools = sum(1 << i for i, (k, x) in enumerate(opnds[:3])
                        if k == S and tape.types[x] == torch.bool
                        and ct != torch.bool)
            d = (_operand_byte(tape, pool, s, opnds[3]) if len(opnds) > 3
                 else 0xC0)
            words.append(_int32(TYPE_CODE[tape.types[s + 1]]
                                | TYPE_CODE[ct] << 4 | bools << 8
                                | d << 16))
    for b in pool:
        words += [_int32(b), _int32(b >> 32)]
    return words


def _torch_op(op: int, args: list, ct, rt, dev):
    """Op ``op`` on torch operands (tensors or numbers) as the trace holds
    it, computed in ``ct`` into ``rt`` on ``dev``."""
    def t(x):   # a number as the 0-dim constant of the dtype
        return x if isinstance(x, torch.Tensor) else torch.scalar_tensor(
            x, dtype=ct, device=dev)
    a = args[0]
    b = args[1] if len(args) > 1 else None
    if op == OP_CAST:
        return a.to(rt)
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
    if op in (OP_POW, OP_POWT):
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
    if op == OP_NAN_TO_NUM:
        return torch.nan_to_num(a, b, args[2], args[3])
    if op == OP_LERP:
        return torch.lerp(a, b, args[2])
    if op == OP_ADDCMUL:
        return torch.addcmul(a, b, args[2], value=args[3])
    if op == OP_ADDCDIV:
        return torch.addcdiv(a, b, args[2], value=args[3])
    if op in (OP_ELU, OP_ELU_SCALED):
        return torch.ops.aten.elu(a, *_elu_args(op, b, args[2]))
    if op == OP_HARDSHRINK:
        return torch.ops.aten.hardshrink(a, b)
    if op == OP_SOFTSHRINK:
        return torch.ops.aten.softshrink(a, b)
    if op == OP_THRESHOLD:
        return torch.ops.aten.threshold(a, b, args[2])
    if op == OP_LOGIT:
        return torch.logit(a, None if b < 0 else b)
    if op == OP_ROUND_DEC:
        return torch.round(a, decimals=_decimals(b, args[2]))
    raise ValueError(f"op {op}")


def _elu_args(op, alpha, c) -> tuple:
    """elu's (alpha, scale, input_scale) from a tape op's constants:
    alpha and the input scale (OP_ELU) or the scale (OP_ELU_SCALED)."""
    return (alpha, 1.0, c) if op == OP_ELU else (alpha, c, 1.0)


def _decimals(ten: float, neg: float) -> int:
    d = int(round(math.log10(ten)))
    return -d if neg else d


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
    OP_GELU: torch.nn.functional.gelu, OP_SILU: torch.nn.functional.silu,
    OP_ISNAN: torch.isnan, OP_ISINF: torch.isinf, OP_SIGNBIT: torch.signbit,
    OP_HARDSIGMOID: torch.nn.functional.hardsigmoid,
    OP_HARDSWISH: torch.nn.functional.hardswish,
    OP_MISH: torch.nn.functional.mish,
    OP_LOGSIGMOID: lambda a: torch.ops.aten.log_sigmoid_forward(a)[0],
    OP_TAN: torch.tan, OP_ATAN: torch.atan, OP_ASIN: torch.asin,
    OP_ACOS: torch.acos, OP_SINH: torch.sinh, OP_COSH: torch.cosh,
    OP_ASINH: torch.asinh, OP_ACOSH: torch.acosh, OP_ATANH: torch.atanh,
    OP_ERFC: torch.erfc, OP_ERFINV: torch.erfinv, OP_LOG10: torch.log10,
    OP_SINC: torch.sinc}
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
    OP_FMOD: torch.fmod, OP_COPYSIGN: torch.copysign,
    OP_ATAN2: torch.atan2, OP_HYPOT: torch.hypot, OP_XLOGY: torch.xlogy}


def _values(tape: Tape, u: torch.Tensor) -> list:
    """Every slot's values: the input, then each op's result, as eager
    torch computes them on ``u``'s device, each op in its dtype."""
    vals = [u]
    for s, (op, opnds) in enumerate(tape.ops):
        ct = tape.ctypes[s]
        args = [vals[x] if k == S else
                (bool(x) if ct == torch.bool else x)   # bool's NOT
                for k, x in opnds]
        vals.append(_torch_op(op, args, ct, tape.types[s + 1], u.device))
    return vals


def eval_tape(tape: Tape, u: torch.Tensor) -> torch.Tensor:
    """The tape's ops as eager torch ops on ``u``'s device, one by one in
    their dtypes (constants as the trace held them): what the kernels
    compute, and equal to ``tape.fn(u)`` on every input."""
    return _values(tape, u)[-1] if tape.ops else u.clone()


def tape_vjp(tape: Tape, u: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """The map's VJP at ``u`` as eager autograd computes it on ``u``'s
    device, and K5 on the card: reverse mode over the tape, each op's
    cotangents by the aten ops of autograd's formula for it
    (``tools/autograd/derivatives.yaml``) in the op's dtype, one cotangent
    a slot in the slot's dtype, the ops whose backward autograd runs
    (:attr:`Tape.grads`) last first, and the cotangents a slot receives
    summed in that order (as autograd's engine runs a graph's ops and sums
    what a tensor receives). Raises where autograd has no derivative
    (``floor_divide``)."""
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
                                        for k, x in opnds], vals[s + 1],
                       tape.ctypes[s])
        for i in _diff_operands(op):
            if i >= len(opnds) or opnds[i][0] != S or gs[i] is None:
                continue
            x = opnds[i][1]
            if tape.types[x] not in _FLOATS:
                continue
            adj[x] = gs[i] if adj[x] is None else adj[x] + gs[i]
    return torch.zeros_like(ct) if adj[0] is None else adj[0]


def _backward(op, g, xs, y, ct) -> tuple:
    """The operands' cotangents of one op from its output's cotangent
    ``g`` (None for an operand it sends none), by the aten ops of
    autograd's formula for it, in the op's dtype: ``xs`` the operands
    (tensors, or the numbers of constants), ``y`` the op's result, ``ct``
    its compute dtype (a cast's source)."""
    x = xs[0]
    b = xs[1] if len(xs) > 1 else None
    zero = torch.zeros_like(g)
    if op == OP_CAST:
        return (g.to(ct),)
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
              OP_TRUNCDIV, OP_ROUND_DEC):
        return zero, None
    if op in (OP_REM, OP_FMOD):
        if not isinstance(b, torch.Tensor):
            return g, None
        q = x.div(b, rounding_mode="floor" if op == OP_REM else "trunc")
        return g, -g * q
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
    return _backward_more(op, g, xs, y, zero)


def _backward_more(op, g, xs, y, zero) -> tuple:
    """_backward for the ops past PyTorch's one-op activations."""
    x = xs[0]
    b = xs[1] if len(xs) > 1 else None
    zeros = torch.zeros((), dtype=g.dtype, device=g.device)
    if op == OP_NAN_TO_NUM:
        return g * torch.isfinite(x), None
    if op == OP_COPYSIGN:
        ratio = y / x
        ratio.masked_fill_(x == 0, 0)
        return g * ratio, (torch.zeros_like(b) if isinstance(
            b, torch.Tensor) else None)
    if op == OP_POWT:
        ga = torch.where(b == 0.0, zeros, g * (b * x.pow(b - 1)))
        cond = torch.logical_and(x == 0, b >= 0)
        gb = g * torch.where(cond, zeros, y * x.log())
        return ga, gb
    if op == OP_ATAN2:
        recip = (x * x + b * b).reciprocal()
        return g * b * recip, g * -x * recip
    if op == OP_HYPOT:
        return g * x / y, g * b / y
    if op == OP_LERP:
        w = float(xs[2])
        return g * (1 - w), g * w
    if op == OP_ADDCMUL:
        v = xs[3]
        return g, g * (xs[2] * v), g * (b * v)
    if op == OP_ADDCDIV:
        v, c = xs[3], xs[2]
        q = torch.empty_like(c).fill_(v).div_(c)
        return g, g * q, -g * ((b * v) / (c * c))
    if op in (OP_ELU, OP_ELU_SCALED):
        return torch.ops.aten.elu_backward(
            g, *_elu_args(op, b, xs[2]), False, x), None
    if op == OP_HARDSIGMOID:
        return torch.ops.aten.hardsigmoid_backward(g, x), None
    if op == OP_HARDSWISH:
        return torch.ops.aten.hardswish_backward(g, x), None
    if op == OP_MISH:
        return torch.ops.aten.mish_backward(g, x), None
    if op == OP_LOGSIGMOID:
        buf = torch.ops.aten.log_sigmoid_forward(x)[1]
        return torch.ops.aten.log_sigmoid_backward(g, x, buf), None
    if op == OP_HARDSHRINK:
        return torch.ops.aten.hardshrink_backward(g, x, b), None
    if op == OP_SOFTSHRINK:
        return torch.ops.aten.softshrink_backward(g, x, b), None
    if op == OP_THRESHOLD:
        return torch.ops.aten.threshold_backward(g, x, b), None
    if op == OP_LOGIT:
        return torch.ops.aten.logit_backward(g, x, None if b < 0 else b), None
    if op == OP_TAN:
        return g * (1 + y.pow(2)), None
    if op == OP_ATAN:
        return g / (x * x + 1), None
    if op == OP_ASIN:
        return g * (-x * x + 1).rsqrt(), None
    if op == OP_ACOS:
        return g * -((-x * x + 1).rsqrt()), None
    if op == OP_SINH:
        return g * x.cosh(), None
    if op == OP_COSH:
        return g * x.sinh(), None
    if op == OP_ASINH:
        return g * (x.pow(2) + 1).rsqrt(), None
    if op == OP_ACOSH:
        return g * (x.pow(2) - 1).rsqrt(), None
    if op == OP_ATANH:
        return g * 1 / torch.empty_like(x).fill_(1).sub_(x.pow(2)), None
    if op == OP_ERFC:
        return -2.0 / math.sqrt(math.pi) * torch.exp(-(x.pow(2))) * g, None
    if op == OP_ERFINV:
        return 0.5 * math.sqrt(math.pi) * torch.exp(
            x.erfinv().pow(2)) * g, None
    if op == OP_LOG10:
        return g / (x * 2.3025850929940456), None
    if op == OP_XLOGY:
        ga = torch.xlogy(g, b).masked_fill((x == 0.) & (b <= 0.), 0.)
        return ga, (g * x / b if isinstance(b, torch.Tensor) else None)
    if op == OP_SINC:
        x_pi = x * math.pi
        x2_pi = x * x * math.pi
        out = g * (((x_pi * x_pi.cos()) - x_pi.sin()) / x2_pi)
        return torch.where(x2_pi == 0.0, zeros, out), None
    raise ValueError(f"op {op} has no gradient")
