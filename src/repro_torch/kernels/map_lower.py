"""Lower a ``Map``'s torch function to a tape the fused kernels run.

The reference's fused kernel calls a ``Map`` callable on the tile inside
the kernel; a CUDA kernel cannot call Python. So the port traces the
function per ``(Map.name, dtype)`` with ``make_fx`` on a
one-element tensor and keeps it only when the trace is a chain of
element-wise aten ops from a closed list, each keeping the dtype and
shape, each operand the running value (``R``, the previous op's
result), the map's input (``U``) or a Python number (``C``). K4b and K5
(``tile_epilogue.cuh``) evaluate the tape on register values: float32
and float64 ops as eager PyTorch rounds them on the card (one rounding an
op; a division by a constant is a product with its reciprocal, as
PyTorch's CUDA ``div`` computes it), bfloat16 and float16 ops in float
rounded to the type after each op, integer ops (8, 16 and 32 bits) in int
narrowed to the type's width after each op, so they wrap where torch
wraps, int64 and uint64 ops in 64 bits (bool: ``~`` as an XOR with 1, and
only ``&``, ``|``, ``^`` and ``*``, which keep 0 and 1). A 64-bit type's
constants keep all 64 bits (:func:`tape_high_words`). K5 takes the map's
gradient by reverse mode over the tape, with autograd's derivative
formulas rounded as PyTorch's CUDA kernels round them
(:func:`tape_vjp`).

A function the list does not cover, one whose trace fails (``.item()``,
data-dependent Python branches), changes dtype or shape, or is longer
than :data:`TAPE_MAX` ops is not lowered (``Tape.ops is None``): a
cluster that holds it runs stage by stage and counts a fused fallback.
A float function lowers for float32, bfloat16, float16 and float64 alike
or for none of them. An op torch does not define for a type (most of them
for uint16, uint32 and uint64 on the CPU) fails the trace, so the map is
not lowered for that type.
Tapes are kept in a bounded cache by ``(Map.name, dtype)``, each holding
its function (another function under a cached name is lowered anew),
and dropped by ``combinators.clear_caches``.
"""
from __future__ import annotations

import math
import threading
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np
import torch

TAPE_MAX = 8      # ops a tape may hold (K5 recomputes its prefix per op)

R, U, C, NONE = 0, 1, 2, 3  # operand kinds: running value, map input,
                            # constant, none (a unary op's second)

# opcodes, kept equal to tile_epilogue.cuh
(OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_NEG, OP_ABS, OP_MAXC, OP_MINC, OP_RELU,
 OP_EXP, OP_EXPM1, OP_LOG, OP_LOG1P, OP_SQRT, OP_RSQRT, OP_TANH, OP_SIGMOID,
 OP_NOT, OP_AND, OP_OR, OP_XOR, OP_SHL, OP_SHR, OP_SIN, OP_COS) = range(25)

_FLOATS = (torch.float32, torch.bfloat16, torch.float16, torch.float64)
_INTS = (torch.int32, torch.int8, torch.uint8, torch.int16, torch.uint16,
         torch.uint32, torch.bool, torch.int64, torch.uint64)
_WIDE = (torch.int64, torch.uint64, torch.float64)   # 64-bit constants
_UNARY_FLOAT = {
    "exp": OP_EXP, "expm1": OP_EXPM1, "log": OP_LOG, "log1p": OP_LOG1P,
    "sqrt": OP_SQRT, "rsqrt": OP_RSQRT, "tanh": OP_TANH,
    "sigmoid": OP_SIGMOID, "sin": OP_SIN, "cos": OP_COS}
_BINARY = {"add": OP_ADD, "sub": OP_SUB, "mul": OP_MUL, "div": OP_DIV,
           "bitwise_and": OP_AND, "bitwise_or": OP_OR,
           "bitwise_xor": OP_XOR}
_INT_ONLY = (OP_NOT, OP_AND, OP_OR, OP_XOR, OP_SHL, OP_SHR)
_BOOL_OPS = (OP_AND, OP_OR, OP_XOR, OP_MUL)   # and OP_NOT, as an XOR


class Tape:
    """A map lowered for one dtype: ``ops`` a tuple of ``(op, a, b,
    const)`` (operand kinds of :data:`R`, :data:`U`, :data:`C`; ``const``
    the Python number of a ``C`` operand), or None when ``fn`` is not
    lowered. ``name`` and ``fn`` are the ``Map``'s."""

    __slots__ = ("name", "fn", "dtype", "ops")

    def __init__(self, name: str, fn: Callable, dtype, ops):
        self.name, self.fn, self.dtype, self.ops = name, fn, dtype, ops

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
    got = Tape(name, fn, dtype, _lower(fn, dtype))
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


def _lower(fn: Callable, dtype) -> Optional[tuple]:
    """The tape ops of ``fn`` for ``dtype``. A float function is lowered
    only when its float32, bfloat16, float16 and float64 traces are the
    same ops on the same operands (constants may round differently), so
    whether a map runs in the kernels, and with it the round-trip model,
    does not depend on which float type it meets."""
    if dtype not in _FLOATS:
        return _trace(fn, dtype) if dtype in _INTS else None
    ops = _trace(fn, dtype)
    if ops is None:
        return None
    for other in _FLOATS:
        got = _trace(fn, other) if other != dtype else ops
        if got is None or [o[:3] for o in ops] != [o[:3] for o in got]:
            return None
    return ops


def _trace(fn: Callable, dtype) -> Optional[tuple]:
    from torch.fx.experimental.proxy_tensor import make_fx
    try:
        gm = make_fx(lambda v: fn(v), tracing_mode="real")(
            torch.ones(1, dtype=dtype))
    except Exception:   # any trace failure: the function is not lowered
        return None
    nodes = list(gm.graph.nodes)
    ph = [nd for nd in nodes if nd.op == "placeholder"]
    calls = [nd for nd in nodes if nd.op not in ("placeholder", "output")]
    (out,) = [nd for nd in nodes if nd.op == "output"]
    if len(ph) != 1 or len(calls) > TAPE_MAX:
        return None
    res = out.args[0]
    if calls:
        if res is not calls[-1]:
            return None
    elif res is not ph[0]:
        return None
    ops = []
    for k, nd in enumerate(calls):
        if nd.op != "call_function":
            return None
        val = nd.meta.get("val")
        if (not isinstance(val, torch.Tensor) or val.dtype != dtype
                or tuple(val.shape) != (1,)):
            return None
        if k + 1 < len(calls) and set(nd.users) != {calls[k + 1]}:
            return None          # a chain: each result feeds the next op
        prev = calls[k - 1] if k else None
        got = _op(nd, ph[0], prev, dtype)
        if got is None:
            return None
        ops.extend(got)
    if len(ops) > TAPE_MAX:
        return None
    return tuple(ops)


def _operand(arg, u, prev, dtype):
    """(kind, const) of one argument, or None."""
    if arg is u:
        return U, None
    if prev is not None and arg is prev:
        return R, None
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


def _op(nd, u, prev, dtype) -> Optional[list]:
    """The tape ops of one aten node, or None."""
    target = nd.target
    name = getattr(target, "__name__", str(target))   # e.g. "add.Tensor"
    base, _, overload = name.partition(".")
    args = list(nd.args)
    kw = dict(nd.kwargs)
    if kw.pop("alpha", 1) != 1 or kw:
        return None
    opnds = []
    for a in args:
        got = _operand(a, u, prev, dtype) if a is not None else (NONE, None)
        if got is None:
            return None
        opnds.append(got)
    is_float = dtype in _FLOATS

    def one(op, x, y=(NONE, None)):
        # a constant comes first only in rsub's c - x
        if x[0] in (NONE, C) and not (op == OP_SUB and y[0] in (R, U)):
            return None
        if op in _INT_ONLY and is_float:
            return None
        if dtype == torch.bool:
            if op == OP_NOT:    # ~ on 0 and 1: an XOR with 1
                return (OP_XOR, x[0], C, 1)
            if op not in _BOOL_OPS:
                return None
        if op in (OP_SHL, OP_SHR) and not (
                y[0] == C and 0 <= y[1] < (64 if dtype in _WIDE else 32)):
            return None
        return (op, x[0], y[0], x[1] if x[0] == C else y[1])

    ops = []
    if base in _BINARY and overload in ("Tensor", "Scalar") and len(args) == 2:
        ops.append(one(_BINARY[base], *opnds))
    elif base == "rsub" and overload == "Scalar" and len(args) == 2:
        ops.append(one(OP_SUB, opnds[1], opnds[0]))      # c - x
    elif base in ("neg", "abs", "relu", "bitwise_not") and len(args) == 1:
        op = {"neg": OP_NEG, "abs": OP_ABS, "relu": OP_RELU,
              "bitwise_not": OP_NOT}[base]
        ops.append(one(op, opnds[0]))
    elif base in _UNARY_FLOAT and len(args) == 1 and is_float:
        ops.append(one(_UNARY_FLOAT[base], opnds[0]))
    elif base in ("clamp", "clamp_min", "clamp_max") and 2 <= len(args) <= 3:
        # clamp(x, lo, hi) as clamp_min(x, lo) then clamp_max(., hi): the
        # same values and the same gradient (x >= lo and x <= hi)
        none = (NONE, None)
        bounds = {"clamp": (opnds[1], opnds[2] if len(args) == 3 else none),
                  "clamp_min": (opnds[1], none),
                  "clamp_max": (none, opnds[1])}[base]
        x = opnds[0]
        for op, bound in zip((OP_MAXC, OP_MINC), bounds):
            if bound[0] == NONE:
                continue
            if bound[0] != C:
                return None
            c = bound[1]
            if dtype in (torch.bfloat16, torch.float16):
                # PyTorch casts a clamp bound to the type
                c = float(torch.tensor(c, dtype=dtype))
            ops.append(one(op, x, (C, c)))
            x = (R, None)
        if not ops:
            return None
    elif base in ("__lshift__", "__rshift__", "bitwise_left_shift",
                  "bitwise_right_shift") and len(args) == 2:
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

def _const_bits(tape: Tape, c) -> int:
    """The bits of constant ``c`` as the kernels hold it: float32's (a
    float of 32 bits or less), float64's, or the integer's two's
    complement, as an unsigned 64-bit number."""
    if c is None:
        return 0
    if tape.dtype in _INTS:
        return int(c) & 0xFFFFFFFFFFFFFFFF
    if tape.dtype == torch.float64:
        return int(np.float64(c).view(np.uint64))
    return int(np.float32(c).view(np.uint32))


def _int32(w: int) -> int:
    return w - (1 << 32) if w >= 1 << 31 else w


def tape_words(tape: Tape) -> list:
    """Two int32 words per op: ``op | a << 8 | b << 10`` (operand kinds)
    and the constant's low 32 bits (float32 bits, float64's low word, or
    the integer's low 32 bits)."""
    out = []
    for op, a, b, c in tape.ops:
        out += [op | a << 8 | b << 10,
                _int32(_const_bits(tape, c) & 0xFFFFFFFF)]
    return out


def tape_high_words(tape: Tape) -> list:
    """The high 32 bits of each op's constant (int32 words) for a 64-bit
    type (int64, uint64, float64), which 32 bits would cut; no words for
    the other types."""
    if tape.dtype not in _WIDE:
        return []
    return [_int32(_const_bits(tape, c) >> 32) for _, _, _, c in tape.ops]


def _pick(kind, r, u, c):
    return r if kind == R else (u if kind == U else c)


_TORCH_UNARY = {
    OP_NEG: torch.neg, OP_ABS: torch.abs, OP_RELU: torch.relu,
    OP_EXP: torch.exp, OP_EXPM1: torch.expm1, OP_LOG: torch.log,
    OP_LOG1P: torch.log1p, OP_SQRT: torch.sqrt, OP_RSQRT: torch.rsqrt,
    OP_TANH: torch.tanh, OP_SIGMOID: torch.sigmoid,
    OP_NOT: torch.bitwise_not, OP_SIN: torch.sin, OP_COS: torch.cos}


def eval_tape(tape: Tape, u: torch.Tensor) -> torch.Tensor:
    """The tape's ops as eager torch ops on ``u``'s device, one by one in
    its dtype (constants as the trace held them): what the kernels
    compute, and equal to ``tape.fn(u)`` on every input."""
    r = u
    for op, a, b, c in tape.ops:
        if u.dtype == torch.bool and c is not None:
            c = bool(c)             # bool's NOT: an XOR with True
        x, y = _pick(a, r, u, c), _pick(b, r, u, c)
        if op in _TORCH_UNARY:
            r = _TORCH_UNARY[op](x)
        elif op == OP_ADD:
            r = torch.add(x, y) if a != C else torch.add(y, x)
        elif op == OP_SUB:
            r = torch.sub(x, y) if a != C else torch.rsub(y, x)
        elif op == OP_MUL:
            r = torch.mul(x, y) if a != C else torch.mul(y, x)
        elif op == OP_DIV:
            r = torch.div(x, y)
        elif op == OP_MAXC:
            r = torch.clamp_min(x, y)
        elif op == OP_MINC:
            r = torch.clamp_max(x, y)
        elif op == OP_AND:
            r = torch.bitwise_and(x, y)
        elif op == OP_OR:
            r = torch.bitwise_or(x, y)
        elif op == OP_XOR:
            r = torch.bitwise_xor(x, y)
        elif op == OP_SHL:
            r = torch.bitwise_left_shift(x, y)
        else:
            r = torch.bitwise_right_shift(x, y)
    return r if tape.ops else u.clone()


def tape_vjp(tape: Tape, u: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """The map's VJP at ``u`` as eager autograd computes it on ``u``'s
    device, and K5 on the card: reverse mode over the tape with
    autograd's derivative formulas, each aten op computed in float32 and
    rounded once to the dtype (float64 in float64), the cotangents of
    ``u`` summed in the order autograd receives them. The fused
    ``tanh_backward`` and ``sigmoid_backward`` round as PyTorch's kernels
    do: float32 tanh's ``1 - y * y`` is one FMA on either device; in
    bfloat16 and float16 the CUDA kernels round after each op, the CPU's
    once; float64 runs the aten ops themselves on ``u``'s device.
    Intermediates come from :func:`eval_tape`."""
    dt = u.dtype
    wide = dt == torch.float64
    per_op = (dt in (torch.bfloat16, torch.float16)
              and u.device.type == "cuda")

    def up(v):
        return v if wide else v.float()

    def rnd(v):
        return v if wide else v.to(dt).float()

    rs = [u]
    for k in range(len(tape.ops)):
        rs.append(eval_tape(Tape(tape.name, tape.fn, dt, tape.ops[:k + 1]),
                            u))
    uf = up(u)
    g = up(ct)
    cu = torch.full_like(uf, -0.0)
    for s in range(len(tape.ops) - 1, -1, -1):
        op, ka, kb, c = tape.ops[s]
        x = _pick(ka, up(rs[s]), uf, c)
        y = _pick(kb, up(rs[s]), uf, c)
        res = up(rs[s + 1])
        ga, gb = _backward(op, ka, kb, g, x, y, res, c, rnd, per_op, wide)
        ng = None
        if ka == R:
            ng = ga
        if kb == R:
            ng = gb if ng is None else rnd(ng + gb)
        if ka == U:
            cu = rnd(cu + ga)
        if kb == U:
            cu = rnd(cu + gb)
        g = ng if ng is not None else g
    if not tape.ops:
        return ct.clone()
    return cu.to(dt)


def _backward(op, ka, kb, g, x, y, res, c, rnd, per_op, wide=False):
    """(cotangent of the first operand, of the second or None) of one op
    with output cotangent ``g`` (float32 tensors, float64 with ``wide``;
    ``rnd`` rounds to the dtype; ``per_op``: tanh's and sigmoid's backward
    round after each op, as PyTorch's CUDA kernels do in bfloat16;
    ``wide``: they are the aten ops themselves)."""
    zero = torch.zeros_like(g)
    if op == OP_ADD:
        return g, g
    if op == OP_SUB:
        return g, -g
    if op == OP_MUL:
        return rnd(g * y), rnd(g * x)
    if op == OP_DIV:
        if kb == C:   # grad / c, as torch divides by a number on g's device
            return rnd(torch.div(g, c)), None
        q = rnd(rnd(x / y) / y)
        return rnd(g / y), rnd(-g * q)
    if op == OP_NEG:
        return -g, None
    if op == OP_ABS:
        return rnd(g * ((x > 0).float() - (x < 0).float())), None
    if op == OP_MAXC:
        return torch.where(x >= y, g, zero), None
    if op == OP_MINC:
        return torch.where(x <= y, g, zero), None
    if op == OP_RELU:
        return torch.where(res <= 0, zero, g), None
    if op == OP_EXP:
        return rnd(g * res), None
    if op == OP_EXPM1:
        return rnd(g * rnd(res + 1)), None
    if op == OP_LOG:
        return rnd(g / x), None
    if op == OP_LOG1P:
        return rnd(g / rnd(x + 1)), None
    if op == OP_SQRT:
        return rnd(g / rnd(2 * res)), None
    if op == OP_RSQRT:
        # result.pow(3) as PyTorch's pow takes a cube: (y * y) * y in T
        return rnd(rnd(-0.5 * g) * rnd(rnd(res * res) * res)), None
    if op == OP_TANH and wide:
        return torch.ops.aten.tanh_backward(g, res), None
    if op == OP_SIGMOID and wide:
        return torch.ops.aten.sigmoid_backward(g, res), None
    if op == OP_TANH:   # float32: 1 - y * y contracted into an FMA
        if not per_op:
            return rnd(g * (1 - res.double() ** 2).float()), None
        return rnd(g * rnd(1 - rnd(res * res))), None
    if op == OP_SIGMOID:
        if not per_op:
            return rnd(g * (1 - res) * res), None
        return rnd(rnd(g * rnd(1 - res)) * res), None
    if op == OP_SIN:    # autograd: grad * x.cos(), two aten ops
        return rnd(g * rnd(torch.cos(x))), None
    if op == OP_COS:    # grad * -x.sin()
        return rnd(g * -rnd(torch.sin(x))), None
    raise ValueError(f"op {op} has no gradient (integers)")
