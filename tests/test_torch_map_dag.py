"""Map lowering past the chain: DAG tapes of up to 32 ops, comparisons,
``where``, PyTorch's one-op activations, rounding, powers and divisions by
a number (``kernels/map_lower.py``), and their plain tapes.

* Each new op and each DAG shape lowers for exactly the types torch
  defines it for, and not past ``TAPE_MAX`` ops, through a complex cast
  or a tensor constant.
* Forward: ``eval_tape`` equals the function bit for bit for each type.
* Backward: ``tape_vjp`` equals ``torch.autograd.grad`` bit for bit in
  float32 and float64 (which pins the order in which a value's cotangents
  are summed) and within this file's tolerance in bfloat16 and float16.
* The tape words: gradient mask, operand bytes, constants as torch holds
  them (a comparison's number cast to the dtype, ``pow``'s exponent whole).

CPU only; the kernels run these tapes on the card (``chip_smoke.py`` phase
22, ``tests/test_torch_cuda.py``). Inputs are made with numpy from a seed.
"""
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import map_lower as ML

F32, BF, F16, F64 = torch.float32, torch.bfloat16, torch.float16, torch.float64
I32, I8 = torch.int32, torch.int8
FLOATS = (F32, BF, F16, F64)
ALL = FLOATS + (I32, I8)
HALF_TOL = 2 ** -7        # bfloat16 and float16 cotangents, relative

# name, function, the dtypes it lowers for (of ALL), its tape length
CASES = [
    ("eq", lambda v: torch.where(v == 1, v, -v), ALL, 3),
    ("ne", lambda v: torch.where(v != 1, v, -v), ALL, 3),
    ("lt", lambda v: torch.where(v < 1, v, 2 * v), ALL, 3),
    ("le", lambda v: torch.where(v <= 1, v, 2 * v), ALL, 3),
    ("gt_tensor", lambda v: torch.where(v > v * 2, v, -v), ALL, 4),
    ("ge", lambda v: torch.where(v >= -1, v * v, v), ALL, 3),
    ("logical_not", lambda v: torch.where(torch.logical_not(v > 0), v,
                                          2 * v), ALL, 4),
    ("logical_and", lambda v: torch.where(
        torch.logical_and(v > -2, v < 2), v * v, v), ALL, 5),
    ("logical_or", lambda v: torch.where(
        torch.logical_or(v < -2, v > 2), -v, v), ALL, 5),
    ("where_number", lambda v: torch.where(v > 0.5, v, 0.0), FLOATS, 2),
    ("leaky_by_where", lambda v: torch.where(v > 0, v, 0.01 * v), FLOATS, 3),
    ("mask_product", lambda v: v * (v > 0), ALL, 2),
    ("maximum", lambda v: torch.maximum(v, -v), ALL, 2),
    ("minimum", lambda v: torch.minimum(v, torch.floor(v)), ALL, 2),
    ("pow2", lambda v: v ** 2, ALL, 1),
    ("pow3", lambda v: v ** 3, ALL, 1),
    ("pow_half", lambda v: torch.abs(v) ** 0.5, FLOATS, 2),
    ("pow_rsqrt", lambda v: (torch.abs(v) + 1) ** -0.5, FLOATS, 3),
    ("pow_m1", lambda v: v ** -1, FLOATS, 1),
    ("pow_m2", lambda v: v ** -2, FLOATS, 1),
    ("pow_general", lambda v: torch.abs(v) ** 1.7, FLOATS, 2),
    ("reciprocal", torch.reciprocal, FLOATS, 1),
    ("floor", lambda v: torch.floor(v * 3), ALL, 2),
    ("ceil", lambda v: torch.ceil(v * 3), ALL, 2),
    ("trunc", lambda v: torch.trunc(v * 3), ALL, 2),
    ("round", lambda v: torch.round(v * 2), ALL, 2),
    ("sign", torch.sign, ALL, 1),
    ("erf", torch.erf, FLOATS, 1),
    ("log2", lambda v: torch.log2(torch.abs(v) + 0.25), FLOATS, 3),
    ("exp2", torch.exp2, FLOATS, 1),
    ("gelu", F.gelu, FLOATS, 1),
    ("gelu_tanh", lambda v: F.gelu(v, approximate="tanh"), FLOATS, 1),
    ("silu", F.silu, FLOATS, 1),
    ("softplus", lambda v: F.softplus(v, beta=2.0, threshold=4.0), FLOATS,
     1),
    ("leaky_relu", lambda v: F.leaky_relu(v, 0.1), FLOATS, 1),
    ("hardtanh", lambda v: F.hardtanh(v, -0.5, 0.5), FLOATS, 1),
    ("relu6", F.relu6, ALL, 1),
    ("floor_divide", lambda v: v // 3, ALL, 1),
    ("div_floor", lambda v: torch.div(v, -3, rounding_mode="floor"), ALL, 1),
    ("div_trunc", lambda v: torch.div(v, -3, rounding_mode="trunc"), ALL, 1),
    ("remainder", lambda v: v % -3, ALL, 1),
    ("fmod", lambda v: torch.fmod(v, 3), ALL, 1),
    ("remainder_float", lambda v: v % 0.75, FLOATS, 1),
    # DAG shapes: a value read by several ops, a chain past 8 ops, 32 ops
    ("gelu_tanh_dag", lambda v: 0.5 * v * (1 + torch.tanh(
        0.7978845608028654 * (v + 0.044715 * v * v * v))), FLOATS, 9),
    ("fan_out", lambda v: v * v + torch.exp(v) * v - torch.sin(v), FLOATS,
     6),
    ("two_outputs_one_kept", lambda v: (v + 1, v * 2)[1], ALL, 1),
    ("ops_32", lambda v: functools.reduce(lambda a, k: a * 0.5 + k % 3,
                                          range(16), v), FLOATS, 32),
    ("ops_32_int", lambda v: functools.reduce(lambda a, k: a * 3 + k,
                                              range(16), v), ALL, 32),
]


def _inputs(dtype, seed, size=4096):
    """Half uniform in [-4, 4), half multiples of 1/4 there (ties, round's
    halves, floor's integers), zeros of both signs; integers in [-100,
    100]."""
    rng = np.random.default_rng(seed)
    if dtype in (I32, I8):
        return torch.from_numpy(rng.integers(-100, 101, size)).to(dtype)
    cont = (rng.random(size) - 0.5) * 8
    grid = rng.integers(-16, 17, size) / 4
    v = np.where(rng.random(size) < 0.5, cont, grid).astype(np.float32)
    v[:4] = [0.0, -0.0, 1.0, -1.0]
    return torch.from_numpy(v).to(dtype)


def _bits(t):
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _grad(fn, u, ct):
    uu = u.clone().requires_grad_(True)
    return torch.autograd.grad(fn(uu), uu, ct)[0]


@pytest.mark.parametrize("name,fn,dtypes,length", CASES,
                         ids=[c[0] for c in CASES])
def test_each_op_and_dag_lowers_and_its_tape_equals_torch(name, fn, dtypes,
                                                          length):
    for dtype in ALL:
        tape = ML.lower_map("dag_" + name, fn, dtype)
        assert tape.lowered == (dtype in dtypes), (name, dtype)
        if not tape.lowered:
            continue
        assert len(tape.ops) == length, (name, dtype, tape.ops)
        u = _inputs(dtype, seed=len(name))
        assert torch.equal(_bits(ML.eval_tape(tape, u)), _bits(fn(u))), (
            name, dtype)
        if dtype not in FLOATS:
            continue
        ct = _inputs(dtype, seed=7).flip(0)
        if name == "floor_divide":    # autograd has no derivative for it
            assert tape.nodiff
            with pytest.raises(RuntimeError):
                ML.tape_vjp(tape, u, ct)
            continue
        want = _grad(fn, u, ct)
        got = ML.tape_vjp(tape, u, ct)
        if dtype in (F32, F64):
            assert torch.equal(_bits(got), _bits(want)), (name, dtype)
        else:
            fin = torch.isfinite(want)
            assert torch.equal(fin, torch.isfinite(got)), name
            assert torch.allclose(got[fin].float(), want[fin].float(),
                                  rtol=HALF_TOL, atol=1e-6), (name, dtype)


# Casts, rounding to decimals, erfinv, pow and remainder by a value lower
# since typed tapes (tests/test_torch_map_typed.py); their cases here hold
# what still does not, under the cases' old ids.
@pytest.mark.parametrize("name,fn", [
    ("ops_33", lambda v: functools.reduce(lambda a, k: a * 1.5 + k,
                                          range(16), v) + 1),
    ("cast", lambda v: v.to(torch.complex64).real.to(v.dtype)),
    ("cast_of_a_comparison", lambda v: (v > 0).to(torch.complex64).real.to(
        v.dtype)),
    ("tensor_constant", lambda v: torch.maximum(v, torch.tensor(0.0))),
    ("where_of_two_float_numbers", lambda v: torch.where(v > 0, 1.0, -1.0)),
    ("round_decimals", lambda v: torch.frac(v * 10)),
    pytest.param("lgamma", torch.lgamma, id="erfinv-erfinv"),
    ("bool_output", lambda v: v > 0),
    ("pow_by_a_tensor", lambda v: 2.0 ** v),
    ("remainder_by_a_tensor", lambda v: torch.div(v, v + 5,
                                                  rounding_mode="floor")),
])
def test_what_still_does_not_lower(name, fn):
    for dtype in (F32, BF, I32):
        assert not ML.lower_map("not_" + name, fn, dtype).lowered, (name,
                                                                    dtype)


def test_thirty_two_ops_lower_and_thirty_three_do_not():
    def chain(k):
        return lambda v: functools.reduce(lambda a, _: a * 0.5 + 1,
                                          range(k // 2), v)
    assert len(ML.lower_map("c32", chain(32), F32).ops) == ML.TAPE_MAX == 32
    assert not ML.lower_map("c34", chain(34), F32).lowered


def test_cotangents_sum_in_the_order_autograd_receives_them():
    """A value read by three ops whose cotangents are 3, 1e8 and -1e8 in
    float32: autograd's engine runs the ops' backward last op first, so
    it sums 3 + 1e8 (rounded to 1e8), then -1e8: 0. Summed in the forward
    order the same cotangents give 3; the tape gives autograd's 0."""
    def fn(v):
        return (v * -1e8 + v * 1e8) + v * 3
    tape = ML.lower_map("order", fn, F32)
    assert tape.lowered and len(tape.ops) == 5
    u = torch.ones(4)
    ct = torch.ones(4)
    want = _grad(fn, u, ct)
    assert torch.equal(want, torch.zeros(4))
    assert torch.equal(_bits(ML.tape_vjp(tape, u, ct)), _bits(want))
    forward_order = (torch.tensor(-1e8) + torch.tensor(1e8)) + 3
    assert float(forward_order) == 3.0


def test_dead_ops_are_dropped_and_their_backward_never_runs():
    """An op whose result does not reach the output is dropped, and a
    value that feeds the output only through a comparison has no
    cotangent (its op's backward does not run, as in autograd)."""
    def fn(v):
        s = torch.sin(v)                 # feeds only a comparison
        return torch.where(s > 0, v * 2, v)
    tape = ML.lower_map("dead", fn, F32)
    assert [op for op, _ in tape.ops] == [ML.OP_SIN, ML.OP_GT, ML.OP_MUL,
                                          ML.OP_WHERE]
    assert tape.grads == (False, False, True, True)
    u, ct = _inputs(F32, 3), _inputs(F32, 4)
    assert torch.equal(_bits(ML.tape_vjp(tape, u, ct)),
                       _bits(_grad(fn, u, ct)))
    words = ML.tape_words(tape)
    assert words[0] == 0b1100           # the gradient mask


def test_tape_words_encode_slots_constants_and_reuse():
    """Operand bytes: a slot, ``0x40 | k`` constant ``k`` or ``0xC0`` none;
    the keep bit where a later op other than the next reads the result;
    constants deduplicated, each two words (low, high)."""
    def fn(v):
        a = v * 0.5                     # op 0: read again by op 2
        b = a + 0.5                     # op 1
        return torch.where(b > 0.5, a, b)   # ops 2 (gt), 3 (where)
    tape = ML.lower_map("words", fn, F32)
    w = ML.tape_words(tape)
    n = len(tape.ops)
    assert n == 4 and ML.tape_constants(tape) == [
        int(np.float32(0.5).view(np.uint32))]
    ops = [x & 0xFFFFFFFF for x in w[1:1 + n]]
    assert [x & 0x7F for x in ops] == [ML.OP_MUL, ML.OP_ADD, ML.OP_GT,
                                       ML.OP_WHERE]
    assert [(x >> 7) & 1 for x in ops] == [1, 1, 0, 0]
    assert [(x >> 8) & 0xFF for x in ops] == [0, 1, 2, 3]
    assert [(x >> 16) & 0xFF for x in ops] == [0x40, 0x40, 0x40, 1]
    assert [(x >> 24) & 0xFF for x in ops] == [0xC0, 0xC0, 0xC0, 2]
    assert w[1 + n:] == [int(np.float32(0.5).view(np.int32)), 0]


def test_numbers_are_held_as_torch_casts_them():
    """bfloat16: a comparison's and a remainder's number cast to bfloat16,
    a product's kept in float32 (PyTorch's CUDA kernels compute in
    float), a ``pow`` exponent whole (its kernel is picked by the
    exponent's value)."""
    def consts(fn):
        tape = ML.lower_map("c_" + str(id(fn)), fn, BF)
        return [x for _, opnds in tape.ops for k, x in opnds if k == ML.C]
    bf = float(torch.tensor(0.1, dtype=BF))
    assert consts(lambda v: torch.where(v > 0.1, v, -v)) == [bf]
    assert consts(lambda v: v % 0.1) == [bf]
    assert consts(lambda v: v * 0.1) == [0.1]
    assert consts(lambda v: v ** 2.001) == [2.001]
    tape = ML.lower_map("pow2001", lambda v: v ** 2.001, BF)
    pool = ML.tape_words(tape)[2:]
    assert ((pool[1] & 0xFFFFFFFF) << 32 | (pool[0] & 0xFFFFFFFF)) == int(
        np.float64(2.001).view(np.uint64))
    u = torch.tensor([0.0996, 0.1, 0.10009765625, 0.1006], dtype=BF)
    t = ML.lower_map("cmp_bf", lambda v: torch.where(v > 0.1, v, -v), BF)
    assert torch.equal(_bits(ML.eval_tape(t, u)),
                       _bits(torch.where(u > 0.1, u, -u)))


def test_a_dag_lowers_for_every_float_type_or_none():
    def by_dtype(v):
        return torch.where(v > 0, v, v * 2) if v.dtype == F32 else \
            torch.maximum(v, v * 2)
    for dtype in FLOATS:
        assert not ML.lower_map("dag_by_dtype", by_dtype, dtype).lowered
