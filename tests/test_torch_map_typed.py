"""Typed tapes: casts inside a map, and the element-wise ops past the DAG
tapes' list (``kernels/map_lower.py``), lowered and run by their plain
tapes on the CPU.

* Each map of the slice (``_torch_typed_maps.py``: casts, tests of a
  value and signs, ops between two values, PyTorch's activations, the
  remaining transcendentals) lowers for each dtype it names.
* ``eval_tape`` equals the function and ``tape_vjp`` equals
  ``torch.autograd.grad``, bit for bit, for each case and dtype.
* The four float types' traces are compared with their casts left out,
  so a cast map lowers for all four or none; float64's ``.float()`` is a
  real rounding; a map whose output changes dtype is still refused.
* The tape words of a typed tape (its type words) and of an untyped one
  (as before: no type words).

Inputs are made with numpy from a seed. CPU only; the kernels run these
tapes on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase
22).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import map_lower as ML

import _torch_typed_maps as TM

F32, BF, F16, F64 = TM.F32, TM.BF, TM.F16, TM.F64
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _bits(t):
    return t.view(_BITS[t.element_size()])


def _input(dtype, seed=30, n=1024):
    """Half continuous in [-4, 4), half multiples of 1/4 (integers: in
    [-100, 100))."""
    rng = np.random.default_rng(seed)
    if not dtype.is_floating_point:
        return torch.from_numpy(rng.integers(-100, 100, n)).to(dtype)
    x = rng.uniform(-4, 4, n)
    x[::2] = rng.integers(-16, 16, n // 2) / 4
    return torch.from_numpy(x).to(dtype)


def _same(got, want):
    """Bit for bit; NaNs where the other has them (a NaN's payload is the
    op's own either way: both sides run the same aten op)."""
    assert got.dtype == want.dtype
    if got.dtype.is_floating_point:
        nan = torch.isnan(want)
        assert torch.equal(nan, torch.isnan(got))
        assert torch.equal(_bits(got)[~nan], _bits(want)[~nan])
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("name,fn,dtypes", TM.ALL,
                         ids=[c[0] for c in TM.ALL])
def test_each_map_lowers_for_the_types_it_names(name, fn, dtypes):
    for dtype in dtypes:
        tape = ML.lower_map("typed_" + name, fn, dtype)
        assert tape.lowered, (name, dtype)
        assert len(tape.ops) <= ML.TAPE_MAX


_CASES = TM.cases()


@pytest.mark.parametrize("dtype,name,fn", _CASES,
                         ids=[TM.case_id(c) for c in _CASES])
def test_plain_tapes_equal_eager_and_autograd(dtype, name, fn):
    tape = ML.lower_map("typed_" + name, fn, dtype)
    u = _input(dtype)
    _same(ML.eval_tape(tape, u), fn(u))
    if not dtype.is_floating_point:
        return
    ct = _input(dtype, seed=31)
    uu = u.clone().requires_grad_(True)
    out = fn(uu)
    if out.requires_grad:
        want = torch.autograd.grad(out, uu, ct)[0]
    else:   # every path crosses an integer or bool cast: no gradient
        assert not any(tape.grads[:-1]) or not any(
            t.is_floating_point for t in tape.types[1:-1])
        want = torch.zeros_like(u)
    _same(ML.tape_vjp(tape, u, ct), want)


def test_casts_are_ops_and_promotions_are_written_out():
    """``tanh(v.float()).to(v.dtype)``: on float32 one op (the casts are no
    ops), on bfloat16 three, typed, each value its dtype; ``v *
    v.float()`` on bfloat16 casts the operand it promotes, one cast a
    use."""
    t32 = ML.lower_map("ct", lambda v: torch.tanh(v.float()).to(v.dtype), F32)
    tbf = ML.lower_map("ct", lambda v: torch.tanh(v.float()).to(v.dtype), BF)
    assert [op for op, _ in t32.ops] == [ML.OP_TANH] and not t32.typed
    assert [op for op, _ in tbf.ops] == [ML.OP_CAST, ML.OP_TANH, ML.OP_CAST]
    assert tbf.typed and tbf.types == (BF, F32, F32, BF)
    assert tbf.ctypes == (BF, F32, F32)
    assert tbf.mixed   # the float family: float registers in the kernels
    assert not ML.lower_map("ct_int", lambda v: (v.int() * 3).to(v.dtype),
                            BF).mixed
    tp = ML.lower_map("promote", lambda v: (v * v.float()).to(v.dtype), BF)
    assert [op for op, _ in tp.ops] == [ML.OP_CAST, ML.OP_CAST, ML.OP_MUL,
                                        ML.OP_CAST]
    assert ML._shape(tp.ops) == ML._shape(
        ML.lower_map("promote", lambda v: (v * v.float()).to(v.dtype),
                     F32).ops)


def test_a_cast_map_lowers_for_every_float_type_or_none():
    """The traces are compared with their casts left out: a cast to the
    map's own dtype is no op of its trace. A function whose ops differ by
    dtype is still refused for all four."""
    for name, fn, _ in TM.CASTS[:6]:
        got = [ML.lower_map("rule_" + name, fn, d).lowered for d in TM.FLOATS]
        assert got == [True] * 4, name

    def by_dtype(v):
        f = v.float()
        return (torch.tanh(f) if v.dtype == BF else torch.exp(f)).to(v.dtype)
    for dtype in TM.FLOATS:
        assert not ML.lower_map("rule_by_dtype", by_dtype, dtype).lowered


def test_float64_rounds_through_a_float32_cast():
    """On float64 ``.float()`` is a real rounding: the tape holds the cast
    and computes tanh in float32, as eager torch does."""
    fn = lambda v: torch.tanh(v.float()).to(v.dtype)   # noqa: E731
    tape = ML.lower_map("f64_cast", fn, F64)
    assert tape.typed and tape.types == (F64, F32, F32, F64)
    u = _input(F64)
    got = ML.eval_tape(tape, u)
    _same(got, fn(u))
    assert not torch.equal(got, torch.tanh(u))   # not the float64 tanh


@pytest.mark.parametrize("dtype", [F32, BF, TM.I32])
def test_a_map_whose_output_changes_dtype_is_refused(dtype):
    for name, fn in [("float", lambda v: v.float() * 2),
                     ("double", lambda v: v.double()),
                     ("compare", lambda v: v > 0),
                     ("int", lambda v: v.to(torch.int16) + 1)]:
        if fn(torch.ones(1, dtype=dtype)).dtype == dtype:
            continue
        assert not ML.lower_map("out_" + name, fn, dtype).lowered, name


def test_integer_casts_stop_the_gradient():
    """``(v.int() * 3).to(v.dtype) + v``: only ``+ v`` carries a gradient;
    the cast to int32 and its product run no backward."""
    fn = lambda v: (v.int() * 3).to(v.dtype) + v   # noqa: E731
    tape = ML.lower_map("int_stop", fn, F32)
    ops = [op for op, _ in tape.ops]
    assert ops == [ML.OP_CAST, ML.OP_MUL, ML.OP_CAST, ML.OP_ADD]
    assert tape.grads == (False, False, True, True)
    u, ct = _input(F32), _input(F32, seed=3)
    _same(ML.tape_vjp(tape, u, ct), ct)


def test_type_words_and_untyped_words():
    """A typed tape's words: the mask, an op word an op, a type word an op
    (result and compute codes, bool operands, a fourth operand's byte),
    then the constants; an untyped tape has no type words (``(v > 0)
    .to(v.dtype) * v``: the bool cast runs on the register path)."""
    tape = ML.lower_map("tw", lambda v: torch.addcmul(
        v, v > 0, v.float().to(v.dtype), value=0.5), BF)
    n = len(tape.ops)
    words = ML.tape_words(tape)
    pool = ML.tape_constants(tape)
    assert tape.typed and len(words) == 1 + 2 * n + 2 * len(pool)
    tys = words[1 + n:1 + 2 * n]
    assert [w & 0xF for w in tys] == [ML.TYPE_CODE[t] for t in tape.types[1:]]
    assert [(w >> 4) & 0xF for w in tys] == [ML.TYPE_CODE[t]
                                             for t in tape.ctypes]
    s = [op for op, _ in tape.ops].index(ML.OP_ADDCMUL)
    k = pool.index(ML._const_bits(BF, ML.OP_ADDCMUL, 0.5))
    assert (tys[s] >> 16) & 0xFF == 0x40 | k
    mask = ML.lower_map("um", lambda v: (v > 0).to(v.dtype) * v, BF)
    assert not mask.typed
    assert [op for op, _ in mask.ops] == [ML.OP_GT, ML.OP_CAST, ML.OP_MUL]
    assert len(ML.tape_words(mask)) == 1 + 3 + 2 * len(
        ML.tape_constants(mask))


def test_lerp_weight_keeps_one_minus_weight_beside_it():
    """A float32 lerp weight holds float32's ``1 - w`` of the double in its
    constant's high word: autograd's ``grad * (1 - w)`` takes it from the
    double, not from the rounded weight."""
    tape = ML.lower_map("lerp_w", lambda v: torch.lerp(v, v * 2, 0.3), F32)
    bits = ML._const_bits(F32, ML.OP_LERP, 0.3)
    assert bits & 0xFFFFFFFF == int(np.float32(0.3).view(np.uint32))
    assert bits >> 32 == int(np.float32(1 - 0.3).view(np.uint32))
    assert bits in ML.tape_constants(tape)
