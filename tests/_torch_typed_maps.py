"""The maps of the typed-tape slice, shared by the CPU tests
(``test_torch_map_typed.py``) and the card tests (``test_torch_cuda.py``):
casts inside a map, tests of a value and signs, ops between two values of
the tape, PyTorch's activations, and the remaining transcendentals. Each
case keeps its arguments in the op's domain on inputs in [-4, 4) (the
CPU tests' and the card tests' inputs), so no case needs a NaN in its
input; NaNs and infinities it tests it makes itself (``log`` of a
negative number, ``exp`` past the type's range).

No JAX here: the card tests import it.
"""
import torch
import torch.nn.functional as F

F32, BF, F16, F64 = torch.float32, torch.bfloat16, torch.float16, torch.float64
FLOATS = (F32, BF, F16, F64)
I32, I8, I16, U8, I64 = (torch.int32, torch.int8, torch.int16, torch.uint8,
                         torch.int64)

# name, function, the dtypes it lowers for and is held on (item of the
# slice: 1 casts, 2 tests and signs, 3 two values, 4 activations, 5
# transcendentals)
CASTS = [
    ("cast_tanh", lambda v: torch.tanh(v.float()).to(v.dtype), FLOATS),
    ("cast_affine", lambda v: (v.float() * 3 + 1).to(v.dtype), FLOATS),
    ("cast_mask", lambda v: (v > 0).to(v.dtype) * v,
     FLOATS + (I32, I8, I64)),
    ("cast_double", lambda v: (v.double() * 0.1).to(v.dtype), FLOATS),
    ("cast_half", lambda v: (v.half() * 3 - v.bfloat16()).to(v.dtype),
     FLOATS),
    ("cast_int_floor", lambda v: (v.int() * 3).to(v.dtype) + v, FLOATS),
    ("cast_int_half", lambda v: (v.float() * 0.5).to(v.dtype),
     (I32, I8, I16, U8, I64)),
    ("cast_long", lambda v: (v.long() * 3).to(v.dtype), (I32, I8, I64)),
    ("cast_bool", lambda v: v.bool().to(v.dtype) + v,
     FLOATS + (I32, I8, I64)),
    ("cast_u8", lambda v: v.to(torch.uint8).to(v.dtype) * 0.5 + v, FLOATS),
    ("cast_i64_f32", lambda v: (v.to(torch.int64) + 7).float().to(v.dtype)
     + v, FLOATS),
    ("cast_u64", lambda v: v.to(torch.uint64).to(v.dtype) + 1, (I64, I32)),
    ("cast_f64_i32", lambda v: (v.double() * 0.75).to(torch.int32).to(
        v.dtype), (I64, I32)),
]
TESTS = [
    ("isnan", lambda v: torch.where(torch.isnan(torch.log(v)), 0.0, v),
     FLOATS),
    ("isinf", lambda v: torch.where(torch.isinf(torch.exp(v * 30)), -v, v),
     FLOATS),
    ("isfinite", lambda v: torch.where(torch.isfinite(torch.log(v)), v, 1.0),
     FLOATS),
    ("nan_to_num", lambda v: torch.nan_to_num(torch.log(v)), FLOATS),
    ("nan_to_num_numbers", lambda v: torch.nan_to_num(torch.log(v), 1.0,
                                                      2.0, -3.0), FLOATS),
    ("copysign", lambda v: torch.copysign(v, -1.0), FLOATS),
    ("copysign_value", lambda v: torch.copysign(v, v - 1), FLOATS),
    ("signbit", lambda v: torch.where(torch.signbit(v), v, -v * 2), FLOATS),
]
BINARY = [
    ("pow_values", lambda v: torch.pow(v.abs() + 1, v * 0.5), FLOATS),
    ("remainder_values", lambda v: torch.remainder(v, v.abs() + 1), FLOATS),
    ("fmod_values", lambda v: torch.fmod(v, v.abs() + 0.5), FLOATS),
    ("int_remainder_values", lambda v: torch.remainder(v, v.abs() + 1)
     + torch.fmod(v, v.abs() + 3), (I32, I8, I64)),
    ("atan2", lambda v: torch.atan2(v, v + 1), FLOATS),
    ("hypot", lambda v: torch.hypot(v, v + 1), FLOATS),
    ("lerp", lambda v: torch.lerp(v, v * 2 + 1, 0.3), FLOATS),
    ("lerp_far", lambda v: torch.lerp(v, v * 2 + 1, 0.7), FLOATS),
    ("addcmul", lambda v: torch.addcmul(v, v, v + 1, value=0.5), FLOATS),
    ("addcmul_one", lambda v: torch.addcmul(v, v, v + 1), FLOATS),
    ("addcdiv", lambda v: torch.addcdiv(v, v, v.abs() + 1, value=0.3),
     FLOATS),
]
ACTIVATIONS = [
    ("elu", F.elu, FLOATS),
    ("elu_alpha", lambda v: F.elu(v, 0.3), FLOATS),
    ("selu", F.selu, FLOATS),
    ("celu", lambda v: F.celu(v, 0.5), FLOATS),
    ("hardsigmoid", F.hardsigmoid, FLOATS),
    ("hardswish", F.hardswish, FLOATS),
    ("mish", F.mish, FLOATS),
    ("logsigmoid", F.logsigmoid, FLOATS),
    ("hardshrink", lambda v: F.hardshrink(v, 1.0), FLOATS),
    ("softshrink", lambda v: F.softshrink(v, 0.75), FLOATS),
    ("threshold", lambda v: F.threshold(v, 0.5, 2.0), FLOATS),
    ("threshold_int", lambda v: F.threshold(v, 3, -7), (I32, I8, I64)),
    ("logit", lambda v: torch.logit(torch.sigmoid(v)), FLOATS),
    ("logit_eps", lambda v: torch.logit(v * 0.2 + 0.5, 0.05), FLOATS),
]
TRANSCENDENTALS = [
    ("tan", lambda v: torch.tan(v * 0.3), FLOATS),
    ("atan", torch.atan, FLOATS),
    ("asin", lambda v: torch.asin(v * 0.2), FLOATS),
    ("acos", lambda v: torch.acos(v * 0.2), FLOATS),
    ("sinh", torch.sinh, FLOATS),
    ("cosh", torch.cosh, FLOATS),
    ("asinh", torch.asinh, FLOATS),
    ("acosh", lambda v: torch.acosh(v.abs() + 1), FLOATS),
    ("atanh", lambda v: torch.atanh(v * 0.2), FLOATS),
    ("erfc", torch.erfc, FLOATS),
    ("erfinv", lambda v: torch.erfinv(v * 0.2), FLOATS),
    ("log10", lambda v: torch.log10(v.abs() + 0.5), FLOATS),
    ("xlogy", lambda v: torch.xlogy(v, v.abs() + 1), FLOATS),
    ("sinc", torch.sinc, FLOATS),
    ("round_decimals", lambda v: torch.round(v * 3, decimals=1) + v, FLOATS),
]
ALL = CASTS + TESTS + BINARY + ACTIVATIONS + TRANSCENDENTALS


def cases(dtypes=None):
    """(dtype, name, function) of every case, each of its dtypes (those
    in ``dtypes`` only, when given)."""
    return [(d, name, fn) for name, fn, ds in ALL for d in ds
            if dtypes is None or d in dtypes]


def case_id(case) -> str:
    return f"{str(case[0])[6:]}-{case[1]}"
