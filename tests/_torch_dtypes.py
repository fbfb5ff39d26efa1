"""Helpers of the element-type tests (``test_torch_fused_dtypes*.py``):
the types, numpy and torch views of them, keys made from a seed, and the
kernel histogram and fused fallbacks of a call."""
import ml_dtypes
import numpy as np
import torch

from repro_torch.kernels import bmmc_permute as pk

BF16 = np.dtype(ml_dtypes.bfloat16)
NEW_TYPES = ("float16", "int8", "uint8", "int16", "uint16", "uint32", "bool")
WIDE_TYPES = ("int64", "uint64", "float64")
_TORCH = {"float16": torch.float16, "int8": torch.int8,
          "uint8": torch.uint8, "int16": torch.int16,
          "uint16": torch.uint16, "uint32": torch.uint32,
          "bool": torch.bool, "float32": torch.float32,
          "bfloat16": torch.bfloat16, "int64": torch.int64,
          "uint64": torch.uint64, "float64": torch.float64,
          "int32": torch.int32}
_UNSIGNED = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32,
             np.dtype(np.uint64): np.int64}


def _to_torch(a):
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype in _UNSIGNED:   # through a signed view
        return torch.from_numpy(a.view(_UNSIGNED[a.dtype])).view(
            _TORCH[a.dtype.name])
    return torch.from_numpy(a)


def _to_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16)
    if t.dtype in (torch.uint16, torch.uint32, torch.uint64):
        return pk._int_view(t).numpy().view(
            {torch.uint16: np.uint16, torch.uint32: np.uint32,
             torch.uint64: np.uint64}[t.dtype])
    return t.numpy()


def _same_bits(got, want, ctx=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, ctx
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), ctx


def _keys(dtype: str, shape, seed: int):
    """Keys of ``dtype`` over its whole range (float16: normal values with
    ties, canonical NaNs and signed zeros; float64 besides those values
    doubles float32 cannot hold, and the 64-bit integers their whole
    range, past 2^32)."""
    rng = np.random.default_rng(seed)
    if dtype in ("int64", "uint64"):
        return rng.integers(0, 1 << 64, size=shape, dtype=np.uint64).view(
            dtype)
    if dtype == "float64":
        f = rng.integers(-6, 7, size=shape).astype(np.float64) / 4
        u = rng.random(shape)
        f[u < 0.05] = np.nan
        f[(u > 0.5) & (f == 0)] = -0.0
        wide = (u > 0.05) & (u < 0.3)
        f[wide] = rng.normal(size=int(wide.sum())) * 1e10
        return f
    if dtype == "bool":
        return rng.integers(0, 2, size=shape).astype(bool)
    if dtype in ("float16", "float32", "bfloat16"):
        f = rng.integers(-6, 7, size=shape).astype(np.float32) / 4
        u = rng.random(shape)
        f[u < 0.05] = np.nan
        f[(u > 0.5) & (f == 0)] = -0.0
        return f.astype(BF16 if dtype == "bfloat16" else dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, int(info.max) + 1, size=shape,
                        dtype=np.int64).astype(dtype)


def _kernels(obs):
    return {dict(lab)["kernel"]: v for (nm, lab), v in obs.counters().items()
            if nm == "dispatch.kernel"}


def _observed(obs, fn):
    """fn() with ``obs`` counting: (result, kernel histogram, fused
    fallbacks)."""
    obs.reset()
    obs.enable()
    try:
        out = fn()
        return (out, _kernels(obs),
                obs.counter_total("dispatch.fused_fallback"))
    finally:
        obs.disable()
        obs.reset()
