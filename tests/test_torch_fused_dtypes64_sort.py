"""``sort`` of 2^8 and 2^10 keys of each 64-bit type (int64, uint64,
float64) on the CPU, bit-equal to the reference's ``compiled_sort(n,
engine="pallas")`` under ``jax.enable_x64(True)``, with no fused fallback
and the reference's kernel histogram (each compute cluster one K4b pass,
its plain version here): integers over their whole range, past 2^32;
float64 with ties, NaNs, signed zeros and doubles float32 cannot hold.

Inputs are made with numpy from a seed and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import obs as robs
from repro.combinators.sort import compiled_sort as r_compiled_sort
from repro_torch import obs as pobs
from repro_torch.combinators.sort import compiled_sort as p_compiled_sort
from _torch_dtypes import (WIDE_TYPES, _keys, _observed, _same_bits,
                           _to_numpy, _to_torch)


@pytest.mark.parametrize("n", [8, 10])
@pytest.mark.parametrize("dtype", WIDE_TYPES)
def test_wide_sort_fuses_and_equals_reference(dtype, n):
    x = _keys(dtype, (1 << n,), seed=n)
    with jax.enable_x64(True):
        want, rhist, rfall = _observed(robs, lambda: np.asarray(
            r_compiled_sort(n, engine="pallas")(jnp.asarray(x))))
    assert want.dtype == x.dtype
    got, phist, pfall = _observed(pobs, lambda: p_compiled_sort(n)(
        _to_torch(x)))
    assert rfall == pfall == 0
    assert phist == rhist and phist.get("fused", 0) > 0, (phist, rhist)
    if n == 8:
        assert sum(phist.values()) == 13 and phist["fused"] == 8
    _same_bits(_to_numpy(got), want, (dtype, n))
