"""The workloads of the PyTorch port's combinator path held against the JAX
reference on the CPU: the balanced-periodic sort (bit for bit against
``compiled_sort(n, engine="pallas")`` in interpret mode and ``np.sort``),
the radix-2 FFT (against the reference's Pallas FFT and ``np.fft.fft``),
``parm`` and ``core/sort``, and a fuzz of random perm / compare / map
programs mirroring ``tests/test_fused.py::test_fused_mixed_program_fuzz``.

On the CPU the port's ``"cuda"`` engine runs each kernel's plain PyTorch
version (K4b for every fused cluster), so these tests exercise the
port's whole forward path except the kernels themselves. Tolerances:
none for sorts and permutations (they move values); the FFT's float32
butterflies agree with the reference within 1e-4 absolute on unit-normal
input of 2^7 points (XLA may contract multiply-adds the port rounds
separately) and with ``np.fft.fft`` within 1e-3.
"""
import math
import random

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.combinators import compile_expr as r_compile
from repro.combinators import execute as rex
from repro.combinators import vocab as RV
from repro.combinators.fft import _stage_core as r_stage_core
from repro.combinators.fft import compiled_fft as r_compiled_fft
from repro.combinators.fft import to_planar as r_to_planar
from repro.combinators.sort import compiled_sort as r_compiled_sort
from repro.core import parm as rparm
from repro.core import sort as rsort
from repro.core.bmmc import Bmmc as RBmmc
from repro_torch import obs as pobs
from repro_torch.combinators import FusedStage
from repro_torch.combinators import compile_expr as p_compile
from repro_torch.combinators import execute as pex
from repro_torch.combinators import fft as pfft
from repro_torch.combinators import sort as psort
from repro_torch.combinators import vocab as PV
from repro_torch.core import parm as pparm
from repro_torch.core import sort as pcsort
from repro_torch.core.bmmc import Bmmc as PBmmc
from repro_torch.kernels.ops import choose_tile

BF16 = np.dtype(ml_dtypes.bfloat16)


@pytest.mark.parametrize("n", [6, 7, 8])
def test_sort_bitwise_equal_reference_and_numpy(n):
    x = np.random.default_rng(n).integers(-50, 50, 1 << n).astype(np.int32)
    pobs.reset()
    pobs.enable()
    try:
        got = psort.sort(torch.from_numpy(x))
        fallbacks = pobs.counter_total("dispatch.fused_fallback")
        fused = pobs.counter_value("dispatch.kernel", kernel="fused")
    finally:
        pobs.disable()
        pobs.reset()
    assert got.device.type == "cpu"           # a tensor stays where it is
    assert fallbacks == 0 and fused > 0
    want = np.asarray(r_compiled_sort(n, engine="pallas")(jnp.asarray(x)))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), np.sort(x))


def test_sort_float_signed_zeros_match_reference():
    n = 6
    rng = np.random.default_rng(8)
    x = rng.integers(-2, 3, 1 << n).astype(np.float32)
    x[(x == 0) & (rng.random(1 << n) < 0.5)] = -0.0
    got = psort.sort(torch.from_numpy(x)).numpy()
    want = np.asarray(r_compiled_sort(n, engine="pallas")(jnp.asarray(x)))
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_fft_matches_reference_and_numpy():
    n = 7
    rng = np.random.default_rng(3)
    z = (rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)).astype(
        np.complex64)
    xr = np.asarray(r_to_planar(z))
    want = np.asarray(r_compiled_fft(n, engine="pallas")(jnp.asarray(xr)))
    got = pfft.fft_planar(torch.from_numpy(xr))
    assert got.dtype == torch.float32 and got.shape == (1 << n, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    full = pfft.from_planar(got).numpy()
    np.testing.assert_allclose(full, np.fft.fft(z), rtol=0, atol=1e-3)
    np.testing.assert_allclose(pfft.fft(torch.from_numpy(z)).numpy(),
                               np.fft.fft(z), rtol=0, atol=1e-3)
    assert torch.equal(pfft.to_planar(torch.from_numpy(z)),
                       torch.from_numpy(xr))


@pytest.mark.parametrize("n", [7, 10])
def test_complex_fft_takes_the_fused_path(n):
    """A complex64 FFT runs what the planar one runs: every butterfly
    cluster through K4b (its plain version here) on the planar view, the
    permutations through the class-dispatched kernels, no cluster falling
    back and no plain gather; the result is the planar FFT's, bit for
    bit."""
    rng = np.random.default_rng(n)
    z = torch.from_numpy((rng.normal(size=1 << n)
                          + 1j * rng.normal(size=1 << n)).astype(np.complex64))
    pobs.reset()
    pobs.enable()
    try:
        got = pfft.fft(z)
        fallbacks = pobs.counter_total("dispatch.fused_fallback")
        fused = pobs.counter_value("dispatch.kernel", kernel="fused")
        gathers = pobs.counter_value("dispatch.kernel", kernel="ref")
    finally:
        pobs.disable()
        pobs.reset()
    assert fallbacks == 0 and gathers == 0 and fused > 0
    planar = pfft.from_planar(pfft.fft_planar(pfft.to_planar(z)))
    assert torch.equal(got, planar)


@pytest.mark.parametrize("s", [0, 3, 6, 15])
def test_fft_twiddles_bitwise_equal_reference(s):
    """The butterfly twiddles (Python complex) and the float32 (re, im)
    table the fused kernel reads are the reference's, bit for bit."""
    rb, pb = r_stage_core(s), pfft._stage_core(s)
    assert rb.twiddles == pb.twiddles
    want = rex._w_planar_cached(rb.twiddles, "float32")
    got = pex._w_planar_cached(pb, "float32")
    assert want.dtype == got.dtype == np.float32
    assert np.array_equal(want.view(np.uint32), got.view(np.uint32))
    assert pb.twiddles[-1] == complex(
        math.cos(-2 * math.pi * ((1 << s) - 1) / (2 << s)),
        math.sin(-2 * math.pi * ((1 << s) - 1) / (2 << s)))


def test_parm_matches_reference():
    n = 6
    x = np.random.default_rng(4).integers(0, 1000, 1 << n).astype(np.int32)
    for mask in (1, 3, 0b101010, 1 << (n - 1)):
        assert pparm.parm_matrix(n, mask) == PBmmc(
            *(lambda b: (b.rows, b.c))(rparm.parm_matrix(n, mask)))
        want = rparm.parm_ref(mask, lambda h: h[::-1], x)
        assert np.array_equal(pparm.parm_ref(mask, lambda h: h[::-1], x),
                              want)
        got = pparm.parm(mask, lambda h: torch.flip(h, (0,)),
                         torch.from_numpy(x))
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(got.numpy(), np.asarray(rparm.parm(
            mask, lambda h: jnp.flip(h, 0), jnp.asarray(x))))
    assert pparm.lsb(0b101000) == rparm.lsb(0b101000) == 3


def test_core_sort_matches_reference():
    n = 5
    x = np.random.default_rng(6).integers(-9, 9, 1 << n).astype(np.int32)
    assert np.array_equal(pcsort.sort_rec(n, x), rsort.sort_rec(n, x))
    assert np.array_equal(pcsort.sort_rec(n, x), np.sort(x))
    for fn in ("compile_sort", "compile_merge", "compile_vcolumn"):
        rp, pp = getattr(rsort, fn)(n), getattr(pcsort, fn)(n)
        assert len(rp) == len(pp)
        for a, b in zip(rp, pp):
            assert type(a).__name__ == type(b).__name__
            if hasattr(a, "bmmc"):
                assert (a.bmmc.rows, a.bmmc.c) == (b.bmmc.rows, b.bmmc.c)
    fused = pcsort.fuse(pcsort.compile_sort(n))
    assert pcsort.num_perm_stages(fused) == rsort.num_perm_stages(
        rsort.fuse(rsort.compile_sort(n)))
    xt = torch.from_numpy(x)
    assert np.array_equal(pcsort.sort_compiled(xt).numpy(), np.sort(x))
    assert np.array_equal(
        pcsort.run_stages(fused, xt, engine="cuda").numpy(), np.sort(x))


def _payload(shape, dtype, seed):
    """Random bits of ``dtype``, with two platform differences taken out
    of the float types: every NaN is the canonical quiet NaN (the port
    and XLA agree on which NaN min/max returns only when the two
    operands' NaNs have the same bits), and subnormals are signed zeros
    (XLA on the CPU flushes them to zero in min/max; the port keeps
    them, see ``test_port_keeps_subnormals``)."""
    raw = np.random.default_rng(seed).integers(
        0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
    if dtype == np.int32:
        return raw.view(np.int32)
    if dtype == BF16:
        raw = (raw >> 16).astype(np.uint16)
        exp, man, sign = raw & 0x7F80, raw & 0x7F, raw & 0x8000
        raw = np.where((exp == 0x7F80) & (man != 0), 0x7FC0,
                       np.where(exp == 0, sign, raw))
        return raw.astype(np.uint16).view(BF16)
    exp, man, sign = raw & 0x7F800000, raw & 0x7FFFFF, raw & 0x80000000
    raw = np.where((exp == 0x7F800000) & (man != 0), 0x7FC00000,
                   np.where(exp == 0, sign, raw))
    return raw.astype(np.uint32).view(np.float32)


def test_port_keeps_subnormals():
    """The port orders subnormals exactly, on the clustered "cuda" engine
    (K4b's plain version here) as on the per-stage "ref" engine."""
    n = 6
    tiny = np.float32(1e-40)
    x = np.zeros(1 << n, np.float32)
    x[::3] = tiny
    x[1::3] = -tiny
    xt = torch.from_numpy(x)
    got = psort.sort(xt).numpy()
    assert np.array_equal(got, np.sort(x))
    assert got[0] == -tiny and got[-1] == tiny
    assert np.array_equal(got, psort.sort(xt, engine="ref").numpy())


def _fuzz_expr(V, Bmmc, seed):
    rng = random.Random(seed)
    n = rng.choice([6, 7])
    parts = [V.perm(Bmmc.random_bpc(n, rng))]
    for _ in range(rng.choice([2, 3])):
        parts.append(V.cmp_halves())
        parts.append(V.perm(Bmmc.random_bpc(n, rng))
                     if rng.random() < 0.7 else V.perm(Bmmc.random(n, rng)))
    if rng.random() < 0.5:
        parts.insert(2, V.emap("x2", lambda v: v * 2))
    return V.seq(*parts), n


@pytest.mark.parametrize("seed", range(6))
def test_fused_mixed_program_fuzz(seed):
    """Random perm/compare/map programs: the port's clustered "cuda"
    engine == its per-stage "ref" engine == the reference's "ref"
    engine, bitwise, across dtype x tail x batch drawn per seed."""
    pe, n = _fuzz_expr(PV, PBmmc, seed)
    re_, _ = _fuzz_expr(RV, RBmmc, seed)
    dtype = [np.float32, np.int32, BF16][seed % 3]
    tail = [(), (2,)][seed % 2]
    batched = seed % 2 == 1
    shape = ((2,) if batched else ()) + (1 << n,) + tail
    x = _payload(shape, dtype, seed)
    xt = (torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
          if dtype == BF16 else torch.from_numpy(x))
    f = p_compile(pe, engine="cuda")
    got = f(xt, batched=batched)
    t = choose_tile(n, xt.element_size(), tail[0] if tail else 1)
    assert any(isinstance(s, FusedStage) for s in f.clustered_program(n, t))
    ref = p_compile(pe, engine="ref")(xt, batched=batched)
    want = np.asarray(r_compile(re_, engine="ref")(jnp.asarray(x),
                                                  batched=batched))

    def raw(a):
        if isinstance(a, torch.Tensor):
            a = (a.view(torch.int16).numpy() if a.dtype == torch.bfloat16
                 else a.numpy())
        return np.ascontiguousarray(a).view(np.uint8)

    assert np.array_equal(raw(got), raw(ref)), (seed, n, dtype, tail)
    assert np.array_equal(raw(got), raw(want)), (seed, n, dtype, tail)
