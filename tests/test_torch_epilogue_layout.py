"""The register-epilogue plan of K4b and K5 (``kernels/epilogue_plan.py``)
on the CPU.

The CUDA kernels ``tile_fused.cu`` and ``tile_bwd.cu`` run a cluster's
epilogues in registers under a layout plan the host builds; the kernels
themselves run only on the card. Here:

* the plan's ``hi`` masks and twiddle images reproduce the tables
  (``hi_row``, ``hi_lane``, ``hi_base``, ``tw_row``, ``tw_lane``,
  ``tw_base``) at every position of every block, and a table that is not
  linear raises instead of being run;
* a plain PyTorch emulation of the kernels' schedule, read from the same
  plan words the kernels read — 256 threads of 16 registers, the
  register, shuffle (lane XOR) and re-layout steps of each phase, chunks,
  the compare bits kept per thread and register, compares on integer keys
  in warps without NaNs, the transposed sweep in reverse with the
  un-gather folded into its first phase — equals ``_tile_fused_plain``
  and ``_tile_bwd_plain`` bit for bit;
* map epilogues in that emulation: each map's tape on the registers, the
  compares between two maps as a run with its own NaN vote and keys (a
  map that makes NaNs mid-phase sends the rest of its phase's warps to
  the float selects), each map's input kept per slot, chunk, thread and
  register, and K5's reverse mode over the tape in the transposed sweep,
  equal to the plain versions (which call the map's function, and take
  its VJP by autograd) bit for bit.

Clusters: every cluster of the 2^12 and 2^14 sort and of the 2^12 FFT,
and hand-built clusters whose partner XORs have several bits and fall on
register, lane and warp bits (more than 16 compares, so K5's compare bits
span two registers; one with butterflies beside compares; one on a block
of 2^14 positions, run in chunks), at t = 4, 5 and 6 with d = 1 and 3.
Inputs are made with numpy from a seed.
"""
import gc
import random
import weakref

import numpy as np
import pytest
import torch

from repro_torch.combinators import FusedStage, compile_expr
from repro_torch.combinators import execute as pex
from repro_torch.combinators.fft import fft_expr
from repro_torch.combinators.sort import sort_expr
from repro_torch.core.bmmc import Bmmc
from repro_torch.core.tiling import _affine_table, plan_general
from repro_torch.kernels import bmmc_permute as pk
from repro_torch.kernels import epilogue_plan as EP
from repro_torch.kernels import map_lower as ML


# ---------------------------------------------------------------------------
# clusters
# ---------------------------------------------------------------------------

def _program_clusters(name, n, t, dtype):
    """(geometry, plan tables, wrapper epilogue entries) of every fused
    cluster of the sort or FFT at 2^n, tile t."""
    expr = {"sort": sort_expr, "fft": fft_expr}[name](n)
    prog = compile_expr(expr).clustered_program(n, t)
    out = []
    for fs in prog:
        if not (isinstance(fs, FusedStage) and fs.computes):
            continue
        plans, entries = pex._fused_plan_cached(fs, t)
        sig, scal, vmem, _ = pex._fused_kernel_args(entries, dtype)
        out.append((plans[0], pk._epi_entries(sig, scal, vmem)))
    assert out
    return out


def _hand_cluster(n, t, n_epi, seed, bfly_every=0):
    """A tile plan of a random BMMC and ``n_epi`` epilogues with random
    multi-bit partner XORs (every fourth the XOR of the two before it) and
    random linear tables (a butterfly every ``bfly_every``-th epilogue
    when non-zero)."""
    rng = np.random.default_rng(seed)
    plan = plan_general(Bmmc.random(n, random.Random(seed)), t)
    rpt, n_tiles = plan.rows_per_tile, plan.n_tiles
    rb, gb = rpt.bit_length() - 1, n_tiles.bit_length() - 1

    def lin(bits, hi):
        return _affine_table([int(v) for v in rng.integers(0, hi, bits)])

    def aff(bits, hi):
        return _affine_table([int(v) for v in rng.integers(0, hi, bits)],
                             int(rng.integers(0, hi)))

    w = rng.normal(size=(1 << (n - 1), 2)).astype(np.float32)
    entries, vs = [], []
    for k in range(n_epi):
        v = int(rng.integers(1, rpt << t))
        if k % 4 == 3 and vs[-1] != vs[-2]:
            v = vs[-1] ^ vs[-2]    # a dependent XOR: several coordinates
        vs.append(v)
        vr, vc = v >> t, v & ((1 << t) - 1)
        hi = (lin(rb, 2), lin(t, 2), aff(gb, 2))
        hi = tuple(a.astype(np.int32) for a in hi)
        if bfly_every and k % bfly_every == bfly_every - 1:
            tw = tuple(a.astype(np.int32) for a in (
                lin(rb, 1 << (n - 1)), lin(t, 1 << (n - 1)),
                aff(gb, 1 << (n - 1))))
            entries.append((1, vr, vc, *hi, *tw, w))
        else:
            entries.append((0, vr, vc, *hi, None, None, None, None))
    return plan, entries


def _values(shape, dtype, seed, nan=True):
    """Small integers (ties) with signed zeros and (``nan``) NaNs for
    float types."""
    rng = np.random.default_rng(seed)
    f = rng.integers(-4, 5, size=shape).astype(np.float32)
    u = rng.random(shape)
    if dtype != torch.int32:
        if nan:
            f[u < 0.05] = np.nan
        f[(u > 0.5) & (f == 0)] = -0.0
    return torch.from_numpy(f).to(dtype)


# ---------------------------------------------------------------------------
# the emulation of the kernels' schedule
# ---------------------------------------------------------------------------

def _xor_images(idx, imgs):
    out = torch.zeros_like(idx)
    for b, im in enumerate(imgs):
        out ^= torch.where((idx >> b) & 1 == 1, int(im), 0)
    return out


def _popc(x, bits=24):
    return sum((x >> b) & 1 for b in range(bits))


class _Layout:
    """A phase's positions: ``pos`` (chunks, 256, kr), ``qb`` (chunks,
    256) the thread-and-chunk part, ``valid`` where a register holds a
    position."""

    def __init__(self, ph, outer_bits, kr):
        self.kr = kr
        i = torch.arange(kr)
        tid = torch.arange(EP.THREADS)
        c = torch.arange(1 << outer_bits)
        qr = _xor_images(i, ph[EP.PH_IMG_REG:EP.PH_IMG_REG + 4])
        qt = _xor_images(tid, ph[EP.PH_IMG_THR:EP.PH_IMG_THR + 8])
        qc = _xor_images(c, ph[EP.PH_IMG_OUT:EP.PH_IMG_OUT + outer_bits])
        self.qb = qc[:, None] ^ qt[None, :]
        self.pos = self.qb[..., None] ^ qr
        rv = (int(ph[EP.PH_REG_VALID]) >> i) & 1 == 1
        tv = (tid & int(ph[EP.PH_TID_INVALID])) == 0
        self.valid = (rv[None, None, :] & tv[None, :, None]).expand(
            self.pos.shape)


def _load(X, lay, k, dv):
    """Registers (B, nblk, chunks, 256, kr, dv); empty registers zero."""
    pos = torch.where(lay.valid, lay.pos, 0)
    v = X[:, :, pos, k:k + dv]
    return torch.where(lay.valid[None, None, ..., None], v,
                       torch.zeros((), dtype=X.dtype))


def _store(X, V, lay, k, dv):
    sel = lay.valid.reshape(-1)
    X[:, :, lay.pos.reshape(-1)[sel], k:k + dv] = V.reshape(
        V.shape[0], V.shape[1], -1, dv)[:, :, sel]


def _partner(V, vreg, vlane):
    tid = torch.arange(EP.THREADS) ^ vlane
    i = torch.arange(V.shape[4]) ^ vreg
    return V.index_select(3, tid).index_select(4, i)


def _hi(ep, lay, g0, hi_base):
    """(nblk, chunks, 256, kr) bool: hreg bit ^ parity(qb & hmask) ^
    hi_base[g0]."""
    hreg = (int(ep[EP.EP_HREG]) >> torch.arange(lay.kr)) & 1
    hthr = _popc(lay.qb & int(ep[EP.EP_HMASK]))
    hb = torch.as_tensor(np.asarray(hi_base, dtype=np.int64))[g0]
    return ((hb[:, None, None, None] ^ hthr[None, ..., None] ^ hreg) & 1) == 1


def _twiddles(ep, lay, g0, e, outer_bits):
    i = torch.arange(lay.kr)
    tid = torch.arange(EP.THREADS)
    c = torch.arange(1 << outer_bits)
    tw = (_xor_images(i, ep[EP.EP_TW_REG:EP.EP_TW_REG + 4])[None, None, :]
          ^ _xor_images(tid, ep[EP.EP_TW_THR:EP.EP_TW_THR + 8])[None, :, None]
          ^ _xor_images(c, ep[EP.EP_TW_OUT:EP.EP_TW_OUT + outer_bits])[
              :, None, None])
    tb = torch.as_tensor(np.asarray(e[8], dtype=np.int64))[g0]
    tw = tb[:, None, None, None] ^ tw[None]
    w = torch.as_tensor(np.asarray(e[9], dtype=np.float32))
    return w[:, 0][tw][None], w[:, 1][tw][None]


def _forward(V, ep, e, lay, g0, outer_bits, masks=None):
    """One epilogue on the registers; with ``masks`` the compare bits of
    each element go to its thread and register at the epilogue's shift."""
    P = _partner(V, int(ep[EP.EP_VREG]), int(ep[EP.EP_VLANE]))
    hi = _hi(ep, lay, g0, e[5])[None, ..., None]
    if int(ep[EP.EP_KIND]) == 0:
        O = torch.where(hi, pk.cmp_max(V, P), pk.cmp_min(V, P))
        if masks is not None:
            bits = (V == O).long() | ((P == O).long() << 1)
            masks |= bits << int(ep[EP.EP_SHIFT])
        return O
    wr, wi = _twiddles(ep, lay, g0, e, outer_bits)
    hi = hi[..., 0]
    v_re, v_im, p_re, p_im = V[..., 0], V[..., 1], P[..., 0], P[..., 1]
    lo_re = torch.where(hi, p_re, v_re)
    lo_im = torch.where(hi, p_im, v_im)
    hi_re = torch.where(hi, v_re, p_re)
    hi_im = torch.where(hi, v_im, p_im)
    t_re = wr * hi_re - wi * hi_im
    t_im = wr * hi_im + wi * hi_re
    return torch.stack([torch.where(hi, lo_re - t_re, lo_re + t_re),
                        torch.where(hi, lo_im - t_im, lo_im + t_im)], dim=-1)


def _keys(V):
    """The kernels' compare keys of float / bfloat16 values (int64)."""
    b = (V.view(torch.int32).long() if V.dtype == torch.float32
         else V.view(torch.int16).long() << 16)
    b = torch.where(b >= 1 << 31, b - (1 << 32), b)       # as int32
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def _from_keys(K, dtype):
    b = (K ^ ((K >> 31) & 0x7FFFFFFF)) & 0xFFFFFFFF
    if dtype == torch.float32:
        return torch.where(b >= 1 << 31, b - (1 << 32), b).to(
            torch.int32).view(torch.float32)
    b = b >> 16
    return torch.where(b >= 1 << 15, b - (1 << 16), b).to(
        torch.int16).view(torch.bfloat16)


def _forward_phase(V, eps, ents, lay, g0, outer_bits, masks):
    """A phase's epilogues as the kernels run them: a compare cluster's
    floats on keys in every warp whose values hold no NaN (integer max /
    min, compare bits from key equality and the zero tie), the float
    functions in the others; the two are held to the same result."""
    m_float = None if masks is None else masks.clone()
    Vf = V
    for ep, e in zip(eps, ents):
        Vf = _forward(Vf, ep, e, lay, g0, outer_bits, m_float)
    if V.dtype == torch.int32 or V.shape[-1] != 1:
        if masks is not None:
            masks.copy_(m_float)
        return Vf
    K = _keys(V)
    m_key = None if masks is None else masks.clone()
    for ep, e in zip(eps, ents):
        P = _partner(K, int(ep[EP.EP_VREG]), int(ep[EP.EP_VLANE]))
        hi = _hi(ep, lay, g0, e[5])[None, ..., None]
        O = torch.where(hi, torch.maximum(K, P), torch.minimum(K, P))
        if m_key is not None:
            zero = ((K + 1) | (P + 1)) & ~1 == 0
            tie = (K == P) | zero
            bits = torch.where(tie, 3, 2 - (K == O).long())
            m_key |= bits << int(ep[EP.EP_SHIFT])
        K = O
    Vk = _from_keys(K, V.dtype)
    shape = V.shape[:3] + (EP.THREADS // 32, -1)
    nan = torch.isnan(V.float()).reshape(shape).any(-1)        # per warp
    fast = (~nan)[..., None].expand(tuple(nan.shape) + (32,)).reshape(
        V.shape[:4])[..., None, None]
    if masks is not None:
        masks.copy_(torch.where(fast, m_key, m_float))
    return torch.where(fast, Vk, Vf)


def _run_phase(V, eps, ents, lay, g0, outer_bits, masks, saved):
    """A phase's epilogues: the compares between two maps as one run of
    :func:`_forward_phase` (its own NaN vote and keys), each map's tape on
    the values, its input kept in ``saved`` by slot (K5's shared-memory
    copy)."""
    i = 0
    while i < len(eps):
        if int(eps[i][EP.EP_KIND]) == EP.KIND_MAP:
            if int(eps[i][EP.EP_MAP_FROM]) < 0:   # else K5 recomputes it
                saved[int(eps[i][EP.EP_MAP_SLOT])] = V
            V = ML.eval_tape(ents[i][9], V)
            i += 1
            continue
        j = i + 1
        while j < len(eps) and int(eps[j][EP.EP_KIND]) != EP.KIND_MAP:
            j += 1
        V = _forward_phase(V, eps[i:j], ents[i:j], lay, g0, outer_bits,
                           masks)
        i = j
    return V


def _transposed(V, ep, e, lay, g0, outer_bits, masks):
    vreg, vlane = int(ep[EP.EP_VREG]), int(ep[EP.EP_VLANE])
    if int(ep[EP.EP_KIND]) == 0:
        b = (masks >> int(ep[EP.EP_SHIFT])) & 3
        m1, m2 = pk.tie_masks(b & 1 == 1, b & 2 == 2, V.dtype)
        return V * m1 + _partner(V * m2, vreg, vlane)
    hi = _hi(ep, lay, g0, e[5])[None]
    wr, wi = _twiddles(ep, lay, g0, e, outer_bits)
    return pk.bfly_transpose(V, _partner(V, vreg, vlane), ~hi, wr, wi)


def _blocks(xc, rows, row_len, per_cta, rpt):
    """The block tiles (B, nblk, Q, d) loaded from ``rows`` (n_tiles,
    rpt), and the flat source index of each position."""
    glob = (torch.as_tensor(np.asarray(rows, dtype=np.int64))[..., None]
            * row_len + torch.arange(row_len)).reshape(-1, per_cta * rpt
                                                       * row_len)
    return xc[:, glob], glob


def _emulate(xc, plan_t, entries, geometry, cc=None, inv_src0=None):
    """K4b (``cc`` None) or K5 on CPU tensors, from the plan words."""
    n, t, rpt, _, _, n_tiles, _ = geometry
    words = plan_t.numpy()
    info = plan_t.info
    row_len = 1 << t
    batch, _, d = xc.shape
    per_cta = pk._tiles_per_cta(geometry, d * xc.element_size(),
                                EP.REGS * EP.THREADS)
    nblk = n_tiles // per_cta
    g0 = torch.arange(nblk) * per_cta
    outer_bits = int(words[2])
    n_phases = int(words[0])
    dv = 2 if any(e[0] == 1 for e in entries) else 1
    X, x_glob = _blocks(xc, plan_t.in_rows, row_len, per_cta, rpt)
    X = X.clone()
    lays = [_Layout(EP.phase_slice(words, p), outer_bits, 1 << int(words[3]))
            for p in range(n_phases)]
    for lay in lays:   # every layout holds each position exactly once
        got = torch.sort(lay.pos[lay.valid]).values
        assert torch.equal(got, torch.arange(per_cta * rpt * row_len))

    def epis(p):
        ph = EP.phase_slice(words, p)
        return range(int(ph[EP.PH_E0]), int(ph[EP.PH_E1]))

    for k in range(0, d, dv):
        masks, saved = {}, {}
        for p, lay in enumerate(lays):
            V = _load(X, lay, k, dv)
            ph = EP.phase_slice(words, p)
            group = int(ph[EP.PH_GROUP])
            m = None
            if cc is not None and group >= 0:
                if int(ph[EP.PH_FIRST]):
                    masks[group] = torch.zeros(V.shape, dtype=torch.long)
                m = masks[group]
            V = _run_phase(V, [EP.epi_slice(words, e) for e in epis(p)],
                           [entries[e] for e in epis(p)], lay, g0,
                           outer_bits, m, saved)
            if cc is None or p + 1 < n_phases:
                _store(X, V, lay, k, dv)
        if cc is None:
            continue
        # the transposed sweep: the un-gathered cotangent first
        C, _ = _blocks(cc, plan_t.out_rows, row_len, per_cta, rpt)
        q = torch.arange(per_cta * rpt * row_len)
        rb = rpt.bit_length() - 1
        r, j = q >> t, q >> (t + rb)
        xl = torch.as_tensor(np.asarray(plan_t.xor_low, dtype=np.int64))
        inv = torch.as_tensor(np.asarray(inv_src0, dtype=np.int64)).reshape(-1)
        s = inv[((r & (rpt - 1)) << t) | (q & (row_len - 1))][None, :] ^ \
            xl[g0[:, None] + j[None, :]]
        src = ((j[None, :] << rb | s >> t) << t) | (s & (row_len - 1))
        pre = torch.gather(pk._int_view(C), 2, src[None, :, :, None].expand(
            C.shape)).view(C.dtype)
        for p in range(n_phases - 1, -1, -1):
            lay = lays[p]
            V = _load(pre if p + 1 == n_phases else X, lay, k, dv)
            group = int(EP.phase_slice(words, p)[EP.PH_GROUP])
            for e in reversed(epis(p)):
                ep = EP.epi_slice(words, e)
                if int(ep[EP.EP_KIND]) == EP.KIND_MAP:
                    frm = int(ep[EP.EP_MAP_FROM])
                    if frm >= 0:
                        # the input recomputed from map frm's kept input:
                        # epilogues frm .. e - 1 replayed, into e's slot
                        ev = range(frm, e)
                        saved[int(ep[EP.EP_MAP_SLOT])] = _run_phase(
                            saved[int(EP.epi_slice(words, frm)[
                                EP.EP_MAP_SLOT])],
                            [EP.epi_slice(words, i) for i in ev],
                            [entries[i] for i in ev], lay, g0, outer_bits,
                            None, {})
                    V = ML.tape_vjp(entries[e][9],
                                    saved[int(ep[EP.EP_MAP_SLOT])], V)
                    continue
                V = _transposed(V, ep, entries[e], lay, g0, outer_bits,
                                masks.get(group))
            _store(X, V, lay, k, dv)
    out = torch.empty_like(xc)
    if cc is not None:
        out[:, x_glob.reshape(-1)] = X.reshape(batch, -1, d)
        return out
    # the gather of each tile into its output rows
    src0 = torch.as_tensor(np.asarray(plan_t.src0, dtype=np.int64)).reshape(-1)
    xl = torch.as_tensor(np.asarray(plan_t.xor_low, dtype=np.int64))
    jl = torch.arange(rpt * row_len)
    tiles = X.reshape(batch, n_tiles, rpt * row_len, d)
    src = src0[(jl >> t << t) | ((jl & (row_len - 1))[None, :]
                                 ^ xl[:, None])]
    got = torch.gather(pk._int_view(tiles), 2, src[None, :, :, None].expand(
        tiles.shape)).view(tiles.dtype)
    orow = torch.as_tensor(np.asarray(plan_t.out_rows, dtype=np.int64))
    y = (orow[:, jl >> t] * row_len + (jl & (row_len - 1))).reshape(-1)
    out[:, y] = got.reshape(batch, -1, d)
    return out


class _PlanView:
    """A tile plan's tables beside the launcher's plan tensor."""

    def __init__(self, plan, words):
        self.in_rows, self.out_rows = plan.in_rows, plan.out_rows
        self.xor_low, self.src0 = plan.xor_low, plan.src0
        self.words, self.info = words, words.info

    def numpy(self):
        return self.words.numpy()


def _check_cluster(plan, entries, xc, cc):
    """The emulated K4b and K5 equal their plain versions bit for bit, on
    the plan the launcher builds for these tensors."""
    geometry = pk.plan_geometry(plan)
    _, _, words, _ = pk._epi_launch_args(xc, geometry, entries)
    view = _PlanView(plan, words)
    want = pk._tile_fused_plain(xc, plan.in_rows, plan.out_rows,
                                plan.xor_low, plan.src0, geometry, entries)
    got = _emulate(xc, view, entries, geometry)
    assert torch.equal(pk._int_view(got), pk._int_view(want))
    if cc is None:
        return words.info
    s0 = plan.src0.reshape(-1)
    inv = np.empty_like(s0)
    inv[s0] = np.arange(s0.size, dtype=s0.dtype)
    _, _, words2, _ = pk._epi_launch_args(xc, geometry, entries, n_buf=2)
    want = pk._tile_bwd_plain(xc, cc, plan.in_rows, plan.out_rows,
                              plan.xor_low, inv, geometry, entries)
    got = _emulate(xc, _PlanView(plan, words2), entries, geometry, cc=cc,
                   inv_src0=inv)
    assert torch.equal(pk._int_view(got), pk._int_view(want))
    return words.info


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def _masks_reproduce_tables(plan, entries, per_cta):
    geometry = pk.plan_geometry(plan)
    n, t, rpt, _, _, n_tiles, _ = geometry
    words, info = EP.plan_epilogues(entries, geometry, per_cta,
                                    elem_bytes=4, stride_bytes=4 << t,
                                    access=4, dv=1)
    q = np.arange(per_cta * rpt << t)
    c, r = q & ((1 << t) - 1), (q >> t) & (rpt - 1)
    j = q >> (t + rpt.bit_length() - 1)
    g0 = np.arange(0, n_tiles, per_cta)[:, None]
    for e, hmask, twp in zip(entries, info["hmask"], info["tw_pos"]):
        par = np.array([bin(int(v)).count("1") & 1 for v in q & hmask])
        want = e[3][r] ^ e[4][c] ^ e[5][g0 + j]
        assert np.array_equal(par[None, :] ^ e[5][g0], want)
        if e[0] == 1:
            lin = np.zeros_like(q)
            for b, im in enumerate(twp):
                lin ^= np.where((q >> b) & 1 == 1, im, 0)
            want = e[6][r] ^ e[7][c] ^ e[8][g0 + j]
            assert np.array_equal(lin[None, :] ^ e[8][g0], want)
    return info


@pytest.mark.parametrize("name,n,t", [
    ("sort", 12, 4), ("sort", 12, 6), ("sort", 14, 5), ("fft", 12, 5)])
def test_masks_and_twiddle_images_reproduce_the_tables(name, n, t):
    for plan, entries in _program_clusters(name, n, t, torch.float32):
        for per_cta in (1, min(4, plan.n_tiles)):
            _masks_reproduce_tables(plan, entries, per_cta)


def test_hand_built_masks_and_images_reproduce_the_tables():
    plan, entries = _hand_cluster(12, 6, 14, seed=3, bfly_every=2)
    info = _masks_reproduce_tables(plan, entries, 1)
    assert info["n_phases"] >= 2


def test_a_table_that_is_not_linear_raises():
    plan, entries = _hand_cluster(10, 4, 2, seed=4)
    geometry = pk.plan_geometry(plan)
    kw = dict(elem_bytes=4, stride_bytes=64, access=4, dv=1)
    bad = list(entries[0])
    bad[4] = bad[4] ^ np.int32(1)            # hi_lane[0] = 1: affine
    with pytest.raises(ValueError, match="not linear"):
        EP.plan_epilogues([tuple(bad)] + entries[1:], geometry, 1, **kw)
    bad = list(entries[0])
    hb = bad[5].copy()
    hb[1] ^= 1                               # breaks the per-block form
    bad[5] = hb
    with pytest.raises(ValueError, match="not affine"):
        EP.plan_epilogues([tuple(bad)] + entries[1:], geometry, 2, **kw)
    bad[5] = entries[0][5] * 2
    with pytest.raises(ValueError, match="0 and 1"):
        EP.plan_epilogues([tuple(bad)], geometry, 1, **kw)


@pytest.mark.parametrize("name,n", [("sort", 12), ("sort", 14)])
@pytest.mark.parametrize("t", [4, 5, 6])
@pytest.mark.parametrize("d", [1, 3])
def test_sort_clusters_schedule_matches_plain(name, n, t, d):
    shape = (1, 1 << n, d)
    for k, (plan, entries) in enumerate(_program_clusters(name, n, t,
                                                          torch.float32)):
        xc = _values(shape, torch.float32, seed=k)
        cc = torch.from_numpy(np.random.default_rng(k + 50).normal(
            size=shape).astype(np.float32))
        _check_cluster(plan, entries, xc, cc)


@pytest.mark.parametrize("t", [4, 5, 6])
def test_fft_clusters_schedule_matches_plain(t):
    for k, (plan, entries) in enumerate(_program_clusters("fft", 12, t,
                                                          torch.float32)):
        rng = np.random.default_rng(k)
        xc = torch.from_numpy(rng.normal(size=(1, 1 << 12, 2)).astype(
            np.float32))
        cc = torch.from_numpy(rng.normal(size=(1, 1 << 12, 2)).astype(
            np.float32))
        info = _check_cluster(plan, entries, xc, cc)
        assert info["n_phases"] >= 1


@pytest.mark.parametrize("dtype", [torch.int32, torch.bfloat16])
def test_sort_clusters_schedule_matches_plain_other_dtypes(dtype):
    for k, (plan, entries) in enumerate(_program_clusters("sort", 12, 6,
                                                          dtype)):
        xc = _values((3, 1 << 12, 1), dtype, seed=k)
        cc = None if dtype == torch.int32 else _values(
            (3, 1 << 12, 1), dtype, seed=k + 9)
        _check_cluster(plan, entries, xc, cc)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sort_clusters_on_keys_match_plain(dtype):
    """Without NaNs every warp runs its compares on keys: ties and signed
    zeros give the floats' results and compare bits."""
    for k, (plan, entries) in enumerate(_program_clusters("sort", 12, 6,
                                                          dtype)):
        xc = _values((2, 1 << 12, 1), dtype, seed=k, nan=False)
        cc = _values((2, 1 << 12, 1), dtype, seed=k + 5, nan=False)
        _check_cluster(plan, entries, xc, cc)


@pytest.mark.parametrize("t", [4, 5, 6])
@pytest.mark.parametrize("d", [1, 3])
def test_hand_built_cluster_schedule_matches_plain(t, d):
    """20 compares with multi-bit partner XORs: several phases, XORs on
    register, lane and warp bits, K5's bits in two register words."""
    plan, entries = _hand_cluster(12, t, 20, seed=10 * t + d)
    xc = _values((2, 1 << 12, d), torch.float32, seed=t)
    cc = torch.from_numpy(np.random.default_rng(t).normal(
        size=(2, 1 << 12, d)).astype(np.float32))
    info = _check_cluster(plan, entries, xc, cc)
    assert info["groups"] == 2 and info["n_phases"] >= 2
    words = pk._epi_launch_args(xc, pk.plan_geometry(plan), entries)[2]
    w = words.numpy()
    vregs = [int(EP.epi_slice(w, e)[EP.EP_VREG]) for e in range(20)]
    vlanes = [int(EP.epi_slice(w, e)[EP.EP_VLANE]) for e in range(20)]
    assert any(v and not l for v, l in zip(vregs, vlanes))     # in thread
    assert any(l for l in vlanes)                              # shuffled
    vs = [(e[1] << t) | e[2] for e in entries]
    assert all(bin(v).count("1") > 1 for v in vs[3::4])        # several bits
    assert any(bin((l << 4) | v).count("1") > 1                # coordinates
               for v, l in zip(vregs, vlanes))


def test_hand_built_mixed_cluster_schedule_matches_plain():
    """Butterflies beside compares on a planar float32 tail: two values a
    register slot."""
    plan, entries = _hand_cluster(12, 5, 9, seed=21, bfly_every=3)
    rng = np.random.default_rng(5)
    xc = torch.from_numpy(rng.normal(size=(1, 1 << 12, 2)).astype(
        np.float32))
    cc = torch.from_numpy(rng.normal(size=(1, 1 << 12, 2)).astype(
        np.float32))
    _check_cluster(plan, entries, xc, cc)


def test_large_block_runs_in_chunks():
    """A tile of more than 2^12 positions (t = 7): outer slots, run in
    chunks, and K5's compare bits kept per chunk."""
    plan, entries = _hand_cluster(14, 7, 6, seed=8)
    outer = (plan.rows_per_tile << 7).bit_length() - 1 - 12
    assert outer >= 1
    xc = _values((1, 1 << 14, 1), torch.float32, seed=2)
    cc = torch.from_numpy(np.random.default_rng(3).normal(
        size=(1, 1 << 14, 1)).astype(np.float32))
    info = _check_cluster(plan, entries, xc, cc)
    assert info["outer_bits"] == outer
    # one compare group: a set a chunk; K5 keeps two sets in registers
    # and more in shared memory
    sets = 1 << outer
    assert EP.spill_sids(info) == (sets if sets > 2 else 0)


def test_plan_cache_counts_the_tables_it_keeps(monkeypatch):
    """A caller that passes new host tables on every call misses the plan
    cache each time. Each entry counts the tables and uploads it keeps
    alive, so the cache stays within its byte bound and drops the tables
    of the entries it evicts."""
    plan, entries = _hand_cluster(12, 5, 9, seed=21, bfly_every=3)
    geometry = pk.plan_geometry(plan)
    xc = torch.zeros((1, 1 << 12, 2), dtype=torch.float32)
    tables = {id(a): a.nbytes for e in entries for a in e[3:10]
              if a is not None}
    table_bytes = sum(tables.values())
    cache = pk._DeviceCache(max_bytes=3 * table_bytes + (1 << 16))
    monkeypatch.setattr(pk, "_DEV_CACHE", cache)
    alive = []
    for _ in range(10):
        fresh = [e[:3] + tuple(None if a is None else a.copy()
                               for a in e[3:10]) for e in entries]
        alive.append(weakref.ref(fresh[0][5]))
        pk._epi_launch_args(xc, geometry, fresh)
        assert cache._bytes <= cache.max_bytes
        del fresh
    gc.collect()
    assert cache.misses == 10 and 1 <= len(cache._d) <= 3
    assert all(size >= table_bytes for _, _, size in cache._d.values())
    assert sum(r() is not None for r in alive) == len(cache._d)


# ---------------------------------------------------------------------------
# map epilogues
# ---------------------------------------------------------------------------

def _with_maps(entries, maps, dtype):
    """``entries`` with map entries inserted: ``maps`` holds (position,
    name, function), positions in the final list."""
    out = list(entries)
    for pos, name, fn in sorted(maps, key=lambda m: m[0]):
        out.insert(pos, (EP.KIND_MAP, 0, 0) + (None,) * 6
                   + (ML.lower_map(name, fn, dtype),))
    return out


def _kinds_by_phase(words):
    info = words.info
    w = words.numpy()
    out = []
    for p in range(info["n_phases"]):
        ph = EP.phase_slice(w, p)
        out.append([int(EP.epi_slice(w, e)[EP.EP_KIND])
                    for e in range(int(ph[EP.PH_E0]), int(ph[EP.PH_E1]))])
    return out


def _sq(v):
    return v * v


def _silu(v):
    return v * torch.sigmoid(v)


def _affine3(v):
    return (v * 3 + 1) * 0.5


def _wrap(v):
    return v * 1000003 + 7


# label, dtype, n, t, compares, maps (position, name, function), d, batch
MAP_CASES = [
    ("float32: log makes NaNs between compares, maps at the ends and at a "
     "phase boundary", torch.float32, 12, 6, 20,
     [(0, "silu", _silu), (4, "ln", torch.log), (11, "sq", _sq),
      (15, "sq", _sq), (24, "silu", _silu)], 1, 1),
    ("float32 d=3 B=2", torch.float32, 12, 5, 12,
     [(2, "ln", torch.log), (9, "sq", _sq)], 3, 2),
    ("bfloat16 chain of three ops", torch.bfloat16, 12, 6, 14,
     [(3, "affine3", _affine3), (15, "affine3", _affine3)], 1, 2),
    ("int32 wrapping map", torch.int32, 12, 6, 14,
     [(1, "wrap", _wrap), (8, "wrap", _wrap)], 1, 1),
    ("float32 map alone", torch.float32, 12, 6, 0,
     [(0, "e^x", torch.exp)], 1, 1),
    ("float32 DAG maps: a value read twice, where on a comparison, 12 maps",
     torch.float32, 12, 6, 14,
     [(k, name, fn) for k, (name, fn) in zip(range(0, 26, 2), [
         ("dag", lambda v: torch.tanh(v) * torch.exp(-v * v)),
         ("leaky", lambda v: torch.where(v > 0, v, 0.01 * v)),
         ("gelu", torch.nn.functional.gelu),
         ("maxfl", lambda v: torch.maximum(v, torch.floor(v))),
         ("rem", lambda v: torch.remainder(v, 0.75)),
         ("sq", _sq)] * 2)], 1, 1),
]


@pytest.mark.parametrize("slots", [3, 5])
def test_k5_recomputes_the_inputs_of_maps_it_does_not_keep(monkeypatch,
                                                           slots):
    """With room for ``slots`` sets of map inputs, K5 keeps the first map's
    of each phase and recomputes the others' from the nearest kept one
    before them in their phase, replaying the epilogues in between into
    the spare slot; the emulated schedule equals the plain version bit for
    bit (12 maps in one cluster)."""
    label, dtype, n, t, n_cmp, maps, d, batch = MAP_CASES[-1]
    plan, entries = _hand_cluster(n, t, n_cmp, seed=n_cmp + t)
    entries = _with_maps(entries, maps, dtype)
    monkeypatch.setattr(pk, "k5_map_slots", lambda *a: slots)
    shape = (batch, 1 << n, d)
    xc = _values(shape, dtype, seed=t, nan=False)
    cc = _values(shape, dtype, seed=t + 1)
    _check_cluster(plan, entries, xc, cc)
    words = pk._epi_launch_args(xc, pk.plan_geometry(plan), entries,
                                n_buf=2)[2]
    w = words.numpy()
    maps_at = [e for e in range(len(entries)) if entries[e][0] == EP.KIND_MAP]
    frm = [int(EP.epi_slice(w, e)[EP.EP_MAP_FROM]) for e in maps_at]
    assert words.info["map_slots"] == slots
    assert sum(f < 0 for f in frm) == slots - 1 and max(frm) >= 0
    for e, f in zip(maps_at, frm):
        if f >= 0:
            assert f in maps_at and f < e
            assert int(EP.epi_slice(w, e)[EP.EP_MAP_SLOT]) == slots - 1


@pytest.mark.parametrize("label,dtype,n,t,n_cmp,maps,d,batch", MAP_CASES,
                         ids=[c[0].split(":")[0] for c in MAP_CASES])
def test_map_epilogues_schedule_matches_plain(label, dtype, n, t, n_cmp,
                                              maps, d, batch):
    plan, entries = _hand_cluster(n, t, n_cmp, seed=n_cmp + t)
    entries = _with_maps(entries, maps, dtype)
    shape = (batch, 1 << n, d)
    xc = _values(shape, dtype, seed=t, nan=False)
    cc = None if dtype == torch.int32 else _values(shape, dtype, seed=t + 1)
    info = _check_cluster(plan, entries, xc, cc)
    assert info["maps"] == len(maps)
    words = pk._epi_launch_args(xc, pk.plan_geometry(plan), entries)[2]
    kinds = _kinds_by_phase(words)
    assert sum(k.count(EP.KIND_MAP) for k in kinds) == len(maps)
    if n_cmp >= 20:
        # a map with compares on both sides within one phase, and a map
        # that ends a phase with another phase after it
        assert any(x == EP.KIND_MAP and EP.KIND_CMP in k[:i]
                   and EP.KIND_CMP in k[i + 1:]
                   for k in kinds for i, x in enumerate(k))
        assert any(k[-1] == EP.KIND_MAP for k in kinds[:-1])
