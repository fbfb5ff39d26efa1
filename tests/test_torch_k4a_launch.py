"""K4a's host side on the CPU: the launch record, the schedule chooser and
each schedule's index arithmetic, held against the JAX reference.

The CUDA kernel (``tile_permute.cu``) runs only on the card; here its two
schedules are emulated in numpy from the very launch descriptor the host
builds (``_K4aArgs``), mirroring the kernel's index arithmetic (the tile
layouts, the XOR-ordered src0 entries of a 16-byte store, the work items
a block takes), and the result is held bit for bit against the
reference's plain gather (``repro.kernels.ref.bmmc_ref``) on inputs made
with numpy from a seed. The launch path itself runs with the foreign call
routed to that emulator. Tolerance: none, a permutation moves bits.
"""
import ctypes
import random

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.bmmc import Bmmc as RBmmc
from repro.kernels import ref as rref
from repro_torch.core import f2 as pf2
from repro_torch.core import tiling as ptiling
from repro_torch.core.bmmc import Bmmc as PBmmc
from repro_torch.guard import inject as pinject
from repro_torch.kernels import bmmc_permute as pk
from repro_torch.kernels import build as pbuild
from repro_torch.kernels import ops as pops
from repro_torch.models import attention as TA

_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _bmmc(kind, n, rng):
    return {"bitrev": lambda: PBmmc.bit_reverse(n),
            "bpc": lambda: PBmmc.random_bpc(n, rng),
            "bmmc": lambda: PBmmc.random(n, rng),
            "mixed": lambda: PBmmc.xor_shift(n, 3 | (1 << (n - 1))),
            "heads": lambda: TA.default_head_perm(1 << n)}[kind]()


def _words(x: np.ndarray, wb: int, batch: int) -> np.ndarray:
    """``x``'s bytes as ``(batch, words)`` of ``wb`` bytes (16-byte words
    as pairs of 8)."""
    flat = np.ascontiguousarray(x).view(np.uint8).reshape(batch, -1)
    if wb == 16:
        return flat.view(np.uint64).reshape(batch, -1, 2)
    return flat.view(_UINT[wb])


def emulate(a, xw: np.ndarray, tabs) -> np.ndarray:
    """``tile_permute.cu`` under descriptor ``a`` (a ``_K4aArgs``) on
    ``xw``, the input as ``(batch, words)``: every block in turn, each
    output word written exactly once."""
    in_rows, out_rows, xor_low, src0 = (
        np.asarray(v).reshape(-1).astype(np.int64) for v in tabs)
    t, rs_, wpe = a.t, a.rpt_shift, a.wpe
    rpt, row_len = 1 << rs_, 1 << t
    lane = row_len - 1
    out = np.zeros_like(xw)
    seen = np.zeros(xw.shape[:2], np.int64)

    def put(b, at, val):
        out[b, at] = val
        np.add.at(seen[b], at.ravel(), 1)

    if a.schedule == 1:                                    # wide
        epb, bpb = a.per_cta, a.groups
        words = np.arange(wpe)
        for blk in range(a.grid):
            chunk, b0 = blk % a.n_groups, blk // a.n_groups * bpb
            e = chunk * epb + np.arange(epb)
            r, l = e >> t, e & lane
            g, rp = r >> rs_, r & (rpt - 1)
            s = src0[(rp << t) | (l ^ xor_low[g])]
            src = (in_rows[(g << rs_) | (s >> t)] << t) | (s & lane)
            dst = (out_rows[r] << t) | l
            for b in range(b0, min(a.batch, b0 + bpb)):
                put(b, (dst[:, None] * wpe + words).ravel(),
                    xw[b, (src[:, None] * wpe + words).ravel()])
        assert (seen == 1).all()
        return out
    rows = a.per_cta << rs_                                # narrow
    row_words = row_len * wpe
    span = rows * row_words
    cw = max(1, 16 // a.word_bytes)
    cw_shift = cw.bit_length() - 1
    vw = cw if a.vec else 1
    items = 0
    for blk in range(a.grid):
        w0 = blk * a.groups
        for w in range(w0, min(w0 + a.groups, a.n_work)):
            items += 1
            b, grp = divmod(w, a.n_groups)
            rin = in_rows[grp * rows:(grp + 1) * rows]
            rout = out_rows[grp * rows:(grp + 1) * rows]
            xls = xor_low[grp * a.per_cta:(grp + 1) * a.per_cta]
            tile = np.zeros((rows * a.stride,) + xw.shape[2:], xw.dtype)
            hit = np.zeros(rows * a.stride, np.int64)
            li = np.arange(span)
            r, q = li // row_words, li % row_words
            at = r * a.stride + (q ^ ((r & a.swz) << cw_shift))
            tile[at] = xw[b, rin[r] * row_words + q]
            np.add.at(hit, at, 1)
            assert hit.max() == 1                          # no overlap
            li = np.arange(0, span, vw)
            r, rem = li // row_words, li % row_words
            j, rp = r >> rs_, r & (rpt - 1)
            xl = xls[j]
            dst = rout[r] * row_words + rem
            if vw == 1:
                cp, wd = rem // wpe, rem % wpe
                s = src0[(rp << t) | (cp ^ xl)]
                rs = (j << rs_) | (s >> t)
                q = (s & lane) * wpe + wd
                put(b, dst, tile[rs * a.stride + (q ^ ((rs & a.swz)
                                                      << cw_shift))])
            else:
                m = np.arange(vw)
                ents = src0[((rp << t) | (rem ^ (xl & ~(vw - 1))))[:, None]
                            + m]
                sm = np.take_along_axis(ents, m ^ (xl & (vw - 1))[:, None],
                                        axis=1)
                rs = (j[:, None] << rs_) | (sm >> t)
                put(b, dst[:, None] + m, tile[rs * a.stride + (
                    (sm & lane) ^ ((rs & a.swz) << cw_shift))])
    assert items == a.n_work and (seen == 1).all()
    return out


def _payload(shape, dtype, seed):
    """Random bits below bfloat16's NaNs (XLA's CPU gather makes bfloat16
    NaNs canonical), as a numpy array of ``dtype``."""
    raw = np.random.default_rng(seed).integers(0, 1 << 30, size=shape,
                                               dtype=np.int64)
    dt = np.dtype(dtype)
    if dt == np.bool_:
        return (raw & 1).astype(np.bool_)
    if dt.itemsize == 2:
        return (raw & 0x7F00).astype(np.uint16).view(dt)
    return raw.astype(_UINT[dt.itemsize]).view(dt)


def _torch(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype == np.dtype(ml_dtypes.bfloat16):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _want(arr, b: PBmmc, batched: bool) -> np.ndarray:
    got = np.asarray(rref.bmmc_ref(jnp.asarray(arr), RBmmc(b.rows, b.c),
                                   batched=batched))
    return np.ascontiguousarray(got)


def _case(kind, n, t, dtype, d, batch, seed=0):
    b = _bmmc(kind, n, random.Random(seed * 7 + n))
    plan = ptiling.plan_bmmc(b, t)[0]
    shape = (batch, 1 << n) + ((d,) if d > 1 else ())
    return b, plan, _payload(shape, dtype, seed + n + t)


# (kind, n, t, dtype, d, batch): the serving shuffle's geometry (t = 1,
# 128-item bfloat16 elements) and t = 3 int32 and friends
_INDEX_CASES = [
    ("heads", 3, 1, ml_dtypes.bfloat16, 128, 3),
    ("bitrev", 8, 3, np.int32, 1, 2),
    ("bmmc", 8, 3, np.int32, 1, 1),
    ("mixed", 8, 3, np.int32, 1, 1),
    ("bpc", 9, 3, ml_dtypes.bfloat16, 1, 2),
    ("bmmc", 8, 3, np.bool_, 3, 1),
    ("bitrev", 8, 2, np.float32, 4, 1),
]


@pytest.mark.parametrize("kind,n,t,dtype,d,batch", _INDEX_CASES)
@pytest.mark.parametrize("schedule,layout,groups", [
    ("narrow", "unpadded", 1), ("narrow", "padded", 2),
    ("narrow", "swizzled", 3), ("wide", None, None)])
def test_schedule_index_plans_match_the_reference(kind, n, t, dtype, d,
                                                  batch, schedule, layout,
                                                  groups):
    """Each schedule (and each layout of the narrow one, over blocks of 1-3
    work items) moves every word where the reference's plain gather puts
    it, aligned and at a misaligned offset (the narrow widths)."""
    b, plan, arr = _case(kind, n, t, dtype, d, batch)
    want = _want(arr, b, True)
    tabs = pk.device_tables(plan, torch.device("cpu"))
    geometry = pk.plan_geometry(plan)
    itemsize = np.dtype(dtype).itemsize
    for align in (0, itemsize):
        s = pk.k4a_schedule(geometry, batch, d, itemsize, align,
                            schedule=schedule, layout=layout, groups=groups)
        a = pk._k4a_args(s, tabs, geometry, batch)
        got = emulate(a, _words(arr, s.word_bytes, batch), tabs)
        assert np.array_equal(got, _words(want, s.word_bytes, batch)), (
            align, s)


@pytest.mark.parametrize("dtype,d,off", [
    (torch.int32, 1, 0), (torch.int32, 1, 1), (torch.float32, 3, 0),
    (torch.bfloat16, 1, 1), (torch.bfloat16, 128, 0), (torch.bool, 1, 3),
    (torch.complex64, 1, 0), (torch.complex64, 16, 1),
    (torch.float32, 4, 2)])
def test_record_arguments_equal_a_fresh_schedule(monkeypatch, dtype, d, off):
    """The record built for a tensor holds the descriptor a schedule
    computed from scratch gives for its geometry, dtype, tail and
    alignment (an offset changes the word width)."""
    monkeypatch.setattr(pbuild, "load", lambda name: None)
    n, t = 8, 3
    plan = ptiling.plan_bmmc(PBmmc.random(n, random.Random(3)), t)[0]
    geometry = pk.plan_geometry(plan)
    base = torch.zeros((2 << n) * d + 8, dtype=dtype)
    x = base[off:off + (2 << n) * d].reshape((2, 1 << n) + ((d,) if d > 1
                                                            else ()))
    tabs = pk.device_tables(plan, x.device)
    out_ptr = 1 << 20                      # a fresh allocation's alignment
    rec = pk._new_record(x, plan, tabs, True, x.data_ptr() | out_ptr)
    elem = d * x.element_size()
    align = x.data_ptr() | tabs[3].data_ptr()
    fresh = pk._k4a_schedule.__wrapped__(geometry, 2, d, x.element_size(),
                                         align & 15, None, None, None)
    assert rec.schedule == fresh
    assert fresh.word_bytes == pk._word_bytes(elem, x.data_ptr(), out_ptr)
    assert fresh.schedule == ("wide" if elem >= pk._WIDE_ELEM_BYTES
                              else "narrow")
    want = pk._k4a_args(fresh, tabs, geometry, 2)
    assert bytes(rec.args) == bytes(want)
    assert [getattr(rec.args, k) for k in ("in_rows", "out_rows", "xor_low",
                                           "src0")] == [
        a.data_ptr() for a in tabs]
    assert (rec.args.n_rows, rec.args.t, rec.args.batch) == (1 << (n - t), t,
                                                             2)
    assert ctypes.sizeof(pk._K4aArgs) == 4 * 8 + 2 * 8 + 17 * 4 + 4


@pytest.mark.parametrize("dtype,d,want", [
    (np.int32, 1, "narrow"), (np.float32, 8, "narrow"),
    (ml_dtypes.bfloat16, 16, "narrow"), (ml_dtypes.bfloat16, 32, "wide"),
    (np.float32, 32, "wide"),
    (ml_dtypes.bfloat16, 128, "wide"), (ml_dtypes.bfloat16, 512, "wide"),
    (np.float32, 512, "wide"), (np.complex64, 16, "wide"),
    (np.bool_, 3, "narrow")])
def test_schedule_chooser_follows_the_element_width(dtype, d, want):
    """Wide from elements of 64 bytes, narrow below; 16-byte copies only
    where the pointers and the rows allow them."""
    plan = ptiling.plan_bmmc(PBmmc.bit_reverse(8), 2)[0]
    itemsize = np.dtype(dtype).itemsize
    s = pk.k4a_schedule(pk.plan_geometry(plan), 4, d, itemsize)
    assert s.schedule == want
    if want == "narrow":
        elem = itemsize * d
        assert s.vec == int((4 * elem) % 16 == 0 and (
            16 % elem == 0 or elem % 16 == 0))
        assert pk.k4a_schedule(pk.plan_geometry(plan), 4, d, itemsize,
                               align=4).vec == 0
        assert s.smem <= pk._SMEM_MAX
    # the serving shapes go wide, the paper's size narrow
    hp = TA.default_head_perm(8)
    geo = pk.plan_geometry(pops.class_plan(hp, 1)[1][0])
    assert pk.k4a_schedule(geo, 2048, 128, 2).schedule == "wide"
    assert pk.k4a_schedule(geo, 2048, 128, 2).grid == 256


def _stub_launch(monkeypatch, calls):
    """Route K4a's foreign call to :func:`emulate` on the tensors' memory
    (the CPU has no card: the current device reads as a CPU tensor's
    index, the stream as 0)."""
    def fn(xp, op, ref, stream):
        a = pk._K4aArgs.from_address(ref)
        n_rows, rpt = a.n_rows, 1 << a.rpt_shift
        words = (n_rows << a.t) * a.wpe
        wb = a.word_bytes

        def ints(p, k):
            return np.ctypeslib.as_array((ctypes.c_int32 * k).from_address(p))
        tabs = (ints(a.in_rows, n_rows), ints(a.out_rows, n_rows),
                ints(a.xor_low, n_rows // rpt), ints(a.src0, rpt << a.t))

        def mem(p):
            raw = np.ctypeslib.as_array((ctypes.c_uint8 * (
                a.batch * words * wb)).from_address(p))
            return _words(raw, wb, a.batch)
        mem(op)[...] = emulate(a, mem(xp), tabs)
        calls.append((xp, op, ref, stream))
        return 0
    monkeypatch.setattr(pbuild, "load", lambda name: fn)
    for name, stub in (("_cuda_getDevice", lambda: None),
                       ("_cuda_getCurrentRawStream", lambda d: 0),
                       ("_cuda_isCurrentStreamCapturing", lambda: False)):
        monkeypatch.setattr(torch._C, name, stub, raising=False)


def test_launch_path_counts_once_and_matches_the_reference(monkeypatch):
    """The record path (``_k4a_call``, what ``tiled_permute`` runs on a
    CUDA tensor) launches once per call, counted under ``tile`` and its
    schedule, builds one record per shape, dtype and alignment, and its
    descriptor moves the data as the reference does."""
    calls = []
    _stub_launch(monkeypatch, calls)
    pk.clear_device_tables()
    for kind, n, t, dtype, d, batch in _INDEX_CASES[:3]:
        b, plan, arr = _case(kind, n, t, dtype, d, batch, seed=5)
        want = _want(arr, b, True)
        x = _torch(arr)
        for k in range(2):
            before = pk.launch_counts()
            got = pk._k4a_call(x, plan, True)
            after = pk.launch_counts()
            path = ("tile_wide" if d * arr.itemsize >= pk._WIDE_ELEM_BYTES
                    else "tile_narrow")
            assert after["tile"] == before["tile"] + 1
            assert after[path] == before[path] + 1
            assert sum(after.values()) == sum(before.values()) + 2
            assert np.array_equal(_words(got.view(torch.uint8).numpy(), 1,
                                         batch),
                                  _words(want, 1, batch)), (kind, k)
        tabs = pk.device_tables(plan, x.device)
        assert len(tabs.launch) == 1
        assert calls[-1][2] == next(iter(tabs.launch.values())).ref
    assert len(calls) == 6
    with pytest.raises(NotImplementedError):
        pk._k4a_call(torch.zeros(256, requires_grad=True), plan, False)
    with pytest.raises(ValueError, match="contiguous"):
        pk._k4a_call(torch.zeros(512, dtype=torch.int32)[::2],
                     ptiling.plan_bmmc(PBmmc.bit_reverse(8), 3)[0], False)


def test_record_lives_with_the_device_tables(monkeypatch):
    """The record is kept in the tables' entry of the device store: a pin
    holds it, ``clear_device_tables`` and a ``poison_plan`` enter and exit
    drop it, and it reads the very tensors ``device_tables`` returns."""
    _stub_launch(monkeypatch, [])
    b = PBmmc.random(8, random.Random(11))
    pk.clear_device_tables()
    plan = pops.class_plan(b, 3)[1][0]
    x = torch.arange(256, dtype=torch.int32)
    with pk.pin_device_tables() as pinned:
        rec = pk.k4a_record(x, plan)
    tabs = pk.device_tables(plan, x.device)
    assert rec in tabs.launch.values()
    assert any(v is tabs for _, v in pinned.values())
    assert [getattr(rec.args, k) for k in ("in_rows", "out_rows", "xor_low",
                                           "src0")] == [
        a.data_ptr() for a in tabs]
    pk.clear_device_tables()
    assert pk.k4a_record(x, plan) is not rec
    # the pin still holds the tables it saw, and their record
    assert rec in next(v for _, v in pinned.values()).launch.values()
    rec2 = pk.k4a_record(x, plan)
    with pinject.poison_plan(b, 3):
        assert pk.device_copies(plan, "tables") == {}
        rec3 = pk.k4a_record(x, plan)
        assert rec3 is not rec2
        assert int(pk.device_tables(plan, x.device)[3].reshape(-1)[0]) == (
            plan.rows_per_tile * plan.row_len + 7)
    assert pk.k4a_record(x, plan) not in (rec2, rec3)
    assert pk.device_copies(plan, "tables")["cpu"].launch


def test_bmmc_inverse_and_identity_are_kept_and_unchanged():
    """``Bmmc.inverse`` and ``is_identity_perm`` are computed once per
    instance; the kept values are what a fresh computation gives, and the
    head shuffle's attention output is unchanged by it."""
    rng = random.Random(19)
    for n in (3, 8, 30):
        b = PBmmc.random(n, rng)
        ainv = pf2.inverse(b.rows)
        assert b.inverse() == PBmmc(ainv, pf2.matvec(ainv, b.c))
        assert b.inverse() is b.inverse() and b.inverse().inverse() is b
        assert b.is_identity_perm() is (b.rows == pf2.identity(n)
                                        and b.c == 0)
        assert PBmmc.identity(n).is_identity_perm()
        assert not PBmmc.xor_shift(n, 1).is_identity_perm()
        assert b == PBmmc(b.rows, b.c) and hash(b) == hash(PBmmc(b.rows,
                                                                  b.c))
    x = torch.arange(1 << 8, dtype=torch.int32)
    ident = PBmmc.identity(8)
    assert pops.bmmc_permute(x, ident) is x
    gen = np.random.default_rng(2)
    q = torch.from_numpy(gen.standard_normal((2, 4, 8, 8), np.float32))
    k, v = (torch.from_numpy(gen.standard_normal((2, 4, 8, 8), np.float32))
            for _ in range(2))
    hp = TA.default_head_perm(8)
    plain = TA.attention(q, k, v, kv_block=4)
    for engine in ("cuda", "ref"):
        got = TA.attention(q, k, v, kv_block=4, head_perm=hp,
                           head_perm_engine=engine)
        assert torch.equal(got, plain), engine
        dec = TA.decode_attention(q[:, -1:], k, v, 4, head_perm=hp,
                                  head_perm_engine=engine)
        assert torch.equal(dec, TA.decode_attention(q[:, -1:], k, v, 4))


def test_choose_tile_is_kept_and_unchanged():
    """``choose_tile`` answers from a cache what the loop computes."""
    def loop(n, itemsize, d):
        t = 12
        while t > 1 and (1 << (2 * t)) * itemsize * d > 16 * 1024:
            t -= 1
        t = min(t, n // 2)
        return t if t >= 1 else None
    for n in (1, 3, 8, 24, 30):
        for itemsize, d in ((1, 1), (2, 128), (4, 1), (4, 8), (8, 512)):
            assert pops.choose_tile(n, itemsize, d) == loop(n, itemsize, d)
            assert pops.choose_tile(n, itemsize, d, 2) == (
                2 if 4 <= n else None)


def test_launch_path_remembers_tables_only_while_the_store_keeps_them(
        monkeypatch):
    """The launch path's remembered table lookup answers while the device
    store has dropped nothing; a clear or an eviction forgets it (no
    dropped table stays alive through it), and a pin goes to the store."""
    _stub_launch(monkeypatch, [])
    dev = torch.device("cpu")
    plans = [ptiling.plan_bmmc(PBmmc.random(8, random.Random(k)), 3)[0]
             for k in range(3)]
    pk.clear_device_tables()
    tabs = pk._launch_tables(plans[0], dev)
    assert pk._launch_tables(plans[0], dev) is tabs
    assert tabs is pk.device_tables(plans[0], dev)
    pk.clear_device_tables()
    assert pk._HOT == {}
    fresh = pk._launch_tables(plans[0], dev)
    assert fresh is not tabs and fresh is pk.device_tables(plans[0], dev)
    with pk.pin_device_tables() as pinned:
        assert pk._launch_tables(plans[0], dev) is fresh
        assert any(v is fresh for _, v in pinned.values())
    # an eviction: a store that holds one plan's tables at a time
    size = pk._DeviceCache._size(fresh)
    small = pk._DeviceCache(max_bytes=size + size // 2)
    small.on_drop = pk._HOT.clear
    monkeypatch.setattr(pk, "_DEV_CACHE", small)
    a = pk._launch_tables(plans[1], dev)
    assert pk._launch_tables(plans[1], dev) is a
    pk._launch_tables(plans[2], dev)          # evicts plans[1]'s tables
    assert set(pk._HOT) == {(id(plans[2]), None)}
    assert pk._launch_tables(plans[1], dev) is not a
    pk._HOT.clear()     # nothing remembered from the test's own store
