"""The durable plan store of the PyTorch port (``repro_torch.store``) held
against the JAX reference (``repro.store``) on the CPU.

* The ring-1 fingerprint (``guard.validate._fp_array``,
  ``plan_fingerprint``) equals the reference's on the same arrays.
* The codec round-trips: a class plan or a fused plan encoded and decoded
  again equals, table for table, the reference's freshly built plan at
  equal ``(n, t)``.
* Ring 1 re-runs on load: a well-formed entry holding a wrong plan is
  quarantined and replanned, never trusted.
* The disk-fault matrix catches every kind with the reference's verdicts.
* Entries of the two packages never answer for each other: different
  keys (``cuda`` / ``sm_90``), and each codec reads the other's bytes as
  a version skew (a miss).
* A warm process replans nothing; racing readers quarantine once; an
  unplannable cluster is stored as a negative entry.

Inputs are made with numpy from a seed and handed to both packages.
"""
import os
import threading

import numpy as np
import pytest
import torch

import repro.combinators as rc
from repro import store as rstore
from repro.combinators import execute as rex
from repro.combinators.sort import sort_expr as r_sort_expr
from repro.core.bmmc import Bmmc as RBmmc
from repro.guard import inject as rinject
from repro.guard import validate as rv
from repro.kernels import ops as rops
import repro_torch.combinators as pc
from repro_torch import store as pstore
from repro_torch.combinators import execute as pex
from repro_torch.combinators import vocab as PV
from repro_torch.combinators.sort import sort_expr as p_sort_expr
from repro_torch.core.bmmc import Bmmc as PBmmc
from repro_torch.guard import inject as pinject
from repro_torch.guard import validate as pv
from repro_torch.kernels import ops as pops
from repro_torch.store import codec as pcodec


@pytest.fixture(autouse=True)
def _clean(tmp_path):
    """Every test starts and ends with no store and cold caches in both
    packages."""
    pstore.configure(None)
    rstore.configure(None)
    pex.clear_caches()
    rstore.reset_stats()
    rops._class_plan_cached.cache_clear()
    yield
    pstore.configure(None)
    rstore.configure(None)
    pex.clear_caches()


def _cases(n: int, t: int):
    """(name, reference BMMC, port BMMC) of each class-dispatch kernel."""
    rng = np.random.default_rng(1701)
    out = [("tiled", RBmmc.bit_reverse(n), PBmmc.bit_reverse(n))]
    rows = [1 << i for i in range(n)]
    # block class: the low t bits fixed, a random invertible map above
    hi = list(rows[t:])
    rng.shuffle(hi)
    out.append(("block", RBmmc(tuple(rows[:t] + hi), 0),
                PBmmc(tuple(rows[:t] + hi), 0)))
    lo = list(rows[:t])
    rng.shuffle(lo)
    out.append(("lane", RBmmc(tuple(lo + rows[t:]), 3),
                PBmmc(tuple(lo + rows[t:]), 3)))
    import random
    rb = RBmmc.random(n, random.Random(7))
    out.append(("general", rb, PBmmc(rb.rows, rb.c)))
    return out


def _tables(kernel, payload):
    if kernel == "block":
        return [payload.src_rows]
    if kernel == "lane":
        return [payload.src_lane]
    return [a for p in payload
            for a in (p.in_rows, p.out_rows, p.xor_low, p.src0)]


@pytest.mark.parametrize("size", [0, 1, 1000, (1 << 22) + 5])
def test_fingerprint_equals_the_reference(size):
    a = np.random.default_rng(size).integers(-2**31, 2**31 - 1, size,
                                              dtype=np.int64).astype(np.int32)
    assert pv._fp_array(a) == rv._fp_array(a)
    assert pv._fp_array(torch.from_numpy(a)) == rv._fp_array(a)
    if size > 1:
        b = a.copy()
        b[0], b[-1] = a[-1], a[0]
        assert a[0] == a[-1] or pv._fp_array(b) != pv._fp_array(a)


@pytest.mark.parametrize("n,t", [(10, 3), (12, 4)])
def test_codec_roundtrips_class_plans_equal_to_the_reference(n, t):
    for name, rb, pb in _cases(n, t):
        fresh = pops._build_class_plan(pb.rows, pb.c, t)
        want = rops._build_class_plan(rb.rows, rb.c, t)
        assert fresh[0] == want[0]
        meta, arrays = pcodec.encode_class_payload(*fresh)
        key = pcodec.class_key(pb.rows, pb.c, t)
        raw = pcodec.encode_entry(key, "class", meta, arrays)
        header, got_arrays = pcodec.decode_entry(raw, key)
        kernel, payload = pcodec.decode_class_payload(header["meta"],
                                                      got_arrays)
        assert kernel == want[0], name
        for a, b in zip(_tables(kernel, payload), _tables(*want)):
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        assert pv.plan_fingerprint(kernel, payload) == rv.plan_fingerprint(
            *want)


def test_codec_roundtrips_fused_plans_equal_to_the_reference():
    n, t = 8, 3
    rp = rc.compile_expr(r_sort_expr(n), engine="pallas"
                         ).clustered_program(n, t)
    pp = pc.compile_expr(p_sort_expr(n), engine="cuda"
                         ).clustered_program(n, t)
    rf = [s for s in rp if isinstance(s, rc.FusedStage) and s.computes]
    pf = [s for s in pp if isinstance(s, pc.FusedStage) and s.computes]
    assert len(rf) == len(pf) > 0
    for rs, ps in zip(rf, pf):
        plans, entries = pex._build_fused_plan(ps, t)
        meta, arrays = pcodec.encode_fused_payload(plans, entries)
        key = pcodec.fused_key(ps, t)
        header, got = pcodec.decode_entry(
            pcodec.encode_entry(key, "fused", meta, arrays), key)
        dplans, dentries = pcodec.decode_fused_payload(header["meta"], got,
                                                       ps.computes)
        wplans, wentries = rex._fused_plan_cached(rs, t)
        assert len(dplans) == len(wplans)
        for a, b in zip(dplans, wplans):
            for x, y in zip((a.in_rows, a.out_rows, a.xor_low, a.src0),
                            (b.in_rows, b.out_rows, b.xor_low, b.src0)):
                assert np.array_equal(x, y)
        for de, we in zip(dentries, wentries):
            assert de[0] == we[0]
            for f in pcodec._CT_FIELDS:
                x, y = getattr(de[2], f), getattr(we[2], f)
                assert (x is None) == (y is None)
                assert x is None or np.array_equal(x, y)


def test_store_backed_plans_equal_fresh_and_warm_boot_builds_none(tmp_path):
    pstore.configure(str(tmp_path))
    n = 10
    x = torch.from_numpy(np.random.default_rng(3).permutation(
        1 << n).astype(np.int32))
    f = pc.compile_expr(p_sort_expr(n))
    y = f(x)
    cold = pstore.stats()
    assert cold["plan_built"] > 0 and cold["write"] == cold["plan_built"]
    assert pex.cache_stats()["store"].currsize == cold["write"]
    pex.clear_caches()            # a fresh process: only the disk is warm
    y2 = f(x)
    warm = pstore.stats()
    assert warm["plan_built"] == 0 and warm["miss"] == 0
    assert warm["hit"] == cold["plan_built"]
    assert torch.equal(y, y2) and torch.equal(y, torch.sort(x).values)


def test_ring1_reruns_on_load_and_refuses_a_wrong_plan(tmp_path):
    st = pstore.configure(str(tmp_path))
    n, t = 10, 3
    b = PBmmc.bit_reverse(n)
    kernel, payload = pops._build_class_plan(b.rows, b.c, t)
    src0 = payload[0].src0.copy()
    flat = src0.reshape(-1)
    flat[0], flat[-1] = flat[-1], flat[0]   # in range, wrong routing
    import dataclasses
    bad = (dataclasses.replace(payload[0], src0=src0),)
    key = pstore.class_key(b.rows, b.c, t)
    meta, arrays = pcodec.encode_class_payload(kernel, bad)
    assert st.put(key, "class", meta, arrays)   # a well-formed entry
    got = pops.class_plan(b, t)
    s = pstore.stats()
    assert s["quarantined"] == 1 and s["hit"] == 0 and s["plan_built"] == 1
    assert np.array_equal(got[1][0].src0, payload[0].src0)
    from repro_torch import guard
    assert guard.stats()["store_quarantined"] == {"audit": 1}


def _verdicts(report):
    return [(c["kind"], c["caught"], c["how"]) for c in report["cases"]]


def test_disk_fault_matrix_equals_the_reference():
    got = pinject.run_disk_fault_matrix(n=6, device="cpu")
    want = rinject.run_disk_fault_matrix(n=6)
    assert got["injected"] == got["caught"] == 5
    assert _verdicts(got) == _verdicts(want)
    assert [c["kind"] for c in got["cases"]] == list(
        pinject.STORE_FAULT_KINDS)


def test_entries_never_answer_for_the_other_package(tmp_path):
    n, t = 8, 3
    rb, pb = RBmmc.bit_reverse(n), PBmmc.bit_reverse(n)
    pkey, rkey = (pcodec.class_key(pb.rows, pb.c, t),
                  rstore.class_key(rb.rows, rb.c, t))
    assert pkey != rkey and "|cuda|sm_90|" in pkey
    assert pcodec.CODE_VERSION != rstore.CODE_VERSION
    pmeta, parr = pcodec.encode_class_payload(
        *pops._build_class_plan(pb.rows, pb.c, t))
    rmeta, rarr = rstore.codec.encode_class_payload(
        *rops._build_class_plan(rb.rows, rb.c, t))
    pbytes = pcodec.encode_entry(pkey, "class", pmeta, parr)
    rbytes = rstore.codec.encode_entry(rkey, "class", rmeta, rarr)
    with pytest.raises(rstore.EntrySkew):
        rstore.codec.decode_entry(pbytes)
    with pytest.raises(pstore.EntrySkew):
        pcodec.decode_entry(rbytes)
    # one root shared by both packages: each sees only its own entries
    pst, rst = pstore.configure(str(tmp_path)), rstore.configure(
        str(tmp_path))
    assert pst.write_bytes(pkey, pbytes) and rst.write_bytes(rkey, rbytes)
    assert pops.class_plan(pb, t)[0] == "tiled"
    assert rops.class_plan(rb, t)[0] == "tiled"
    assert pstore.stats()["hit"] == 1 and rstore.stats()["hit"] == 1
    # the reference's entry at the port's path is a skew miss, not a hit
    pex.clear_caches()
    assert pst.write_bytes(pkey, rbytes)
    pops.class_plan(pb, t)
    s = pstore.stats()
    assert s["hit"] == 0 and s["version_skew"] == 1 and s["quarantined"] == 0


def test_quarantine_race_resolves_once(tmp_path):
    st = pstore.configure(str(tmp_path))
    n, t = 8, 3
    b = PBmmc.bit_reverse(n)
    pops.class_plan(b, t)
    key = pstore.class_key(b.rows, b.c, t)
    base = pstore.stats()
    with pinject.corrupt_store_entry(st, key, "bitflip"):
        pex.clear_caches()
        results = []
        threads = [threading.Thread(target=lambda: results.append(
            pstore.class_plan_through(b.rows, b.c, t, lambda: (
                pops._build_class_plan(b.rows, b.c, t)))))
            for _ in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    assert len(results) == 4
    assert pstore.stats()["quarantined"] - base["quarantined"] == 1
    assert st.quarantined_count() == 1
    fp = pv.plan_fingerprint(*pops._build_class_plan(b.rows, b.c, t))
    assert all(pv.plan_fingerprint(*r) == fp for r in results)


def test_fused_negative_entry_and_tmp_sweep(tmp_path):
    st = pstore.configure(str(tmp_path))
    n, t = 8, 3
    fs = next(s for s in pc.compile_expr(p_sort_expr(n)).clustered_program(
        n, t) if isinstance(s, pc.FusedStage) and s.computes)
    calls = []
    assert pstore.fused_plan_through(fs, 1, lambda: calls.append(1)) is None
    assert pstore.fused_plan_through(fs, 1, lambda: calls.append(1)) is None
    assert calls == [1]      # the negative entry answered the second time
    orphan = os.path.join(st.tmp_dir, "999999.0.tmp")
    with open(orphan, "wb") as f:
        f.write(b"x")
    assert st.sweep_tmp() == 1 and not os.path.exists(orphan)


def test_version_skew_is_a_miss_then_heals(tmp_path):
    st = pstore.configure(str(tmp_path))
    b = PBmmc.bit_reverse(8)
    pops.class_plan(b, 3)
    key = pstore.class_key(b.rows, b.c, 3)
    st.write_bytes(key, pinject._skewed_entry(st.read_bytes(key)))
    pex.clear_caches()
    pops.class_plan(b, 3)
    s = pstore.stats()
    assert s["version_skew"] == 1 and s["quarantined"] == 0
    assert s["write"] == 1      # the rebuild overwrote the skewed entry
    pex.clear_caches()
    pops.class_plan(b, 3)
    assert pstore.stats()["hit"] == 1


def test_store_root_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_STORE", str(tmp_path))
    monkeypatch.setattr(pstore, "_configured", False)
    st = pstore.active()
    assert st is not None and st.root == str(tmp_path)
    monkeypatch.setenv("REPRO_STORE", "0")
    monkeypatch.setattr(pstore, "_configured", False)
    assert pstore.active() is None
    f = pc.compile_expr(PV.bit_reverse(8))
    f(torch.arange(256.0))
    assert pstore.stats()["write"] == 0
