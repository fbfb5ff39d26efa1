"""Ring 3 — fault injection (test time): the counterpart of
:mod:`repro.guard.inject`.

Each injector deliberately corrupts ONE layer of the stack the way a
real defect would — a flipped bit in a matrix row, a swapped pair of
descriptor entries, a plan table mutated in place, a truncated parity
table, a malformed input, a damaged plan-store entry — and restores the
original state on exit. The harness (:func:`run_fault_matrix`) drives
every corruption class against a guarded engine and reports, per fault,
whether the stack *caught* it: a typed :class:`~.errors.GuardError`, or
a recovered engine fallback whose result still bitwise-matches the
oracle. A fault that produces a silently wrong output is the one
outcome the suite must never see.

What the card reads: a kernel reads its tables from the copies
:func:`repro_torch.kernels.bmmc_permute.device_tables` uploaded once, and
a captured CUDA graph reads the copies it pinned. So an injector that
mutates a host table (:func:`poison_plan`, :func:`poison_ref_table`)
also drops the device copies and every executable, on entry and on
exit (:func:`_clear_runtime_only`): the next call uploads the poisoned
table, and after the restore the clean one. :func:`poison_device_table`
poisons one kernel's device copy itself. Ring-1 signatures stay warm, so
both model corruption that lands *after* validation.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core.bmmc import Bmmc
from .errors import GuardError

STORE_FAULT_KINDS = ("disk_truncate", "disk_bitflip", "disk_version_skew",
                     "disk_torn_write", "disk_quarantine_race")

FAULT_KINDS = ("bitflip_bmmc", "swap_descriptor", "poison_cache",
               "truncate_parity_table", "bad_input") + STORE_FAULT_KINDS


def corrupt_bmmc(bmmc: Bmmc) -> Bmmc:
    """A copy of ``bmmc`` that is singular over F2 (row 1 overwritten by
    row 0), built WITHOUT running ``__post_init__`` — modeling a matrix
    corrupted after construction."""
    rows = list(bmmc.rows)
    rows[1] = rows[0]            # two equal rows: rank < n
    bad = Bmmc.__new__(Bmmc)
    object.__setattr__(bad, "rows", tuple(rows))
    object.__setattr__(bad, "c", bmmc.c)
    return bad


def _payload_tables(kernel: str, payload) -> list:
    """The in-place-mutable numpy tables of one class-dispatch payload,
    with their exclusive index bounds."""
    if kernel == "block":
        return [(payload.src_rows, payload.n_rows)]
    if kernel == "lane":
        return [(payload.src_lane, 1 << payload.t)]
    if kernel == "none":
        return []
    return [(plan.src0, plan.rows_per_tile * plan.row_len)
            for plan in payload]


def _cached_tables(bmmc: Bmmc, t: int) -> list:
    from ..kernels import ops

    kernel, payload = ops.class_plan(bmmc, t)
    tables = _payload_tables(kernel, payload)
    if not tables:
        raise ValueError(f"kernel {kernel!r} has no table to corrupt")
    return tables


@contextlib.contextmanager
def swap_descriptors(bmmc: Bmmc, t: int):
    """Swap the first and last entry of the cached plan's main gather
    table IN PLACE (stays in-bounds: only the semantic audit or the
    runtime parity probe can see it). Restores on exit."""
    tab, _ = _cached_tables(bmmc, t)[0]
    flat = tab.reshape(-1)
    a, b = int(flat[0]), int(flat[-1])
    if a == b:
        raise ValueError("degenerate table: swap would be a no-op")
    flat[0], flat[-1] = b, a
    try:
        yield tab
    finally:
        flat[0], flat[-1] = a, b


@contextlib.contextmanager
def poison_plan(bmmc: Bmmc, t: int):
    """Overwrite one cached descriptor with an out-of-range index — the
    corruption the guarded kernels' bound test exists for — and drop the
    device copies and executables so the card reads it. Restores (and
    drops them again) on exit."""
    tab, bound = _cached_tables(bmmc, t)[0]
    flat = tab.reshape(-1)
    orig = int(flat[0])
    flat[0] = bound + 7
    _clear_runtime_only()
    try:
        yield tab
    finally:
        flat[0] = orig
        _clear_runtime_only()


@contextlib.contextmanager
def poison_ref_table(bmmc: Bmmc):
    """Overwrite one entry of the ref engine's cached gather table with
    an out-of-range index (the ref twin of :func:`poison_plan`), dropping
    its device copy on entry and on exit. Restores on exit."""
    from ..kernels import ref as _ref

    tab = _ref._src_table(bmmc.rows, bmmc.c)
    orig = int(tab[0])
    tab[0] = bmmc.size + 7
    _clear_runtime_only()
    try:
        yield tab
    finally:
        tab[0] = orig
        _clear_runtime_only()


@contextlib.contextmanager
def poison_device_table(plan, device, index: int = 0, table: int = -1,
                        value: int = 1 << 30):
    """Overwrite entry ``index`` of one table of ``plan``'s copies on
    ``device`` — the tables the kernel reads — with ``value``, an index out
    of range (the default lies past every table's range for n <= 30;
    ``table``: the position in the plan's table tuple, default its last:
    ``src0`` of a tile plan). The host table stays clean, so only the
    card sees the fault. Restores the entry on exit, and drops the
    executables on entry and exit (a graph pinned the old copies)."""
    from ..kernels import bmmc_permute as K

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        # the copies are kept per device as a tensor names it: cuda:<i>
        dev = torch.device("cuda", torch.cuda.current_device())
    tabs = K.device_tables(plan, dev)
    tab = tabs[table].reshape(-1)
    orig = tab[index].clone()
    tab[index] = value
    _clear_executables()
    try:
        yield tabs[table]
    finally:
        tab[index] = orig
        _clear_executables()


@contextlib.contextmanager
def truncate_parity_table(fs, t: int):
    """Truncate a fused epilogue's per-lane parity table to half length
    through the frozen dataclass — ring 1's shape audit must refuse the
    plan. ``fs`` is a compute-bearing FusedStage."""
    from ..combinators import execute as _ex

    got = _ex._fused_plan_cached(fs, t)
    if got is None:
        raise ValueError("cluster has no fused plan at this t")
    entries = got[1]
    cts = [e[2] for e in entries if e[0] in ("cmp", "bfly")]
    if not cts:
        raise ValueError("cluster has no parity-table-bearing epilogue")
    ct = cts[0]
    orig = ct.hi_lane
    object.__setattr__(ct, "hi_lane", np.ascontiguousarray(
        orig[:max(1, orig.size // 2)]))
    try:
        yield ct
    finally:
        object.__setattr__(ct, "hi_lane", orig)


# ---------------------------------------------------------------------------
# disk faults (the durable plan store)
# ---------------------------------------------------------------------------

def _skewed_entry(data: bytes) -> bytes:
    """Re-sign ``data``'s header with a bumped schema version — an
    *intact* entry from a different planner generation, the one fault
    class that must read as a miss, never a quarantine."""
    import json
    import struct

    from ..store import codec as _codec

    hlen, _ = struct.unpack_from(_codec._HEADER_FMT, data, len(_codec.MAGIC))
    hj = data[_codec._PREFIX_LEN:_codec._PREFIX_LEN + hlen]
    header = json.loads(hj)
    header["schema"] = header["schema"] + 1
    hj2 = json.dumps(header, sort_keys=True).encode("utf-8")
    return b"".join((
        _codec.MAGIC,
        struct.pack(_codec._HEADER_FMT, len(hj2), _codec._fp_bytes(hj2)),
        hj2, data[_codec._PREFIX_LEN + hlen:]))


@contextlib.contextmanager
def corrupt_store_entry(st, key: str, mode: str):
    """Corrupt one on-disk entry the way a real disk fault would:
    ``truncate`` (short file), ``bitflip`` (one payload bit), ``skew``
    (intact entry, older schema), ``torn`` (a partial write that landed
    at the final path — what the tmp+fsync+rename protocol prevents the
    store itself from ever producing). The CLEAN bytes are written back
    on exit, whether or not the corrupt entry was quarantined and
    rebuilt in between."""
    path = st.path_for(key)
    with open(path, "rb") as f:
        clean = f.read()
    if mode == "truncate":
        bad = clean[:max(1, len(clean) // 3)]
    elif mode == "bitflip":
        flipped = clean[-1] ^ 0x10            # last payload byte
        bad = clean[:-1] + bytes([flipped])
    elif mode == "skew":
        bad = _skewed_entry(clean)
    elif mode == "torn":
        bad = clean[:len(clean) // 2][:200]   # torn mid-header
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    with open(path, "wb") as f:
        f.write(bad)
    try:
        yield path
    finally:
        st.write_bytes(key, clean)


def _clear_executables():
    """Drop the guarded executables and the unguarded CUDA graphs (a
    graph reads the tables it pinned at capture)."""
    from ..combinators import execute as _ex
    from . import runtime as _rt

    _rt.clear_executables()
    _ex._program_executable.cache_clear()


def _clear_runtime_only():
    """Keep ring-1 signatures warm but drop every device copy of a table
    and every executable, so the next call uploads what the host tables
    hold now — modeling corruption that lands AFTER validation."""
    from ..kernels import bmmc_permute as K

    _clear_executables()
    K.clear_device_tables()


def _clear_replan_path():
    """Clear every in-process cache between a disk corruption and the
    next call, so the executor's next plan lookup genuinely reaches the
    store: plan lrus, device tables and executables, and the guard
    caches (ring 1 re-proves on the reload)."""
    from ..combinators import execute as _ex
    from ..kernels import ops

    ops._class_plan_cached.cache_clear()
    ops._plans_cached.cache_clear()
    _ex._fused_plan_cached.cache_clear()
    _ex._fused_bwd_kernel_plan.cache_clear()
    _clear_runtime_only()
    _fresh_guard_state()


def _fresh_guard_state():
    """Clear every cache a fault could hide behind: guard validation +
    guarded executables (so ring 1 re-proves), and the resilience breaker
    board (a test's traps must not leave a condemned engine behind for
    the next test)."""
    from .. import resilience
    from . import validate as _v

    _v.clear_guard_caches()
    resilience.board().reset()


def _setup(n: int, device):
    from ..kernels import ops, ref as _ref

    x = torch.arange(1 << n, dtype=torch.float32, device=device)
    bmmc = Bmmc.bit_reverse(n)
    t = ops.choose_tile(n, 4)
    return x, bmmc, t, _ref.bmmc_ref(x, bmmc)


def _same(y, oracle) -> bool:
    return torch.equal(y.view(torch.int32), oracle.view(torch.int32))


def run_disk_fault_matrix(n: int = 6, device="cuda") -> dict:
    """Inject every disk-fault class against a store-backed cuda engine
    on ``device`` and report ``{injected, caught, cases}`` in the
    :func:`run_fault_matrix` vocabulary. A fault is caught when the
    degradation ladder holds: the corruption is *detected* (quarantine,
    or a version-skew miss), the call recovers bitwise-equal to fresh
    planning, and a racing quarantine resolves exactly once. Always
    drives the cuda engine — the store holds kernel plans; the ref engine
    never consults it."""
    import tempfile
    import threading

    from .. import store as _store
    from ..combinators import vocab as V
    from ..combinators.execute import compile_expr
    from ..kernels import ops

    x, bmmc, t, oracle = _setup(n, device)
    cases = []

    def record(kind, caught, how):
        cases.append({"kind": kind, "caught": bool(caught), "how": how})

    prev = _store.active()
    root = tempfile.mkdtemp(prefix="repro-torch-store-fault-")
    try:
        st = _store.configure(root)
        _clear_replan_path()
        ce = compile_expr(V.bit_reverse(n), engine="cuda", optimize=False)
        ce(x)  # populate the store
        key = _store.class_key(bmmc.rows, bmmc.c, t)
        if _store.active().read_bytes(key) is None:
            raise RuntimeError("store population failed: no entry for key")

        for kind, mode in (("disk_truncate", "truncate"),
                           ("disk_bitflip", "bitflip"),
                           ("disk_version_skew", "skew"),
                           ("disk_torn_write", "torn")):
            base = _store.stats()
            try:
                with corrupt_store_entry(st, key, mode):
                    _clear_replan_path()
                    y = ce(x)
                now = _store.stats()
                ok = _same(y, oracle)
                if mode == "skew":
                    detected = (now["version_skew"] > base["version_skew"]
                                and now["quarantined"] == base["quarantined"])
                    hownote = "skew-miss + replanned"
                else:
                    detected = now["quarantined"] > base["quarantined"]
                    hownote = "quarantined + replanned"
                record(kind, ok and detected,
                       hownote if ok and detected
                       else ("not detected" if ok
                             else "SILENT WRONG OUTPUT"))
            except GuardError as e:
                record(kind, True, type(e).__name__)

        # racing readers on one corrupt entry: every reader must detect
        # and rebuild correctly; the quarantine rename resolves ONCE
        base = _store.stats()
        fresh = ops._build_class_plan(bmmc.rows, bmmc.c, t)
        try:
            with corrupt_store_entry(st, key, "bitflip"):
                _clear_replan_path()
                results, errs = [], []

                def reader():
                    try:
                        results.append(_store.class_plan_through(
                            bmmc.rows, bmmc.c, t,
                            lambda: ops._build_class_plan(
                                bmmc.rows, bmmc.c, t)))
                    except BaseException as e:  # noqa: BLE001
                        errs.append(e)

                threads = [threading.Thread(target=reader)
                           for _ in range(4)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join()
            from .validate import plan_fingerprint as _pfp
            now = _store.stats()
            want_fp = _pfp(*fresh)
            same = all(r[0] == fresh[0] and _pfp(*r) == want_fp
                       for r in results)
            quarantines = now["quarantined"] - base["quarantined"]
            ok = (not errs and len(results) == 4 and same
                  and quarantines == 1)
            record("disk_quarantine_race", ok,
                   "single quarantine, all readers recovered" if ok
                   else (f"errors={[type(e).__name__ for e in errs]} "
                         f"quarantines={quarantines}"))
        except GuardError as e:
            record("disk_quarantine_race", True, type(e).__name__)
    finally:
        _store.configure(prev.root if prev is not None else None)
        _clear_replan_path()

    caught = sum(1 for c in cases if c["caught"])
    return {"injected": len(cases), "caught": caught, "cases": cases}


def run_fault_matrix(engine: str = "cuda", n: int = 6,
                     device="cuda") -> dict:
    """Inject every corruption class against a guarded ``engine`` on
    ``device`` and report ``{injected, caught, cases}``. Each case is
    caught when the stack raises a typed :class:`GuardError` subclass
    (plan-time detection) or recovers via engine fallback with a
    bitwise-correct result (run-time detection). A silently wrong output
    marks the case uncaught — the outcome this harness exists to rule
    out."""
    from .. import guard as _g
    from ..combinators import vocab as V
    from ..combinators.execute import compile_expr
    from ..combinators.sort import sort_expr
    from . import validate as _v

    x, bmmc, t, oracle = _setup(n, device)
    cases = []

    def record(kind, caught, how):
        cases.append({"kind": kind, "caught": bool(caught), "how": how})

    with _g.guarded():
        # 1. bit-flipped BMMC row -> singular matrix -> NotInvertible
        try:
            _v.verify_bmmc(corrupt_bmmc(bmmc))
            record("bitflip_bmmc", False, "validated a singular matrix")
        except GuardError as e:
            record("bitflip_bmmc", True, type(e).__name__)

        # 2. swapped descriptor entries, in-bounds -> ring-1 semantic
        # audit (fresh validation) must refuse the plan
        ce = compile_expr(V.bit_reverse(n), engine=engine, optimize=False)
        ce(x)  # warm plans + caches
        _fresh_guard_state()
        try:
            with swap_descriptors(bmmc, t):
                y = ce(x)
                wrong = not _same(y, oracle)
                record("swap_descriptor", not wrong,
                       "fallback-recovered" if not wrong
                       else "SILENT WRONG OUTPUT")
        except GuardError as e:
            record("swap_descriptor", True, type(e).__name__)
        _fresh_guard_state()

        # 3. poisoned table AFTER validation -> the guarded kernel's bound
        # test on the card -> cuda degrades to ref and recovers (or a
        # typed error)
        ce(x)  # re-warm and re-validate the clean plans
        base = _g.stats()
        try:
            # poison the table the CHOSEN engine actually reads: the ref
            # gather table and the kernel plans are disjoint
            ctx = (poison_ref_table(bmmc) if engine == "ref"
                   else poison_plan(bmmc, t))
            with ctx:
                _clear_runtime_only()  # the next call uploads the poison
                y = ce(x)
            ok = _same(y, oracle)
            now = _g.stats()
            trapped = sum(now["traps"].values()) > sum(
                base["traps"].values())
            record("poison_cache", ok and trapped,
                   "fallback-recovered" if ok and trapped
                   else ("no trap recorded" if ok
                         else "SILENT WRONG OUTPUT"))
        except GuardError as e:
            record("poison_cache", True, type(e).__name__)
        finally:
            _fresh_guard_state()

        # 4. truncated parity table on a fused compute cluster -> ring-1
        # shape audit -> DescriptorOOB
        sce = compile_expr(sort_expr(n), engine="cuda", optimize=True)
        xs = torch.as_tensor(
            np.random.default_rng(0).standard_normal(1 << n),
            dtype=torch.float32, device=device)
        sce(xs)  # warm: builds the fused plans + compute tables
        prog, st = sce._resolve(xs, False)
        fused = [s for s in prog if getattr(s, "computes", ())]
        try:
            if not fused:
                record("truncate_parity_table", False, "no cluster found")
            else:
                _fresh_guard_state()
                with truncate_parity_table(fused[0], st):
                    sce(xs)
                record("truncate_parity_table", False,
                       "validated a truncated table")
        except GuardError as e:
            record("truncate_parity_table", True, type(e).__name__)
        except ValueError as e:
            record("truncate_parity_table", False, f"inject failed: {e}")
        finally:
            _fresh_guard_state()

        # 5. malformed inputs: wrong length / missing axis -> BadInput
        try:
            ce(torch.arange(24.0, device=device))
            record("bad_input", False, "accepted a non-power-of-2 input")
        except GuardError as e:
            record("bad_input", True, type(e).__name__)

    # 6-10. durable-store faults: truncation, bit flip, version skew,
    # torn write, quarantine race (ring 1 on load; the cuda engine)
    cases.extend(run_disk_fault_matrix(n=n, device=device)["cases"])

    caught = sum(1 for c in cases if c["caught"])
    return {"injected": len(cases), "caught": caught, "cases": cases}
