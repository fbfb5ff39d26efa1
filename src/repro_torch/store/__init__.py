"""Durable plan store: crash-safe persistent compile cache (DESIGN.md §15),
the counterpart of :mod:`repro.store`.

Load-through layer beneath the executor's in-process lru caches.
A warm process behaves identically; a cold process that finds the
store populated decodes its plans from disk instead of re-planning —
and every decoded plan is held to the same ring-1 standard as a fresh
one (:mod:`repro_torch.guard.validate` audits re-run on load), so the
degradation ladder is

    disk hit -> (integrity failure? quarantine, count, fall through)
             -> replan -> (runtime trap? ref-engine fallback)

Silent wrong plans cannot enter the process: a torn, truncated,
bit-flipped, or colliding entry classifies as
:class:`~repro_torch.guard.errors.CachePoisoned`, is quarantined on disk,
and the caller replans. A version-skewed entry (older schema or
planner generation) is a plain miss — legal, just unusable — and is
overwritten by the rebuild.

Enable with ``REPRO_STORE=1`` (default root
``~/.cache/repro_torch/planstore``)
or ``REPRO_STORE=/path/to/root``, or programmatically via
:func:`configure`. Session counters (`stats()`) are always on,
independent of :mod:`repro_torch.obs` telemetry; the same events mirror into
``store.*`` obs counters when telemetry is enabled and quarantines
additionally mirror into ``guard.stats()``.
"""
from __future__ import annotations

import os
import threading
from typing import Optional

from . import codec
from .codec import (CODE_VERSION, SCHEMA_VERSION, EntryCorrupt, EntrySkew,
                    class_key, fused_key, key_digest)
from .store import PlanStore

_DEFAULT_ROOT = "~/.cache/repro_torch/planstore"

_LOCK = threading.Lock()
_STATS: dict = {"hit": 0, "miss": 0, "write": 0, "write_failed": 0,
                "corrupt": 0, "quarantined": 0, "version_skew": 0,
                "plan_built": 0}

_active: Optional[PlanStore] = None
_configured = False


def _env_root() -> Optional[str]:
    raw = os.environ.get("REPRO_STORE", "").strip()
    if not raw or raw.lower() in ("0", "false", "off", "no"):
        return None
    if raw.lower() in ("1", "true", "on", "yes"):
        return _DEFAULT_ROOT
    return raw


def configure(root: Optional[str]) -> Optional[PlanStore]:
    """Point the process at a store root (None disables). Returns the
    active store."""
    global _active, _configured
    with _LOCK:
        _active = PlanStore(root) if root else None
        _configured = True
        return _active


def active() -> Optional[PlanStore]:
    """The process-wide store, lazily resolved from ``REPRO_STORE`` on
    first use; None when disabled."""
    global _active, _configured
    with _LOCK:
        if not _configured:
            root = _env_root()
            _active = PlanStore(root) if root else None
            _configured = True
        return _active


def enabled() -> bool:
    return active() is not None


# ---------------------------------------------------------------------------
# session counters (always on; see obs/metrics.py for the store.* mirror)
# ---------------------------------------------------------------------------

def _count(event: str, n: int = 1, **labels) -> None:
    from ..obs import metrics as _om
    with _LOCK:
        _STATS[event] = _STATS.get(event, 0) + n
    _om.inc(f"store.{event}", n, **labels)


def stats() -> dict:
    with _LOCK:
        return dict(_STATS)


def reset_stats() -> None:
    with _LOCK:
        for k in _STATS:
            _STATS[k] = 0


# ---------------------------------------------------------------------------
# load-through core
# ---------------------------------------------------------------------------

def _quarantine(st: PlanStore, key: str, reason: str, err,
                raw: bytes) -> None:
    from .. import guard as _g

    _count("corrupt", kind=reason)
    # conditional on the corrupt bytes: N racing detectors quarantine
    # exactly once, and never sweep up a winner's rebuilt entry
    if st.quarantine(key, reason, expect=raw):
        _count("quarantined", kind=reason)
        _g._record_store_quarantine(reason)


def _load(st: PlanStore, key: str, decode_validate):
    """One integrity-checked disk probe: decoded+audited value on hit,
    None on miss/corruption (corruption quarantined + counted)."""
    from ..guard.errors import GuardError

    raw = st.read_bytes(key)
    if raw is None:
        return None
    try:
        header, arrays = codec.decode_entry(raw, key)
    except EntrySkew:
        _count("version_skew")
        return None
    except EntryCorrupt as e:
        _quarantine(st, key, "corrupt", e, raw)
        return None
    try:
        return decode_validate(header, arrays)
    except (GuardError, EntryCorrupt, ValueError, KeyError, TypeError,
            IndexError, AssertionError) as e:
        # a decoded-but-wrong plan is exactly what ring 1 exists to
        # refuse: CachePoisoned class, quarantine, replan
        _quarantine(st, key, "audit", e, raw)
        return None


# -- class plans -------------------------------------------------------------

def _typed_bmmc(rows: tuple, c: int):
    """Build WITHOUT __post_init__ so corrupt rows raise the typed
    NotInvertible from verify_bmmc, not a bare constructor error."""
    from ..core.bmmc import Bmmc
    from ..guard import validate as _v

    b = Bmmc.__new__(Bmmc)
    object.__setattr__(b, "rows", tuple(rows))
    object.__setattr__(b, "c", c)
    return _v.verify_bmmc(b)


def _audit_class(rows: tuple, c: int, t: int, kernel: str, payload) -> None:
    """Ring-1 audit of a disk-loaded class plan: re-derive the dispatch,
    bounds/bijection/semantic audit of every table, and tie the payload
    matrices back to the KEY's matrix (a valid plan for the wrong
    matrix must not pass)."""
    from ..core.tiling import dispatch_kernel
    from ..guard import validate as _v
    from ..guard.errors import ClassMismatch

    bmmc = _typed_bmmc(rows, c)
    fresh = dispatch_kernel(bmmc, t)
    if kernel != fresh:
        raise ClassMismatch(
            f"stored plan dispatched as {kernel!r}, matrix re-derives "
            f"{fresh!r} at t={t}")
    if kernel in ("block", "lane"):
        if payload.bmmc != bmmc:
            raise ClassMismatch(
                f"stored {kernel} plan answers for a different matrix "
                f"than its key")
    elif kernel != "none":
        total = payload[0].bmmc
        for p in payload[1:]:
            total = p.bmmc @ total
        if total != bmmc:
            raise ClassMismatch(
                "stored pass composition does not equal the key's matrix")
        for p in payload:
            _v.verify_bmmc(p.bmmc)
    _v._audit_payload(bmmc, t, kernel, payload)


def class_plan_through(rows: tuple, c: int, t: int, build) -> tuple:
    """Load-through for :func:`repro_torch.kernels.ops._class_plan_cached`:
    disk hit (audited) or ``build()`` + write-back."""
    st = active()
    key = codec.class_key(rows, c, t)
    if st is not None:
        def _dv(header, arrays):
            kernel, payload = codec.decode_class_payload(
                header["meta"], arrays)
            _audit_class(rows, c, t, kernel, payload)
            return kernel, payload
        got = _load(st, key, _dv)
        if got is not None:
            _count("hit", kind="class")
            return got
        _count("miss", kind="class")
    result = build()
    _count("plan_built", kind="class")
    if st is not None:
        meta, arrays = codec.encode_class_payload(*result)
        if st.put(key, "class", meta, arrays):
            _count("write", kind="class")
        else:
            _count("write_failed", kind="class")
    return result


# -- fused plans -------------------------------------------------------------

def _audit_fused(fs, t: int, plans: tuple, entries: tuple) -> None:
    from ..guard import validate as _v
    from ..guard.errors import ClassMismatch

    _v.verify_bmmc(fs.bmmc)
    total = plans[0].bmmc
    for p in plans[1:]:
        total = p.bmmc @ total
    if total != fs.bmmc:
        raise ClassMismatch(
            "stored fused pass composition does not equal the cluster's "
            "composed matrix")
    for p in plans:
        _v.verify_bmmc(p.bmmc)
        _v.audit_tile_plan(p)
    where = f"store:FusedStage(n={fs.bmmc.n}, t={t})"
    for e in entries:
        if e[0] in ("cmp", "bfly"):
            _v._audit_compute_tables(e[2], plans[0], where)


def fused_plan_through(fs, t: int, build):
    """Load-through for ``execute._fused_plan_cached``. Unplannable
    clusters are stored as an explicit negative entry so a warm boot
    skips the (failing) planning attempt too."""
    st = active()
    key = codec.fused_key(fs, t)
    sentinel = object()
    if st is not None:
        def _dv(header, arrays):
            if not header["meta"].get("plannable", True):
                return sentinel
            plans, entries = codec.decode_fused_payload(
                header["meta"], arrays, fs.computes)
            _audit_fused(fs, t, plans, entries)
            return plans, entries
        got = _load(st, key, _dv)
        if got is not None:
            _count("hit", kind="fused")
            return None if got is sentinel else got
        _count("miss", kind="fused")
    result = build()
    _count("plan_built", kind="fused")
    if st is not None:
        if result is None:
            meta, arrays = {"plannable": False}, []
        else:
            meta, arrays = codec.encode_fused_payload(*result)
            meta["plannable"] = True
        if st.put(key, "fused", meta, arrays):
            _count("write", kind="fused")
        else:
            _count("write_failed", kind="fused")
    return result


__all__ = [
    "PlanStore", "SCHEMA_VERSION", "CODE_VERSION", "EntryCorrupt",
    "EntrySkew", "class_key", "fused_key", "key_digest", "configure",
    "active", "enabled", "stats", "reset_stats", "class_plan_through",
    "fused_plan_through", "codec",
]
