"""On-disk content-addressed plan store (DESIGN.md §15), the counterpart
of :mod:`repro.store.store`.

Layout under one root::

    objects/<hh>/<sha256(key)>.plan     hh = first two hex digits
    quarantine/<sha256(key)>.<reason>.<uniq>.plan
    tmp/<pid>.<seq>.tmp

Durability contract:

* **Atomic writes** — every entry lands via tmp-file write + flush +
  ``fsync`` + ``os.replace`` (POSIX rename atomicity), so a concurrent
  reader sees either the old complete entry or the new complete entry,
  never a torn one. A crash mid-write leaves at worst an orphan in
  ``tmp/``, which is swept opportunistically.
* **Single writer per key, many readers** — writers race benignly
  (last ``os.replace`` wins, both entries were complete); readers never
  lock.
* **Quarantine, not deletion** — an entry that fails integrity is moved
  aside (again via ``os.replace``, so exactly one of N racing readers
  wins the move and the rest see a clean miss), preserving the corrupt
  bytes for post-mortem.

The store never raises on I/O trouble in the hot path: ``get`` returns
``None`` and ``put`` returns ``False`` on OSError — disk failure
degrades to replanning, the same ladder as every other fault.
"""
from __future__ import annotations

import itertools
import os
import threading
from typing import Optional

from . import codec

_TMP_SEQ = itertools.count()
_TMP_LOCK = threading.Lock()


def _next_tmp_name() -> str:
    with _TMP_LOCK:
        seq = next(_TMP_SEQ)
    return f"{os.getpid()}.{seq}.tmp"


class PlanStore:
    """One store root. Thread-safe; cheap to construct."""

    def __init__(self, root: str):
        self.root = os.path.abspath(os.path.expanduser(root))
        self.objects = os.path.join(self.root, "objects")
        self.quarantine_dir = os.path.join(self.root, "quarantine")
        self.tmp_dir = os.path.join(self.root, "tmp")
        for d in (self.objects, self.quarantine_dir, self.tmp_dir):
            os.makedirs(d, exist_ok=True)

    # -- paths -------------------------------------------------------------

    def path_for(self, key: str) -> str:
        h = codec.key_digest(key)
        return os.path.join(self.objects, h[:2], h + ".plan")

    # -- raw I/O -----------------------------------------------------------

    def read_bytes(self, key: str) -> Optional[bytes]:
        try:
            with open(self.path_for(key), "rb") as f:
                return f.read()
        except OSError:
            return None

    def write_bytes(self, key: str, data: bytes) -> bool:
        """Atomic: tmp + fsync + rename. False on any I/O failure."""
        final = self.path_for(key)
        tmp = os.path.join(self.tmp_dir, _next_tmp_name())
        try:
            os.makedirs(os.path.dirname(final), exist_ok=True)
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        try:  # make the rename itself durable; best-effort
            dfd = os.open(os.path.dirname(final), os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass
        return True

    # -- entry API ---------------------------------------------------------

    def put(self, key: str, kind: str, meta: dict, arrays: list) -> bool:
        return self.write_bytes(
            key, codec.encode_entry(key, kind, meta, arrays))

    def quarantine(self, key: str, reason: str,
                   expect: Optional[bytes] = None) -> bool:
        """Move the entry aside. Returns True only for the caller whose
        rename won (N racing detectors quarantine exactly once: the
        losers' ``os.replace`` finds the path already gone). When
        ``expect`` is given, the move is skipped if the path no longer
        holds those bytes — a racing detector that lost the rename AND
        already saw the winner's rebuilt entry must not quarantine the
        fresh plan it just replanned past."""
        src = self.path_for(key)
        if expect is not None:
            try:
                with open(src, "rb") as f:
                    if f.read() != expect:
                        return False
            except OSError:
                return False
        dst = os.path.join(
            self.quarantine_dir,
            f"{codec.key_digest(key)}.{reason}.{_next_tmp_name()}.plan")
        try:
            os.replace(src, dst)
            return True
        except OSError:
            return False

    # -- hygiene / introspection -------------------------------------------

    def entry_count(self) -> int:
        total = 0
        try:
            for sub in os.scandir(self.objects):
                if sub.is_dir():
                    total += sum(1 for e in os.scandir(sub.path)
                                 if e.name.endswith(".plan"))
        except OSError:
            pass
        return total

    def quarantined_count(self) -> int:
        try:
            return sum(1 for e in os.scandir(self.quarantine_dir)
                       if e.name.endswith(".plan"))
        except OSError:
            return 0

    def sweep_tmp(self) -> int:
        """Remove orphaned tmp files from crashed writers (not this
        process's pid). Returns the count removed."""
        removed = 0
        pid = f"{os.getpid()}."
        try:
            for e in os.scandir(self.tmp_dir):
                if e.name.startswith(pid):
                    continue
                try:
                    os.unlink(e.path)
                    removed += 1
                except OSError:
                    pass
        except OSError:
            pass
        return removed
