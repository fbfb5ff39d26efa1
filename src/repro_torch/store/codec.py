"""Entry format + plan serialization for the durable plan store: the
counterpart of :mod:`repro.store.codec`.

One entry is one file::

    MAGIC (8) | header_len u32 LE | header_fp u64 LE | header JSON | payload

The header carries the schema/code version, the key the entry answers
for, a manifest of the payload arrays (name, dtype, shape, offset,
nbytes, per-array checksum) and a whole-payload checksum. (The
reference's reserved ``measured_cost`` slot, for an autotuner neither
package has, is left out.)
All checksums reuse the guard subsystem's position-sensitive XOR-fold
(:func:`repro_torch.guard.validate._fp_array`) so a swapped pair of bytes —
not just a flipped one — changes the value.

Entries of this package never answer for the reference's, nor the
reverse: keys name the backend (``cuda``) and the architecture
(``sm_90``), and :data:`CODE_VERSION` is the port's own, so an entry of
the other package decodes as a version skew (a miss), never as a hit.

Decoding is paranoid by construction: a short file is a torn/truncated
write, a header that fails its own checksum or does not parse is
corruption, a version skew is a plain miss (old entries are legal,
just unusable), and a payload whose per-array or whole-payload
checksum mismatches is :class:`~repro_torch.guard.errors.CachePoisoned`
territory for the caller. Every decoded array is copied out of the
file buffer so downstream in-place mutation (fault injection included)
never aliases the mapped bytes.
"""
from __future__ import annotations

import hashlib
import json
import struct
from typing import Optional

import numpy as np

from ..core.bmmc import Bmmc
from ..core.tiling import BlockPlan, ComputeTables, LanePlan, TilePlan
from ..guard.validate import _fp_array

MAGIC = b"RPSTORE1"
SCHEMA_VERSION = 1
# Code fingerprint: entries planned by a different planner generation
# (or by the reference package) are version-skew misses, never trusted.
# Bump alongside planner or table-layout changes.
CODE_VERSION = "torch-cuda-plan-v1"
BACKEND = "cuda"
ARCH = "sm_90"

_HEADER_FMT = "<IQ"  # header_len, header_fp
_PREFIX_LEN = len(MAGIC) + struct.calcsize(_HEADER_FMT)


class EntryCorrupt(Exception):
    """Raised by :func:`decode_entry` on any integrity failure worth
    quarantining (short read, bad magic, checksum mismatch, malformed
    manifest). Callers classify it as CachePoisoned."""


class EntrySkew(Exception):
    """Raised when an entry is intact but written by a different
    schema/code version — a miss, not a corruption."""


def _fp_bytes(buf) -> int:
    return _fp_array(np.frombuffer(buf, dtype=np.uint8))


# ---------------------------------------------------------------------------
# keys + fingerprints
# ---------------------------------------------------------------------------

def key_digest(key: str) -> str:
    return hashlib.sha256(key.encode("utf-8")).hexdigest()


def class_key(rows: tuple, c: int, t: int, backend: str = BACKEND) -> str:
    rows_tok = ",".join(format(r, "x") for r in rows)
    return (f"class|{backend}|{ARCH}|n={len(rows)}|t={t}|c={c:x}|"
            f"rows={rows_tok}")


def _stage_token(stage) -> str:
    from ..combinators.ir import Bfly, CmpHalves, Map, Perm
    from ..combinators.optimize import FusedStage

    if isinstance(stage, Perm):
        b = stage.bmmc
        return "P:%x:%s" % (b.c, ",".join(format(r, "x") for r in b.rows))
    if isinstance(stage, CmpHalves):
        return "C"
    if isinstance(stage, Bfly):
        tw = np.asarray(stage.twiddles, dtype=np.complex128)
        return "B:" + hashlib.sha256(tw.tobytes()).hexdigest()[:16]
    if isinstance(stage, Map):
        return "M:" + stage.name
    if isinstance(stage, FusedStage):
        return "F(" + ";".join(_stage_token(s) for s in stage.stages) + ")"
    raise TypeError(f"unfingerprintable stage {type(stage).__name__}")


def fused_key(fs, t: int, backend: str = BACKEND) -> str:
    """Content key of a cluster's fused plan: the member stages (which
    determine the composed BMMC and every compute's pullback) plus the
    tile parameter. ``Map`` stages contribute their registered *name* —
    the same identity the IR's hash/eq contract uses — so the callable
    itself never reaches the key or the disk."""
    tok = hashlib.sha256(_stage_token(fs).encode("utf-8")).hexdigest()[:32]
    return f"fused|{backend}|{ARCH}|n={fs.bmmc.n}|t={t}|prog={tok}"


# ---------------------------------------------------------------------------
# entry encode / decode
# ---------------------------------------------------------------------------

def encode_entry(key: str, kind: str, meta: dict, arrays: list) -> bytes:
    """Serialize ``arrays`` — a list of ``(name, np.ndarray)`` — behind a
    checksummed header. ``meta`` is kind-specific plan structure (scalar
    fields only)."""
    manifest, chunks, off = [], [], 0
    for name, arr in arrays:
        a = np.ascontiguousarray(arr)
        raw = a.tobytes()
        manifest.append({"name": name, "dtype": a.dtype.str,
                         "shape": list(a.shape), "offset": off,
                         "nbytes": len(raw), "fp": _fp_array(a)})
        chunks.append(raw)
        off += len(raw)
    payload = b"".join(chunks)
    header = {
        "schema": SCHEMA_VERSION,
        "code": CODE_VERSION,
        "kind": kind,
        "key": key,
        "meta": meta,
        "arrays": manifest,
        "payload_nbytes": len(payload),
        "payload_fp": _fp_bytes(payload) if payload else 0,
    }
    hj = json.dumps(header, sort_keys=True).encode("utf-8")
    return b"".join((MAGIC, struct.pack(_HEADER_FMT, len(hj), _fp_bytes(hj)),
                     hj, payload))


def decode_entry(data: bytes, key: Optional[str] = None) -> tuple:
    """``(header, arrays_by_name)`` from raw entry bytes, verifying magic,
    header checksum, version, length, and every payload checksum.
    Raises :class:`EntryCorrupt` / :class:`EntrySkew`."""
    if len(data) < _PREFIX_LEN or data[:len(MAGIC)] != MAGIC:
        raise EntryCorrupt("short or unmagical entry prefix")
    hlen, hfp = struct.unpack_from(_HEADER_FMT, data, len(MAGIC))
    body = data[_PREFIX_LEN:]
    if len(body) < hlen:
        raise EntryCorrupt(f"torn header: {len(body)} of {hlen} bytes")
    hj = body[:hlen]
    if _fp_bytes(hj) != hfp:
        raise EntryCorrupt("header checksum mismatch")
    try:
        header = json.loads(hj.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise EntryCorrupt(f"header does not parse: {e}") from None
    if header.get("schema") != SCHEMA_VERSION or (
            header.get("code") != CODE_VERSION):
        raise EntrySkew(
            f"entry written by schema={header.get('schema')} "
            f"code={header.get('code')!r}, this build is "
            f"schema={SCHEMA_VERSION} code={CODE_VERSION!r}")
    if key is not None and header.get("key") != key:
        raise EntryCorrupt(
            f"entry answers for key {header.get('key')!r}, asked for "
            f"{key!r} (hash collision or tampering)")
    payload = body[hlen:]
    want = header.get("payload_nbytes", -1)
    if len(payload) < want:
        raise EntryCorrupt(f"torn payload: {len(payload)} of {want} bytes")
    payload = payload[:want]
    if want and _fp_bytes(payload) != header.get("payload_fp"):
        raise EntryCorrupt("whole-payload checksum mismatch")
    arrays = {}
    try:
        for m in header["arrays"]:
            raw = payload[m["offset"]:m["offset"] + m["nbytes"]]
            if len(raw) != m["nbytes"]:
                raise EntryCorrupt(f"array {m['name']!r} truncated")
            a = np.frombuffer(raw, dtype=np.dtype(m["dtype"]))
            a = np.array(a.reshape(m["shape"]))  # writable copy, off-buffer
            if _fp_array(a) != m["fp"]:
                raise EntryCorrupt(f"array {m['name']!r} checksum mismatch")
            arrays[m["name"]] = a
    except EntryCorrupt:
        raise
    except (KeyError, TypeError, ValueError) as e:
        raise EntryCorrupt(f"malformed array manifest: {e}") from None
    return header, arrays


# ---------------------------------------------------------------------------
# plan payloads <-> (meta, arrays)
# ---------------------------------------------------------------------------

def _bmmc_meta(b: Bmmc) -> dict:
    return {"rows": [format(r, "x") for r in b.rows], "c": format(b.c, "x")}


def _bmmc_from_meta(m: dict) -> Bmmc:
    # the constructor re-runs the rank check: corrupt rows raise here
    return Bmmc(tuple(int(r, 16) for r in m["rows"]), int(m["c"], 16))


def _tile_plan_meta(p: TilePlan) -> dict:
    return {"bmmc": _bmmc_meta(p.bmmc), "t": p.t,
            "row_cols": list(p.row_cols), "n_over": p.n_over,
            "tb_positions": list(p.tb_positions), "in_run": p.in_run,
            "out_run": p.out_run, "row_dirs": list(p.row_dirs)}


def _tile_plan_arrays(prefix: str, p: TilePlan) -> list:
    return [(prefix + "in_rows", p.in_rows), (prefix + "out_rows", p.out_rows),
            (prefix + "xor_low", p.xor_low), (prefix + "src0", p.src0)]


def _tile_plan_from(m: dict, prefix: str, arrays: dict) -> TilePlan:
    return TilePlan(
        bmmc=_bmmc_from_meta(m["bmmc"]), t=int(m["t"]),
        row_cols=tuple(m["row_cols"]), n_over=int(m["n_over"]),
        tb_positions=tuple(m["tb_positions"]),
        in_rows=arrays[prefix + "in_rows"], out_rows=arrays[prefix + "out_rows"],
        xor_low=arrays[prefix + "xor_low"], src0=arrays[prefix + "src0"],
        in_run=int(m["in_run"]), out_run=int(m["out_run"]),
        row_dirs=tuple(m["row_dirs"]))


def encode_class_payload(kernel: str, payload) -> tuple:
    """``(meta, arrays)`` for one class-dispatch ``(kernel, payload)``."""
    if kernel == "none":
        return {"kernel": kernel}, []
    if kernel == "block":
        return ({"kernel": kernel, "b": payload.b,
                 "bmmc": _bmmc_meta(payload.bmmc)},
                [("src_rows", payload.src_rows)])
    if kernel == "lane":
        return ({"kernel": kernel, "t": payload.t,
                 "rows_per_block": payload.rows_per_block,
                 "bmmc": _bmmc_meta(payload.bmmc)},
                [("src_lane", payload.src_lane)])
    meta = {"kernel": kernel,
            "passes": [_tile_plan_meta(p) for p in payload]}
    arrays = []
    for i, p in enumerate(payload):
        arrays.extend(_tile_plan_arrays(f"p{i}.", p))
    return meta, arrays


def decode_class_payload(meta: dict, arrays: dict) -> tuple:
    kernel = meta["kernel"]
    if kernel == "none":
        return kernel, ()
    if kernel == "block":
        return kernel, BlockPlan(bmmc=_bmmc_from_meta(meta["bmmc"]),
                                 b=int(meta["b"]),
                                 src_rows=arrays["src_rows"])
    if kernel == "lane":
        return kernel, LanePlan(bmmc=_bmmc_from_meta(meta["bmmc"]),
                                t=int(meta["t"]),
                                src_lane=arrays["src_lane"],
                                rows_per_block=int(meta["rows_per_block"]))
    plans = tuple(_tile_plan_from(m, f"p{i}.", arrays)
                  for i, m in enumerate(meta["passes"]))
    return kernel, plans


_CT_FIELDS = ("hi_row", "hi_lane", "hi_base", "tw_row", "tw_lane", "tw_base")


def encode_fused_payload(plans: tuple, entries: tuple) -> tuple:
    """``(meta, arrays)`` for one fused-cluster plan. Only the offline
    tables travel: compute entries are re-seated against the cluster's
    live ``computes`` on decode (Map callables never serialize)."""
    meta = {"passes": [_tile_plan_meta(p) for p in plans], "entries": []}
    arrays = []
    for i, p in enumerate(plans):
        arrays.extend(_tile_plan_arrays(f"p{i}.", p))
    for i, e in enumerate(entries):
        if e[0] == "map":
            meta["entries"].append({"kind": "map"})
            continue
        kind, _, ct = e
        em = {"kind": kind, "vr": ct.vr, "vc": ct.vc}
        for f in _CT_FIELDS:
            arr = getattr(ct, f)
            em[f] = arr is not None
            if arr is not None:
                arrays.append((f"e{i}.{f}", arr))
        meta["entries"].append(em)
    return meta, arrays


def decode_fused_payload(meta: dict, arrays: dict, computes: tuple) -> tuple:
    """``(plans, entries)`` re-seated against the live ``fs.computes``.
    Raises :class:`EntryCorrupt` when the stored entry list does not
    line up with the cluster (collision / drift)."""
    from ..combinators.ir import Bfly, CmpHalves, Map

    plans = tuple(_tile_plan_from(m, f"p{i}.", arrays)
                  for i, m in enumerate(meta["passes"]))
    ems = meta["entries"]
    if len(ems) != len(computes):
        raise EntryCorrupt(
            f"stored {len(ems)} compute entries for a cluster with "
            f"{len(computes)} computes")
    entries = []
    for i, ((comp, _prefix), em) in enumerate(zip(computes, ems)):
        want = ("map" if isinstance(comp, Map)
                else "cmp" if isinstance(comp, CmpHalves)
                else "bfly" if isinstance(comp, Bfly) else None)
        if em["kind"] != want:
            raise EntryCorrupt(
                f"entry {i} stored as {em['kind']!r}, cluster compute is "
                f"{type(comp).__name__}")
        if want == "map":
            entries.append(("map", comp))
            continue
        fields = {}
        for f in _CT_FIELDS:
            fields[f] = arrays[f"e{i}.{f}"] if em.get(f) else None
        entries.append((want, comp, ComputeTables(
            kind=want, vr=int(em["vr"]), vc=int(em["vc"]), **fields)))
    return plans, tuple(entries)
