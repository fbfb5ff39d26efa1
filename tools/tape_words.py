#!/usr/bin/env python3
"""The tape words of every map case the port's tests and ``chip_smoke.py``
hold, on every element type, for a checkout; or where two such lists
differ. Runs on the CPU (``make_fx`` traces; no card, no ``nvcc``).

    python3 tools/tape_words.py --src OTHER/src --out other.json
    python3 tools/tape_words.py --out this.json
    python3 tools/tape_words.py --diff other.json this.json

The cases: ``tests/_torch_typed_maps.py``'s, ``test_torch_map_dag.CASES``,
``test_torch_map_epilogue.LISTED``, ``chip_smoke.py``'s DAG and typed map
cases and its chain maps, and a few one-op maps. Each is lowered under a
name of its own for each of 13 element types; a case that does not lower
is recorded as null. ``--diff`` prints the cases whose words differ and
exits 1 when any does: a change to ``kernels/map_lower.py`` that should
keep every tape run this against its parent.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def cases(torch) -> list:
    """(name, function) of every map case."""
    sys.path[:0] = [str(ROOT / "tests"), str(ROOT)]
    import _torch_typed_maps as TM
    import chip_smoke as CS
    import test_torch_map_dag as D
    import test_torch_map_epilogue as E
    return ([(n, f) for n, f, _ in TM.ALL]
            + [(n, f) for n, f, *_ in D.CASES]
            + [(n, f) for n, f, *_ in E.LISTED]
            + [(n, f) for n, f, *_ in CS.map_dag_cases(torch)]
            + [(n, f) for n, f, *_ in CS.map_typed_cases(torch)]
            + [(f.__name__, f) for f in (CS._sq, CS._silu, CS._self_ratio,
                                         CS._chain3, CS._div3, CS._wrap,
                                         CS._chain3_once)]
            + [("times_two", lambda v: v * 2),
               ("affine", lambda v: v * 2 - 1),
               ("leaky", lambda v: torch.where(v > 0, v, 0.01 * v)),
               ("not", lambda v: ~v)])


def words(src: str) -> dict:
    """{"i:name:dtype": tape words or None} of the checkout at ``src``."""
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels import map_lower as ML
    types = [torch.float32, torch.bfloat16, torch.float16, torch.float64,
             torch.int32, torch.int8, torch.uint8, torch.int16, torch.int64,
             torch.uint16, torch.uint32, torch.uint64, torch.bool]
    out = {}
    for i, (name, fn) in enumerate(cases(torch)):
        for dtype in types:
            ML.clear_cache()
            tape = ML.lower_map(f"case{i}", fn, dtype)
            out[f"{i}:{name}:{dtype}"] = (ML.tape_words(tape) if tape.lowered
                                          else None)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the checkout's src/ (default: this one's)")
    ap.add_argument("--out", help="write the words here as JSON")
    ap.add_argument("--diff", nargs=2, metavar=("A", "B"),
                    help="compare two --out files instead")
    args = ap.parse_args()
    if args.diff:
        a, b = (json.loads(Path(p).read_text()) for p in args.diff)
        bad = sorted(k for k in a.keys() | b.keys() if a.get(k) != b.get(k))
        for k in bad:
            print("differs:", k)
        print(f"{len(a)} / {len(b)} cases, {sum(v is not None for v in a.values())}"
              f" / {sum(v is not None for v in b.values())} lowered, "
              f"{len(bad)} differ")
        return 1 if bad else 0
    got = words(args.src)
    if args.out:
        Path(args.out).write_text(json.dumps(got))
    print(f"{len(got)} cases, {sum(v is not None for v in got.values())} "
          f"lowered")
    return 0


if __name__ == "__main__":
    sys.exit(main())
