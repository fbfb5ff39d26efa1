#!/usr/bin/env python3
"""Compare the machine code (SASS) of the port's kernels with another tree's.

    python3 tools/sass_diff.py OTHER/src/repro_torch/kernels/csrc

Builds every ``*.cu`` of this checkout's ``csrc/`` and of ``OTHER`` (the
same file names) with the port's ``nvcc`` flags for ``sm_90a``, one
``nvcc`` per source, all at once, into ``build/sass/`` (``--build-dir``),
disassembles each library with ``cuobjdump -sass`` and compares every
kernel the two libraries share, instruction by instruction with its
encoding (scheduling bits included; addresses and the listing's column
alignment left out). Prints, per source, the kernels that are the same,
those that differ (with their first differing lines) and those only one
side has. Exit code 1 when a kernel both sides have differs. Needs the
CUDA toolkit (``nvcc``, ``cuobjdump``), not a card.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_ADDR = re.compile(r"/\*[0-9a-fx]+\*/")


def build(csrc: Path, out: Path) -> dict:
    from repro_torch.kernels import build as B
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sorted(csrc.glob("*.cu")):
        lib = out / f"{src.stem}.so"
        procs[src.name] = (lib, subprocess.Popen(
            [B.nvcc(), *B.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"sass_diff: nvcc failed on {name}\n{log}")
        libs[name] = lib
    return libs


def functions(lib: Path) -> dict:
    """{kernel: [instructions]} of a library's SASS."""
    from repro_torch.kernels import build as B
    exe = Path(B.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(exe), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    got, name = {}, None
    for ln in text.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :", 1)[1].strip()
            got[name] = []
        elif name is not None and ln.strip().startswith("/*"):
            body = " ".join(_ADDR.sub("", ln).split())  # and its encoding
            if body:
                got[name].append(body)
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the other tree's csrc/ directory")
    ap.add_argument("--build-dir", default=str(ROOT / "build" / "sass"))
    ap.add_argument("--show", type=int, default=4,
                    help="differing lines to print a kernel")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as B
    out = Path(args.build_dir)
    mine = build(B.CSRC, out / "this")
    theirs = build(Path(args.other), out / "other")
    differ = 0
    for name in sorted(set(mine) | set(theirs)):
        if name not in mine or name not in theirs:
            print(f"{name}: only in {'this' if name in mine else 'other'}")
            continue
        a, b = functions(mine[name]), functions(theirs[name])
        same = sorted(k for k in set(a) & set(b) if a[k] == b[k])
        diff = sorted(k for k in set(a) & set(b) if a[k] != b[k])
        differ += len(diff)
        print(f"{name}: {len(same)} kernels the same, {len(diff)} differ, "
              f"{len(set(a) - set(b))} only here, {len(set(b) - set(a))} "
              f"only in the other", flush=True)
        for k in diff:
            at = [i for i, (u, v) in enumerate(zip(a[k], b[k])) if u != v]
            print(f"  differs: {k} ({len(a[k])} / {len(b[k])} lines, "
                  f"{len(at)} differ)")
            for i in at[:args.show]:
                print(f"    line {i}: here  {a[k][i]}\n"
                      f"    {' ' * len(str(i))}       other {b[k][i]}")
        for k in sorted(set(a) ^ set(b)):
            print(f"  only {'here' if k in a else 'in the other'}: {k}")
    print(f"sass_diff: {differ} shared kernel(s) differ", flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
