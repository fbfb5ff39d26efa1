#!/usr/bin/env python3
"""Build a checkout's kernels from nothing with ``build.build_all()`` and
print its wall time and each library's, as one JSON line.

    python3 tools/build_times.py --src OTHER/src --build-dir DIR --tag parent
    python3 tools/build_times.py --build-dir DIR2 --tag change

``--build-dir`` must not hold the libraries yet (a library already built
is loaded, not timed). Needs ``nvcc``, not a card. Two checkouts compare
only on one machine, one build at a time: run parent, change, change,
parent in one call.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the checkout's src/ (default: this one's)")
    ap.add_argument("--build-dir", required=True,
                    help="an empty directory for the libraries")
    ap.add_argument("--tag", default="this", help="label of the line")
    args = ap.parse_args()
    os.environ["REPRO_TORCH_BUILD_DIR"] = args.build_dir
    sys.path.insert(0, args.src)
    from repro_torch.kernels import build as B
    t0 = time.perf_counter()
    log = B.build_all()
    wall = time.perf_counter() - t0
    print(json.dumps({"tag": args.tag, "build_all_s": round(wall, 2),
                      "libs": {k: round(v["seconds"], 2)
                               for k, v in sorted(log.items())}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
