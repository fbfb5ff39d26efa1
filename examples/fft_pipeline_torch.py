"""Radix-2 FFT whose data reorderings are fused BMMC combinators, on the
PyTorch port; the twin of ``examples/fft_pipeline.py``.

The bit-reversal and every butterfly block reordering are expressions in
the combinator IR; the optimizer fuses the conjugation chains so each of
the n butterfly stages is preceded by exactly one BMMC permutation. On
the ``cuda`` engine the clustering runs the butterflies inside the fused
tiled passes on the planar (re, im) layout: the fused kernel K4b on a
card, its plain version on the CPU.

The planar float32 result is held to ``numpy.fft.fft`` within
``FFT_REL_TOL`` (the largest error over the largest magnitude; radix-2
float32 rounding grows like 6e-8 * log2(N), far below it at these sizes).

Run: PYTHONPATH=src python examples/fft_pipeline_torch.py [--device cpu] [--n 10]
"""
import argparse

import numpy as np
import torch

from repro_torch.combinators import fuse, lower, num_perm_stages
from repro_torch.combinators.fft import (compiled_fft, fft_expr, from_planar,
                                         to_planar)
from repro_torch.kernels.bmmc_permute import (launch_counts,
                                              reset_launch_counts)
from repro_torch.launch.cli import (check, counting, device_of,
                                    print_launches, timed_ms)

FFT_REL_TOL = 1e-4


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu (their "
                         "plain versions)")
    ap.add_argument("--n", type=int, default=10,
                    help="log2 points (default 10; the card takes 22)")
    args = ap.parse_args(argv)
    dev = device_of(args.device, "fft_pipeline_torch")
    n = args.n
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(1 << n)
         + 1j * rng.standard_normal(1 << n)).astype(np.complex64)

    raw = lower(fft_expr(n), n)
    prog = fuse(raw)
    stages = (num_perm_stages(raw), num_perm_stages(prog))
    print(f"2^{n}-point FFT: {stages[0]} raw perm stages "
          f"-> {stages[1]} fused ({n} butterfly stages)")

    f = compiled_fft(n, engine="cuda")
    xp = to_planar(x).to(dev)             # (2^n, 2) float32 (re, im)
    reset_launch_counts()
    with counting() as obs:
        got, dt = timed_ms(lambda: f(xp), dev)
        fused = obs.kernel_counts().get("fused", 0)
        fallback = obs.counter_total("dispatch.fused_fallback")
    k4b = launch_counts()["tile_fused"]
    got = from_planar(got).cpu().numpy()
    want = np.fft.fft(x)
    err = rel_err(got, want)
    print(f"cuda-engine FFT rel err vs np.fft: {err:.2e} ({dt:.2f} ms cold; "
          f"{fused} fused clusters, K4b launches {k4b}, "
          f"fused_fallback {fallback:g})")
    check(err < FFT_REL_TOL, f"cuda-engine FFT rel err {err:.2e}")
    check(fused > 0 and fallback == 0, "the butterflies did not fuse")
    if dev.type == "cuda":
        check(k4b == fused, f"K4b launched {k4b} times for {fused} clusters")

    got_ref = compiled_fft(n, engine="ref")(
        torch.from_numpy(x).to(dev)).cpu().numpy()
    err_ref = rel_err(got_ref, want)
    print(f"ref-engine (complex64) FFT rel err: {err_ref:.2e}")
    check(err_ref < FFT_REL_TOL, f"ref-engine FFT rel err {err_ref:.2e}")
    launches = print_launches()
    return {"stages": stages, "fft": got, "fft_ref": got_ref, "err": err,
            "fused": fused, "k4b": k4b, "launches": launches}


if __name__ == "__main__":
    main()
