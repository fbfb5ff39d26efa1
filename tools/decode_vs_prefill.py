#!/usr/bin/env python3
"""How far one decode step's logits drift from a prefill over the extended
sequence, by depth and type, for full-width Mistral-NeMo-12B on one GPU.

    python3 tools/decode_vs_prefill.py [--depths 1 4 10 20 40]

For each depth (the number of layers kept of the configuration's 40, the
widths unchanged, weights from a seed) in bfloat16, and at full depth in
float32, with the kv-head shuffle on ``cuda``: prefill a batch of 4
prompts of 512 tokens, decode one greedy token, prefill the prompts plus
that token, and print the norm-wise relative difference of the two
logits, their largest absolute difference, the rows whose argmax agrees,
and whether the same prefill gives the same bits at batch 4 and one row
at a time (the rounding floor of the products). This is the record
behind ``chip_smoke.py``'s ``DECODE_REL_TOL``.
"""
import argparse
import dataclasses
import gc
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--depths", type=int, nargs="+",
                    default=[1, 4, 10, 20, 40])
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as S
    from repro_torch.models import model as M

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    base = get_config("mistral-nemo-12b")
    prompt = 512
    runs = [(torch.bfloat16, d) for d in args.depths]
    runs.append((torch.float32, base.n_periods))
    for dtype, depth in runs:
        cfg = dataclasses.replace(base, n_periods=depth, dtype=dtype,
                                  head_shuffle="cuda")
        params = M.init(cfg, torch.Generator(device=dev).manual_seed(0))
        sargs = S.parse_args(["--batch", "4", "--prompt-len", str(prompt)])
        prompts = S.make_prompts(cfg, sargs, dev)
        with torch.no_grad():
            logits, caches = M.prefill(cfg, params, {"tokens": prompts})
            caches = M.grow_caches(caches, prompt, prompt + 1)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            dec, _ = M.decode_step(cfg, params, caches, tok, prompt)
            del caches
            ext = torch.cat([prompts, tok], 1)
            full, _ = M.prefill(cfg, params, {"tokens": ext})
            rows = torch.cat([M.prefill(cfg, params,
                                        {"tokens": ext[i:i + 1]})[0]
                              for i in range(ext.shape[0])])
        agree = int((dec.argmax(-1) == full.argmax(-1)).sum())
        print(f"{str(dtype).removeprefix('torch.')} layers={depth}: decode "
              f"vs prefill relative {rel(dec, full):.3e}, max abs "
              f"{float((dec - full).abs().max()):.4f}, argmax equal in "
              f"{agree}/{ext.shape[0]} rows; prefill at batch 4 vs one row "
              f"at a time: relative {rel(rows, full):.3e} (bit-equal "
              f"{torch.equal(rows, full)}); logit rms "
              f"{float(full.float().pow(2).mean().sqrt()):.3f}", flush=True)
        del params, logits, dec, full, rows
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
