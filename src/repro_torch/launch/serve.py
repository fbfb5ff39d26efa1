"""Serving entry point: batched prefill + greedy decode with a KV cache.

The counterpart of :mod:`repro.launch.serve`. Usage::

    python -m repro_torch.launch.serve --arch mistral-nemo-12b --tokens 32
    python -m repro_torch.launch.serve --device cpu --kv-heads 8 --head-shuffle cuda

It runs on the card unless ``--device cpu`` asks for the CPU; a CUDA
device that is not there fails, it does not fall back. ``main`` serves the
configuration reduced for a smoke run (``reduce_for_smoke``), as the
reference does; :func:`serve` is the loop itself, a function of
``(cfg, params, args)`` that runs any configuration at any width.

An encoder-decoder or VLM configuration prefills with ``(batch, src_len,
d_model)`` source embeddings drawn from ``--seed`` (:func:`make_src`), as
the reference does.

``--head-shuffle ENGINE`` routes the kv-head shuffle of every prefill
self-attention layer through ``ENGINE``: ``ref`` (the plain gather) or ``cuda`` (the
class-dispatched kernels: a tiled-permutation launch, K4a, for each of k,
v, the q groups and the output). Decode skips the shuffle, as the
reference does.

``--telemetry`` enables :mod:`repro_torch.obs`: per-request latency
histograms labeled warm/cold plus the executor's dispatch counters,
rendered with ``obs.report()`` at exit. ``--trace OUT.json`` additionally
writes the Chrome trace.

``--validate`` turns on :mod:`repro_torch.guard` for the whole run (ring 1
validation plus ring-2 guarded dispatch: the shuffle runs the guarded
kernels). Guard resolution is per request: after each prefill/decode step
the accumulated trap/fallback counters are checked and recovered
degradations are reported.

Failure handling is the resilience layer's request lifecycle: every
prefill/decode step runs under
:func:`repro_torch.resilience.run_with_policy` — retryable guard errors
get ``--retries`` bounded retries with deterministic backoff inside the
optional ``--deadline-ms`` budget, and an exhausted/terminal failure
becomes a structured per-request error result (printed, counted) while
the process keeps draining. At drain the full summary always prints and
``--error-budget`` decides the exit code: more request errors than the
budget exits 1. SIGTERM is graceful drain — the loop finishes its
in-flight decode step, reports ``drained:``, and still prints the
complete summary with exit 0.

``--store PATH`` points the process at a durable plan store: compiled
permutation plans load from disk instead of re-planning on boot, and
per-request ``store.hit/miss/quarantined`` deltas print next to the guard
resolution report.

Each decode step brings its new tokens to the host, as a streaming server
does, so the step times read on the host clock are device times too.
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import time
from typing import Optional

import numpy as np
import torch

from .. import guard, obs, resilience, store as _store
from ..configs import get_config, reduce_for_smoke
from ..models import model as M


def _guard_resolve(where: str, base: dict) -> dict:
    """Per-request guard resolution: report counter deltas since
    ``base`` (recovered degradations stay a warning). Returns the new
    baseline."""
    now = guard.stats()
    trapped = (sum(now["traps"].values())
               - sum(base["traps"].values()))
    recovered = now["recovered"] - base["recovered"]
    if trapped:
        print(f"guard[{where}]: {trapped} trap(s), "
              f"{recovered} recovered via engine fallback")
    return now


def _store_resolve(where: str, base: dict) -> dict:
    """Per-request plan-store resolution, printed next to the guard
    report: hit/miss/quarantined deltas since ``base``. A quarantine
    is never silent."""
    now = _store.stats()
    hit = now["hit"] - base["hit"]
    miss = now["miss"] - base["miss"]
    quarantined = now["quarantined"] - base["quarantined"]
    if hit or miss or quarantined:
        extra = (f", {quarantined} QUARANTINED (corrupt entry refused, "
                 f"replanned)" if quarantined else "")
        print(f"store[{where}]: {hit} hit / {miss} miss{extra}")
    return now


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mistral-nemo-12b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the device the model runs on (default cuda; the "
                         "tests pass cpu)")
    ap.add_argument("--telemetry", action="store_true",
                    help="record+print repro_torch.obs latency/dispatch "
                         "report")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write a chrome://tracing span export (implies "
                         "--telemetry)")
    ap.add_argument("--validate", action="store_true",
                    help="guarded execution (repro_torch.guard): validate "
                         "plans, trap faults on the card, degrade "
                         "cuda->ref; exit nonzero on an unrecovered trap")
    ap.add_argument("--error-budget", type=int, default=0, metavar="N",
                    help="max per-request structured errors tolerated "
                         "before the drain exit code goes nonzero "
                         "(default 0: any unrecovered request error "
                         "fails the run — but only after draining and "
                         "printing the full summary)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    metavar="MS",
                    help="per-request deadline budget (attempts + "
                         "retry backoff); an exhausted budget is a "
                         "structured 'deadline' request error")
    ap.add_argument("--retries", type=int, default=1, metavar="N",
                    help="bounded retries of retryable GuardErrors per "
                         "request (deterministic seeded backoff; "
                         "default 1)")
    ap.add_argument("--store", default=None, metavar="PATH",
                    help="durable plan store root: load compiled "
                         "permutation plans from disk, report per-request "
                         "hit/miss/quarantine deltas")
    ap.add_argument("--head-shuffle", default=None, metavar="ENGINE",
                    choices=("ref", "cuda"),
                    help="enable the BMMC kv-head shuffle through ENGINE "
                         "(needs power-of-two n_kv_heads >= 2); with "
                         "'cuda' the serving path runs the tiled "
                         "permutation kernel, so --store traffic is real")
    ap.add_argument("--kv-heads", type=int, default=None, metavar="N",
                    help="override n_kv_heads (power of two; n_heads is "
                         "raised to match if needed) — the smoke configs "
                         "reduce to 2 kv heads, whose 1-bit shuffle is "
                         "identity, so --head-shuffle demos want >= 4")
    return ap.parse_args(argv)


def configure(args: argparse.Namespace) -> None:
    """Turn on what the flags ask for, process-wide: telemetry, guards,
    the plan store."""
    if args.telemetry or args.trace:
        obs.enable(sync=True)
    if args.validate:
        guard.enable()
    if args.store:
        _store.configure(args.store)
        _store.reset_stats()


def config_for(args: argparse.Namespace, cfg=None):
    """The served configuration: ``cfg`` (default: ``--arch`` reduced for
    a smoke run) with ``--kv-heads`` and ``--head-shuffle`` applied."""
    if cfg is None:
        cfg = reduce_for_smoke(get_config(args.arch))
    repl = {}
    if args.kv_heads:
        repl["n_kv_heads"] = args.kv_heads
        repl["n_heads"] = max(cfg.n_heads, args.kv_heads)
    if args.head_shuffle:
        repl["head_shuffle"] = args.head_shuffle
    return dataclasses.replace(cfg, **repl) if repl else cfg


def make_prompts(cfg, args, device) -> torch.Tensor:
    """``(batch, prompt_len)`` token ids drawn from ``--seed`` on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    return torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                         generator=gen, device=device)


def make_src(cfg, args, device) -> Optional[torch.Tensor]:
    """The cross-attention memory of an encoder-decoder or VLM
    configuration: ``(batch, src_len, d_model)`` standard normals in the
    model's type, drawn from ``--seed`` on ``device`` (stub audio frames
    or patch embeddings, as the reference's); None for the others."""
    if not (cfg.is_encdec or cfg.family == "vlm"):
        return None
    gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    return torch.randn((args.batch, cfg.src_len, cfg.d_model),
                       generator=gen, device=device).to(cfg.dtype)


@dataclasses.dataclass
class ServeResult:
    """What one serving run produced."""
    gen: Optional[np.ndarray]          # (batch, served) ids, None: no prefill
    prefill_logits: Optional[torch.Tensor]   # (batch, 1, vocab) float32
    prefill_s: float
    decode_s: float
    warm_steps: int
    step_s: list                       # host seconds of each decode step
    errors: list                       # (where, RequestResult) per failure


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, params, args, prompts: Optional[torch.Tensor] = None,
          src: Optional[torch.Tensor] = None) -> ServeResult:
    """Prefill ``prompts`` (default :func:`make_prompts`) and decode
    ``args.tokens`` greedy tokens with the model ``(cfg, params)``, each
    request under the resilience policy. An encoder-decoder or VLM
    configuration prefills with the source embeddings ``src`` (default
    :func:`make_src`). Runs on the device of ``params``; no gradient is
    recorded."""
    lm = params if isinstance(params, M.LM) else M.LM(cfg, params)
    device = lm.embed.device
    if prompts is None:
        prompts = make_prompts(cfg, args, device)
    batch = {"tokens": prompts}
    if src is None:
        src = make_src(cfg, args, device)
    if src is not None:
        batch["src"] = src
    total = args.prompt_len + args.tokens

    gbase = guard.stats() if args.validate else None
    sbase = _store.stats() if args.store else None
    policy = resilience.RetryPolicy(max_retries=max(0, args.retries),
                                    seed=args.seed)
    deadline_s = args.deadline_ms / 1e3 if args.deadline_ms else None
    errors = []

    def _request(where, fn, request_id):
        """One policied request: bounded retries + deadline; a failure
        becomes a structured, printed result — never a process abort."""
        res = resilience.run_with_policy(fn, policy=policy,
                                         deadline_s=deadline_s,
                                         request_id=request_id)
        if not res.ok:
            errors.append((where, res))
            print(f"request[{where}]: {res.describe()}")
        elif res.retries:
            print(f"request[{where}]: recovered after "
                  f"{res.retries} retry(ies)")
        return res

    # SIGTERM = graceful drain: finish the in-flight decode step, then
    # fall through to the summary with the tokens served so far
    drain = {"sigterm": False}
    try:
        prev_term = signal.signal(
            signal.SIGTERM, lambda *_: drain.update(sigterm=True))
    except ValueError:          # not the main thread (e.g. under tests)
        prev_term = None

    out_tokens, step_s, warm_steps = [], [], 0
    decode_s = 0.0
    try:
        with torch.no_grad():
            t0 = time.perf_counter()
            with obs.span("serve.prefill", batch=args.batch,
                          prompt_len=args.prompt_len):
                res = _request("prefill", lambda: lm.prefill(batch), 0)
                _sync(device)
            if args.validate:
                gbase = _guard_resolve("prefill", gbase)
            if args.store:
                sbase = _store_resolve("prefill", sbase)
            prefill_s = time.perf_counter() - t0
            if not res.ok:   # nothing decodable without a prefill
                return ServeResult(None, None, prefill_s, 0.0, 0, [], errors)
            logits, caches = res.value
            prefill_logits = logits
            # grow caches to the full decode horizon
            caches = M.grow_caches(caches, args.prompt_len, total)
            if obs.enabled():
                obs.observe("serve.request_us", prefill_s * 1e6,
                            phase="prefill", cache="cold")

            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            out_tokens.append(tok.cpu())
            print(f"serving: decode starting (tokens={args.tokens})",
                  flush=True)
            t1 = time.perf_counter()
            for i in range(args.tokens - 1):
                if drain["sigterm"]:
                    print(f"drained: SIGTERM after {len(out_tokens)}/"
                          f"{args.tokens} tokens", flush=True)
                    break
                with obs.span("serve.decode_step", step=i,
                              cache="cold" if i == 0 else "warm"):
                    tr = time.perf_counter()
                    res = _request(
                        f"decode step {i}",
                        lambda: lm.decode_step(caches, tok,
                                               args.prompt_len + i),
                        i + 1)
                    if res.ok:
                        logits, caches = res.value
                        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
                        out_tokens.append(tok.cpu())   # waits for the step
                        step_s.append(time.perf_counter() - tr)
                        if obs.enabled():
                            obs.observe("serve.request_us", step_s[-1] * 1e6,
                                        phase="decode",
                                        cache="cold" if i == 0 else "warm")
                if args.validate:
                    gbase = _guard_resolve(f"decode step {i}", gbase)
                if args.store:
                    sbase = _store_resolve(f"decode step {i}", sbase)
                if not res.ok:
                    # drain with the tokens served so far (as the
                    # reference, whose failed step took its donated
                    # caches with it); the budget decides the exit code
                    break
                if i > 0:
                    warm_steps += 1
            decode_s = time.perf_counter() - t1
    finally:
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)

    gen = torch.cat(out_tokens, dim=1).numpy()
    return ServeResult(gen, prefill_logits, prefill_s, decode_s, warm_steps,
                       step_s, errors)


def main(argv=None):
    args = parse_args(argv)
    configure(args)
    device = torch.device(args.device)
    cfg = config_for(args)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = M.init(cfg, gen)
    res = serve(cfg, params, args)
    _summary(args, cfg, res)
    if res.gen is None or len(res.errors) > args.error_budget:
        raise SystemExit(1)
    return res.gen


def _summary(args, cfg, res: ServeResult):
    """The drain-time report: always printed in full — on success, on
    drained SIGTERM, and on over-budget failure alike."""
    gen = res.gen
    served = 0 if gen is None else gen.shape[1]
    print(f"arch={cfg.name} batch={args.batch}")
    print(f"prefill: {args.prompt_len} tokens in {res.prefill_s:.2f}s")
    if res.warm_steps > 0:
        rate = f"{args.batch * served / max(res.decode_s, 1e-9):.1f} tok/s"
    else:
        # --tokens 1 (or a first-step failure) times zero warm decode
        # steps; a rate derived from max(decode_s, 1e-9) is nonsense
        rate = "n/a tok/s — no warm decode step timed"
    print(f"decode:  {served}/{args.tokens} tokens in {res.decode_s:.2f}s "
          f"({rate})")
    if gen is not None:
        print("generated ids (first row):", gen[0][:16])
    if args.validate:
        gs = guard.stats()
        print(f"guard: traps={sum(gs['traps'].values())} "
              f"fallbacks={sum(gs['fallbacks'].values())} "
              f"recovered={gs['recovered']} (all requests validated)")
    if args.store:
        ss = _store.stats()
        st = _store.active()
        print(f"store: hits={ss['hit']} misses={ss['miss']} "
              f"plans_built={ss['plan_built']} "
              f"quarantined={ss['quarantined']} "
              f"({st.entry_count()} entries on disk at {st.root})")
    rs = resilience.stats()
    print(f"resilience: requests={rs['requests']} "
          f"retries={rs['retries']} "
          f"deadline_exceeded={rs['deadline_exceeded']} "
          f"errors={len(res.errors)} (budget {args.error_budget}) "
          f"breaker={rs['breaker']}")
    if args.trace:
        print(f"trace written to {obs.export_trace(args.trace)}")
    if obs.enabled():
        print(obs.report())


if __name__ == "__main__":
    main()
