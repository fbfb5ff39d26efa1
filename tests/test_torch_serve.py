"""The port's serving entry point (``repro_torch.launch.serve``) on the
CPU: the reference's summary lines, guarded and store-backed runs, the
reference's generated ids from the reference's weights, and the SIGTERM
drain drill."""
import dataclasses
import re
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import reduce_for_smoke as ref_reduce
from repro.launch import serve as RS
from repro.models import model as RM
from repro_torch import guard, store
from repro_torch.combinators import clear_caches
from repro_torch.launch import serve as TS
from repro_torch.models.convert import params_from_numpy
from repro_torch.resilience import chaos

SUMMARY = ("arch=", "prefill:", "decode:", "generated ids (first row):",
           "resilience:")


def _summary_lines(out: str) -> list:
    return [ln.split(" ")[0] if not ln.startswith("generated") else
            "generated ids (first row):" for ln in out.splitlines()
            if ln.startswith(SUMMARY)]


def test_serve_tokens_1_reports_na_throughput(capsys):
    """The counterpart of the reference's test of the same name, with the
    reference's own run beside it: the same summary lines."""
    argv = ["--arch", "mistral-nemo-12b", "--batch", "1", "--prompt-len",
            "4", "--tokens", "1"]
    gen = TS.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert gen.shape == (1, 1)
    assert "n/a tok/s" in out
    assert "resilience: requests=1" in out
    RS.main(argv)
    ref_out = capsys.readouterr().out
    assert _summary_lines(out) == _summary_lines(ref_out)
    assert len(_summary_lines(out)) == len(SUMMARY)


def test_serve_validate_and_store_on_the_cpu(capsys):
    clear_caches()
    root = tempfile.mkdtemp(prefix="repro-torch-serve-store-")
    try:
        gen = TS.main(["--batch", "2", "--prompt-len", "8", "--tokens", "3",
                       "--kv-heads", "8", "--head-shuffle", "cuda",
                       "--validate", "--store", root, "--device", "cpu"])
        out = capsys.readouterr().out
    finally:
        guard.disable()
        store.configure(None)
        clear_caches()
    assert gen.shape == (2, 3)
    assert "guard: traps=0 fallbacks=0 recovered=0" in out
    m = re.search(r"store: hits=(\d+) misses=(\d+) plans_built=(\d+)", out)
    assert m and int(m.group(2)) >= 1 and int(m.group(3)) >= 1, out
    assert "store[prefill]: 0 hit /" in out
    assert "errors=0 (budget 0)" in out


@pytest.mark.parametrize("arch,kv", [("mistral-nemo-12b", 8),
                                     ("starcoder2-7b", 4),
                                     ("seamless-m4t-medium", 4),
                                     ("phi3.5-moe-42b-a6.6b", 4)])
def test_serve_generates_the_reference_ids(arch, kv, monkeypatch):
    """The reference's serve (its weights, prompts and, for an
    encoder-decoder configuration, source embeddings from ``--seed``; the
    shuffle on ``pallas``) and the port's serve loop on those inputs (the
    shuffle on ``cuda``): the same ids. Every routing decision of the MoE
    configuration clears a top-k margin of 1e-6 in the reference (the
    packages' float32 softmaxes may differ by an ulp)."""
    from repro.models import moe as RMoE
    margins = []
    real = RMoE.router_topk

    def spy(logits, k):
        top = jax.lax.top_k(jax.nn.softmax(logits.astype(jnp.float32), -1),
                            k + 1)[0]
        jax.debug.callback(lambda m: margins.append(float(np.min(m))),
                           top[..., k - 1] - top[..., k])
        return real(logits, k)

    monkeypatch.setattr(RMoE, "router_topk", spy)
    argv = ["--arch", arch, "--batch", "2", "--prompt-len", "8",
            "--tokens", "4", "--kv-heads", str(kv), "--seed", "3"]
    want = RS.main(argv + ["--head-shuffle", "pallas"])
    jax.effects_barrier()
    assert all(m > 1e-6 for m in margins)
    rcfg = dataclasses.replace(ref_reduce(ref_config(arch)), n_kv_heads=kv,
                               n_heads=max(4, kv), head_shuffle="pallas")
    key = jax.random.PRNGKey(3)
    params = params_from_numpy(jax.tree.map(np.asarray, RM.init(rcfg, key)),
                               "cpu")
    prompts = np.array(jax.random.randint(key, (2, 8), 0,
                                            rcfg.vocab_size))
    src = None
    if rcfg.is_encdec:
        src = params_from_numpy(np.asarray(jax.random.normal(
            key, (2, rcfg.src_len, rcfg.d_model), rcfg.dtype)), "cpu")
    args = TS.parse_args(argv + ["--head-shuffle", "cuda", "--device",
                                 "cpu"])
    cfg = TS.config_for(args)
    assert cfg.n_heads == rcfg.n_heads and cfg.head_shuffle == "cuda"
    got = TS.serve(cfg, params, args, torch.from_numpy(prompts).long(), src)
    assert not got.errors
    np.testing.assert_array_equal(got.gen, np.asarray(want))


@pytest.mark.parametrize("arch", ["seamless-m4t-medium",
                                  "llama-3.2-vision-90b"])
def test_serve_main_draws_source_embeddings(arch, capsys):
    """The port's ``main`` serves an encoder-decoder and a VLM
    configuration: the source embeddings come from ``--seed``
    (``make_src``), so two runs give the same ids and another seed's
    source another prefill."""
    argv = ["--arch", arch, "--batch", "2", "--prompt-len", "6",
            "--tokens", "3", "--device", "cpu"]
    a = TS.main(argv)
    b = TS.main(argv)
    assert a.shape == (2, 3)
    np.testing.assert_array_equal(a, b)
    args = TS.parse_args(argv)
    cfg = TS.config_for(args)
    src = TS.make_src(cfg, args, torch.device("cpu"))
    assert src.shape == (2, cfg.src_len, cfg.d_model)
    assert src.dtype == cfg.dtype
    other = TS.make_src(cfg, TS.parse_args(argv + ["--seed", "1"]),
                        torch.device("cpu"))
    assert not torch.equal(src, other)
    assert TS.make_src(TS.config_for(TS.parse_args(
        ["--arch", "mamba2-130m"])), args, torch.device("cpu")) is None
    assert "resilience: requests=" in capsys.readouterr().out


def test_sigterm_drill_drains_on_the_cpu():
    drill = chaos.sigterm_drill(timeout_s=60.0, device="cpu")
    assert drill["started"], drill["output"][-2000:]
    assert drill["ok"], drill["output"][-2000:]
