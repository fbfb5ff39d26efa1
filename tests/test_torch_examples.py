"""The port's example scripts (``examples/*_torch.py``) against the
reference's (``examples/*.py``), on the CPU.

* Each twin runs with ``--device cpu`` (the kernels' plain versions) at
  a small size: in this process, or in a subprocess for the launcher
  twins (``serve_batch``, ``train_lm``), which configure process-wide
  state. The distributed twin spawns 4 gloo ranks.
* The five kernel-facing twins are held to the reference example's
  functions on the same inputs: permutation outputs, sorts, gradients,
  class dispatch histograms, modeled counts and plan costs bit for bit
  (or equal), the FFT within ``FFT_REL_TOL`` of the reference's.
* A twin imports torch, numpy and ``repro_torch``, never JAX or
  ``repro``; ``--device cuda`` without a card and a failed self-check
  both exit non-zero.
"""
import ast
import importlib
import os
import random
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.combinators import compile_expr as r_compile_expr
from repro.combinators import fuse as r_fuse
from repro.combinators import lower as r_lower
from repro.combinators import num_perm_stages as r_num_perm_stages
from repro.combinators import vocab as RV
from repro.combinators.fft import compiled_fft as r_compiled_fft
from repro.combinators.fft import fft_expr as r_fft_expr
from repro.combinators.sort import compiled_sort as r_compiled_sort
from repro.combinators.sort import sort_expr as r_sort_expr
from repro.core import distributed as RD
from repro.core.bmmc import Bmmc as RBmmc
from repro.core.parm import parm as r_parm
from repro.kernels import ops as RO
from repro.kernels.ref import bmmc_ref as r_bmmc_ref
from repro.models.permute import PermuteLayer as RPermuteLayer

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
TWINS = ("quickstart", "sorting_network", "fft_pipeline", "grad_permute",
         "distributed_permute", "serve_batch", "train_lm")
# the float32 FFT of the two packages: the same butterflies and twiddles,
# summed in the same order; 1e-5 of the largest magnitude leaves room for
# a different rounding of a product
FFT_REL_TOL = 1e-5


def _twin(name):
    """The twin's module, imported from ``examples/`` (also importable by
    the processes the distributed twin spawns)."""
    if str(EXAMPLES) not in sys.path:
        sys.path.insert(0, str(EXAMPLES))
    return importlib.import_module(f"{name}_torch")


def _run_script(name, args, timeout=300):
    # one CPU thread: beside the other test workers, torch's default of a
    # thread per core oversubscribes the host many times over
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, str(EXAMPLES / f"{name}_torch.py")] + args,
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


def _quickstart(capsys):
    n = 12
    got = _twin("quickstart").main(["--device", "cpu", "--n", str(n)])
    assert "class dispatch histogram" in capsys.readouterr().out
    x = jnp.arange(1 << n, dtype=jnp.float32)
    tok = jnp.arange((1 << 10) * 8, dtype=jnp.bfloat16).reshape(1 << 10, 8)
    kernels = {}
    for name, (rows, c, t) in got["bmmc"].items():
        b = RBmmc(rows, c)
        src = tok if name == "row permute" else x
        want = np.asarray(r_bmmc_ref(src, b))
        have = got["outputs"][name]
        if name == "row permute":     # bfloat16: compare the bits
            assert np.array_equal(have.view(torch.int16).numpy(),
                                  want.view(np.int16)), name
        else:
            assert np.array_equal(have.numpy(), want), name
        kernels[name] = RO.class_plan(b, t)[0]
        assert got["kernel"][name] == kernels[name], name
        assert got["passes"][name] == RO.num_passes(b, t), name
    assert set(kernels.values()) >= {"block", "lane", "tiled", "general"}
    hist = {}
    for k in kernels.values():
        hist[k] = hist.get(k, 0) + 1
    assert got["histogram"] == hist
    rows, c, _ = got["bmmc"]["random BMMC"]
    assert got["tx"] == RO.modeled_transactions(RBmmc(rows, c), t=4)
    # the reference's own tiled kernel (interpret mode) on one matrix
    assert np.array_equal(
        got["outputs"]["random BMMC"].numpy(),
        np.asarray(RO.bmmc_permute(x, RBmmc(rows, c), t=4)))
    want = r_parm(0b0101, lambda h: jnp.cumsum(h, axis=0), x[:16])
    assert np.array_equal(got["parm"].numpy(), np.asarray(want))
    e = RV.riffle(n) >> RV.bit_reverse(n) >> RV.rev(n)
    assert got["stages"] == (r_num_perm_stages(r_lower(e, n)),
                             r_num_perm_stages(r_fuse(r_lower(e, n))))
    assert np.array_equal(got["outputs"]["combinator"].numpy(),
                          np.asarray(r_compile_expr(e, engine="ref")(x)))


def _sorting_network(capsys):
    n = 10
    got = _twin("sorting_network").main(["--device", "cpu", "--n", str(n)])
    assert "fused_fallback 0" in capsys.readouterr().out
    xs = np.random.default_rng(0).integers(0, 10**6, size=1 << n).astype(
        np.int32)
    want = np.asarray(r_compiled_sort(n, engine="ref")(jnp.asarray(xs)))
    assert np.array_equal(got["sorted"], want)
    assert np.array_equal(got["ref_sorted"], want)
    raw = r_lower(r_sort_expr(n), n)
    prog = r_fuse(raw)
    assert got["stages"] == (r_num_perm_stages(raw), r_num_perm_stages(prog),
                             len(prog) - r_num_perm_stages(prog))
    # one fused cluster run per cluster of the reference's program at the
    # same t (the port picks t = 5 for 2^10 int32 keys, as the reference)
    cost = r_compiled_sort(n).cost(n, 5, clustered=True)
    assert got["fused"] == cost["kernels"]["fused"]
    assert got["fused_fallback"] == 0


def _fft_pipeline(capsys):
    n = 10
    got = _twin("fft_pipeline").main(["--device", "cpu", "--n", str(n)])
    assert "FFT rel err vs np.fft" in capsys.readouterr().out
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(1 << n)
         + 1j * rng.standard_normal(1 << n)).astype(np.complex64)
    want = np.asarray(r_compiled_fft(n, engine="ref")(jnp.asarray(x)))
    scale = np.abs(want).max()
    assert np.abs(got["fft"] - want).max() / scale < FFT_REL_TOL
    assert np.abs(got["fft_ref"] - want).max() / scale < FFT_REL_TOL
    raw = r_lower(r_fft_expr(n), n)
    assert got["stages"] == (r_num_perm_stages(raw),
                             r_num_perm_stages(r_fuse(raw)))
    assert got["fused"] >= 1


def _grad_permute(capsys):
    n = 10
    got = _twin("grad_permute").main(["--device", "cpu", "--n", str(n)])
    assert "grad == P^-1(w): True" in capsys.readouterr().out
    rows, c = got["bmmc"]["program"]
    e = RV.bit_reverse(n) >> RV.perm(RBmmc(rows, c)) >> RV.riffle(n)
    f = r_compile_expr(e, engine="ref")
    x = jnp.asarray(np.random.default_rng(1).normal(size=1 << n),
                    jnp.float32)
    w = jnp.asarray(np.random.default_rng(2).normal(size=1 << n),
                    jnp.float32)
    g = jax.grad(lambda v: jnp.sum(w * f(v)))(x)
    assert np.array_equal(got["grad"].numpy(), np.asarray(g))
    keys = jnp.asarray(np.random.default_rng(4).permutation(1 << n),
                       jnp.float32)
    sort = r_compiled_sort(n, engine="ref")
    gs = jax.grad(lambda v: jnp.sum(w * sort(v)))(keys)
    assert np.array_equal(got["sort_grad"].numpy(), np.asarray(gs))
    rows, c = got["bmmc"]["layer"]
    layer = RPermuteLayer(RBmmc(rows, c), axis=1, engine="ref")
    target = jnp.asarray(np.random.default_rng(3).normal(size=(4, 1 << n)),
                         jnp.float32)
    y_obs = layer(target)
    loss = lambda p: jnp.sum((layer(p) - y_obs) ** 2)  # noqa: E731
    params = jnp.zeros_like(target)
    params = params - 0.5 * jax.grad(loss)(params)
    assert np.array_equal(got["recovered"].numpy(), np.asarray(params))
    # the same matrices as the reference example draws from its rng
    rng = random.Random(0)
    assert RBmmc.random(n, rng).rows == got["bmmc"]["program"][0]
    assert RBmmc.random(n, rng).rows == got["bmmc"]["layer"][0]


def _distributed_permute(capsys):
    n, s = 10, 2
    mod = _twin("distributed_permute")
    got = mod.main(["--device", "cpu", "--n", str(n), "--s", str(s)])
    assert "on 4 gloo ranks  correct=True" in capsys.readouterr().out
    x = jnp.arange(1 << n, dtype=jnp.float32)
    for name, b in mod.cases(n):
        rb = RBmmc(b.rows, b.c)
        assert got["cost"][name] == RD.plan_cost(RD.make_plan(rb, s)), name
        assert np.array_equal(got["outputs"][name].numpy(),
                              np.asarray(r_bmmc_ref(x, rb))), name


def _serve_batch(capsys):
    res = _run_script("serve_batch", ["--device", "cpu"])
    assert res.returncode == 0, res.stdout + res.stderr
    out = res.stdout
    assert "disk-warm boot: 0 plan(s) compiled" in out
    assert out.count("guard: traps=0") == 2
    ids = [ln for ln in out.splitlines() if ln.startswith("generated ids")]
    assert len(ids) == 2 and ids[0] == ids[1]


def _train_lm(capsys):
    res = _run_script("train_lm", ["--device", "cpu", "--steps", "20"])
    assert res.returncode == 0, res.stdout + res.stderr
    assert "resumed from step 10" in res.stdout
    assert "resumed at step 10: 2 shared steps bit-equal" in res.stdout
    assert "final loss" in res.stdout


@pytest.mark.parametrize("name", TWINS)
def test_twin_runs_on_the_cpu_and_agrees_with_the_reference(name, capsys):
    globals()[f"_{name}"](capsys)


@pytest.mark.parametrize("name", TWINS)
def test_twin_imports_no_jax_and_no_reference(name):
    path = EXAMPLES / f"{name}_torch.py"
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, (path, node.module)
            tops.add(node.module.split(".")[0])
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "repro"}, (path, tops)


def test_every_example_has_a_twin():
    refs = sorted(p.stem for p in EXAMPLES.glob("*.py")
                  if not p.stem.endswith("_torch"))
    assert refs == sorted(TWINS)
    for name in TWINS:
        assert (EXAMPLES / f"{name}_torch.py").is_file()


@pytest.mark.parametrize("name", TWINS)
def test_cuda_without_a_card_is_refused(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as err:
        _twin(name).main(["--device", "cuda"])
    assert err.value.code not in (0, None)
    assert "no CUDA device" in str(err.value.code)


def test_a_failed_self_check_exits_nonzero(monkeypatch):
    """A wrong kernel output fails the script's own check."""
    mod = _twin("quickstart")
    monkeypatch.setattr(mod, "bmmc_ref", lambda x, b: x)
    with pytest.raises(SystemExit) as err:
        mod.main(["--device", "cpu", "--n", "8"])
    assert "self-check failed" in str(err.value.code)
    res = subprocess.run(
        [sys.executable, "-c", "from repro_torch.launch.cli import check; "
         "check(False, 'demo')"], cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=120)
    assert res.returncode == 1 and "self-check failed: demo" in res.stderr


def test_chip_smoke_runs_every_twin():
    """``chip_smoke.py``'s examples phase names every twin."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = [node for node in ast.walk(tree) if isinstance(node, ast.Assign)
             and any(getattr(t, "id", None) == "EXAMPLE_TWINS"
                     for t in node.targets)]
    assert names, "chip_smoke.py has no EXAMPLE_TWINS"
    got = ast.literal_eval(names[0].value)
    assert sorted(got) == sorted(f"{n}_torch.py" for n in TWINS)
