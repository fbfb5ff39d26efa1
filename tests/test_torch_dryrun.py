"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``), on the CPU.

* **Analytic parity**: ``input_specs`` shapes and types, the batch's
  specs, ``model_flops``, ``skip_reason``, ``n_params``,
  ``n_active_params`` and the per-device
  bytes of parameters, optimizer state and caches under the sharding
  specs equal the reference's ``build_cell`` exactly, for all ten
  configurations x four shapes at ``pod16x16``, and at ``pod2x16x16``
  and ``--mesh-shape 32x8`` for Mistral-NeMo and phi.
* **Dot FLOPs at smoke size**: the port's dry run on a fake one-rank
  world equals ``analyze_hlo(...)["dot_flops"]`` of the reference's
  jitted step on one CPU device (a (1, 1) mesh, so phi takes the
  all-to-all branch in both), for prefill, decode and train of
  Mistral-NeMo and phi: equal, with no difference to name.
* A counter over a real training step on a one-rank gloo mesh counts as
  the dry run does.
* **Records**: ``run_cell`` writes the listed keys, skips ``long_500k``
  on a full-attention configuration, and records ``error`` for a cell
  made to fail.

The reference runs once for the file, in one subprocess with 512 host
devices (its device count is locked at first import), as
``tests/test_hlo_analysis.py`` runs its own.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, get_config, reduce_for_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_dev_mesh, make_production_mesh
from repro_torch.launch.op_analysis import COLLECTIVE_KINDS, OpCounter

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("chatglm3-6b", "kimi-k2-1t-a32b", "llama-3.2-vision-90b",
         "mamba2-130m", "mistral-nemo-12b", "phi3.5-moe-42b-a6.6b",
         "qwen1.5-32b", "recurrentgemma-2b", "seamless-m4t-medium",
         "starcoder2-7b")
MORE = ("mistral-nemo-12b", "phi3.5-moe-42b-a6.6b")
CELLS = ([(a, s, False, None) for a in ARCHS for s in SHAPES]
         + [(a, s, mp, ms) for a in MORE for s in SHAPES
            for mp, ms in ((True, None), (False, (32, 8)))])
SMOKE = [(a, k) for a in MORE for k in ("prefill", "decode", "train")]
B, S = 2, 16                              # smoke batch and sequence

REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax, jax.numpy as jnp
from repro.configs import SHAPES, get_config, reduce_for_smoke
from repro.launch import dryrun as D
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.mesh import make_production_mesh
from repro.models import model as M
from repro.models.layers import shape_tree
from repro.models.transformer import stack_cache_defs
from repro.optim.adamw import AdamWConfig
from repro.train.serve import make_decode_step, make_prefill_step
from repro.train.step import make_train_step, opt_state_shapes
cells, smoke, B, S = json.loads(sys.argv[1])
out = {"analytic": {}, "smoke": {}}
meshes = {}
for arch, sname, mp, ms in cells:
    cfg, shape = get_config(arch), SHAPES[sname]
    key = (mp, None if ms is None else tuple(ms))
    if key not in meshes:
        meshes[key] = make_production_mesh(multi_pod=mp, shape=key[1])
    r = {"model_flops": D.model_flops(cfg, shape), "n_params": cfg.n_params(),
         "n_active_params": cfg.n_active_params(),
         "skip": D.skip_reason(cfg, shape),
         "inputs": {k: [list(v.shape), str(v.dtype)]
                    for k, v in D.input_specs(cfg, shape).items()}}
    if r["skip"] is None:
        r.update(D.build_cell(cfg, shape, meshes[key])[-1])
        r["batch_specs"] = {
            k: list(v.spec) for k, v in D.batch_shardings(
                meshes[key], D.input_specs(cfg, shape)).items()}
    out["analytic"][repr((arch, sname, mp, key[1]))] = r
kw = ({"axis_types": (jax.sharding.AxisType.Auto,) * 2}
      if hasattr(jax.sharding, "AxisType") else {})
mesh = jax.make_mesh((1, 1), ("data", "model"), **kw)
for arch, kind in smoke:
    cfg = reduce_for_smoke(get_config(arch))
    p = M.param_shapes(cfg)
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    if kind == "prefill":
        fn, args = make_prefill_step(cfg, mesh), (p, {"tokens": tok})
    elif kind == "decode":
        fn = make_decode_step(cfg, mesh)
        args = (p, shape_tree(stack_cache_defs(cfg, B, S)),
                jax.ShapeDtypeStruct((B, 1), jnp.int32),
                jax.ShapeDtypeStruct((), jnp.int32))
    else:
        oc = AdamWConfig(state_bits=cfg.opt_bits)
        fn = make_train_step(cfg, mesh, oc)[0]
        args = (p, opt_state_shapes(cfg, p, oc),
                {"tokens": tok, "labels": tok})
    hlo = jax.jit(fn).lower(*args).compile().as_text()
    out["smoke"][repr((arch, kind))] = analyze_hlo(hlo)["dot_flops"]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", REFERENCE,
         json.dumps([CELLS, SMOKE, B, S])], capture_output=True,
        text=True, env=env, cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture
def no_group():
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch,shape_name,multi_pod,mesh_shape", CELLS)
def test_analytic_fields_equal_the_reference(reference, no_group, arch,
                                             shape_name, multi_pod,
                                             mesh_shape):
    want = reference["analytic"][repr((arch, shape_name, multi_pod,
                                       mesh_shape))]
    cfg, shape = get_config(arch), SHAPES[shape_name]
    got = {"model_flops": D.model_flops(cfg, shape),
           "n_params": cfg.n_params(),
           "n_active_params": cfg.n_active_params(),
           "skip": D.skip_reason(cfg, shape),
           "inputs": {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
                      for k, v in D.input_specs(cfg, shape).items()}}
    if got["skip"] is None:
        mesh = make_production_mesh(multi_pod=multi_pod, shape=mesh_shape,
                                    device="cpu", dry_run=True)
        try:
            got.update(D.build_cell(cfg, shape, mesh)[-1])
            got["batch_specs"] = {
                k: list(v) for k, v in D.batch_shardings(
                    mesh, D.input_specs(cfg, shape)).items()}
        finally:
            mesh.close()
    assert json.loads(json.dumps(got)) == want     # tuples as JSON lists


def _smoke_cell(arch, kind, **replace):
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)), **replace)
    return cfg, ShapeConfig("smoke", S, B, kind)


def _dry(cfg, shape):
    mesh = make_dev_mesh(1, 1, device="cpu", dry_run=True)
    try:
        fn, args, _ = D.build_cell(cfg, shape, mesh)
        return D.trace_step(fn, args, shape.kind).result()
    finally:
        mesh.close()


@pytest.mark.parametrize("arch,kind", SMOKE)
def test_smoke_dot_flops_equal_the_reference(reference, no_group, arch,
                                             kind):
    """Every product of the port's step is one the reference's HLO holds
    (remat's recompute and every backward product included): no
    difference to name."""
    got = _dry(*_smoke_cell(arch, kind))
    assert got["dot_flops"] == reference["smoke"][repr((arch, kind))]


def test_a_real_run_on_gloo_counts_as_the_dry_run(no_group):
    """Phi at smoke width, a training step on a (1, 1) gloo mesh under a
    counter (real tensors; parameters and optimizer state held) and its
    dry run: dot FLOPs and collective bytes equal. The peaks differ by
    RoPE's frequency tables alone: a real run makes each from numpy with
    no aten op (``torch.as_tensor``), so no counter sees it, and the dry
    run fakes it with one; 2 layers x (q, k) x 8 float32."""
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import make_train_step
    cfg, shape = _smoke_cell("phi3.5-moe-42b-a6.6b", "train")
    dry = _dry(cfg, shape)
    mesh = make_dev_mesh(1, 1, device="cpu")
    try:
        params = M.init(cfg, torch.Generator().manual_seed(0))
        oc = AdamWConfig(state_bits=cfg.opt_bits)
        opt = adamw_init(params, oc)
        tok = torch.randint(0, cfg.vocab_size, (B, S),
                            generator=torch.Generator().manual_seed(1),
                            dtype=torch.int32)
        batch = {"tokens": tok, "labels": tok}
        step, _ = make_train_step(cfg, mesh, oc)
        with OpCounter() as c:
            c.hold(params, opt.m, opt.v, opt.step, batch)
            step(params, opt, batch)
    finally:
        mesh.close()
    real = c.result()
    for k in COLLECTIVE_KINDS + ("dot_flops",):
        assert real[k] == dry[k], k
    assert dry["peak_bytes"] - real["peak_bytes"] == \
        cfg.n_layers * 2 * (cfg.hd // 2) * 4


def _keys(rec):
    return set(rec), set(rec.get("op_analysis", {})), set(
        rec.get("memory", {}))


def test_run_cell_writes_the_record(tmp_path, no_group):
    """Mistral-NeMo ``decode_32k`` on a fake 256-rank world: the record's
    keys, and the kv cache it holds whole (40 layers x k and v x 128 x
    32768 x 8 x 128 bfloat16)."""
    rec = D.run_cell("mistral-nemo-12b", "decode_32k", False, str(tmp_path))
    top, ops, mem = _keys(rec)
    assert top == {"arch", "shape", "mesh", "n_devices", "kind",
                   "model_flops", "n_params", "n_active_params",
                   "param_bytes_per_device", "cache_bytes_per_device",
                   "trace_s", "op_analysis", "memory"}
    assert ops == set(COLLECTIVE_KINDS) | {
        "collective_total", "dot_flops", "kernel_launches", "peak_bytes",
        "ops"}
    assert mem == {"held_param_bytes", "held_opt_bytes", "held_cache_bytes",
                   "peak_bytes", "fits_hbm"}
    assert rec["mesh"] == "pod16x16" and rec["n_devices"] == 256
    assert rec["memory"]["held_cache_bytes"] == \
        40 * 2 * 128 * 32768 * 8 * 128 * 2
    assert rec["memory"]["peak_bytes"] > rec["memory"]["held_cache_bytes"]
    assert rec["memory"]["fits_hbm"] is False
    saved = json.loads((tmp_path / "mistral-nemo-12b__decode_32k__pod16x16"
                        ".json").read_text())
    assert _keys(saved) == (top, ops, mem)
    # resumed: the record is read back, not traced again
    assert D.run_cell("mistral-nemo-12b", "decode_32k", False,
                      str(tmp_path)) == saved


def test_run_cell_skips_long_500k_on_full_attention(tmp_path, no_group):
    D.main(["--arch", "mistral-nemo-12b", "--shape", "long_500k",
            "--outdir", str(tmp_path)])
    for mesh in ("pod16x16", "pod2x16x16"):
        rec = json.loads((tmp_path / f"mistral-nemo-12b__long_500k__{mesh}"
                          ".json").read_text())
        assert rec["skipped"].startswith("skipped (full attention)")
        assert "op_analysis" not in rec


def test_run_cell_records_an_error(tmp_path, no_group, monkeypatch):
    def broken(*a, **k):
        raise ValueError("made to fail")
    monkeypatch.setattr(D, "build_cell", broken)
    rec = D.run_cell("phi3.5-moe-42b-a6.6b", "train_4k", True, str(tmp_path))
    assert rec["error"] == "ValueError: made to fail"
    assert "made to fail" in rec["traceback"]
    assert rec["mesh"] == "pod2x16x16" and not dist.is_initialized()
