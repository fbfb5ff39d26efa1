"""Dry run: one step of every (configuration x shape x production mesh)
cell, traced on fake tensors over a fake 256/512-rank world, recording
what one rank of the port computes, exchanges, launches and holds.

The counterpart of :mod:`repro.launch.dryrun`, under its names. The
reference lowers and compiles each step for 256/512 placeholder devices
and reads XLA's analyses and the partitioned HLO. The port has no
compiler between it and the card: it runs the step itself, rank 0 of a
fake world (:func:`repro_torch.launch.mesh.make_production_mesh` with
``dry_run=True``), on fake tensors (``FakeTensorMode``: shapes, types, no
memory), under an :class:`~repro_torch.launch.op_analysis.OpCounter`.
A record holds:

* the reference's analytic fields, computed alike from the port's
  specs (:mod:`repro_torch.parallel.sharding`): ``model_flops``,
  ``n_params``, ``n_active_params`` and the per-device bytes of
  parameters, optimizer state and caches *under those specs*;
* ``trace_s`` (building the cell and running its step), where the
  reference records ``lower_s`` and ``compile_s``;
* ``op_analysis`` (where the reference has ``hlo_analysis``): rank 0's
  dot FLOPs, collective bytes by kind, kernel launches by name and
  schedule, aten calls, the peak of live storages;
* ``memory``: what the port's rank actually holds (``held_param_bytes``,
  ``held_opt_bytes``, ``held_cache_bytes``: whole tensors, since the
  port replicates parameters, optimizer state and caches on every rank
  outside the all-to-all MoE body), ``peak_bytes`` and ``fits_hbm``
  against :data:`repro_torch.launch.hw.HBM_BYTES`.

The fake tensors live on the host (``TRACE_DEVICE``): a CPU-only build
cannot run autograd on fake ``cuda`` tensors. They stand for the card:
inside a dry run a kernel wrapper counts the launch the card would make
whatever the fake tensor's device (:mod:`repro_torch.kernels.
bmmc_permute`). ``chip_smoke.py`` (phase 19) holds these counts against a
real run on the H100.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mistral-nemo-12b --shape decode_32k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both    # all 80 cells

Records go to ``experiments/dryrun_torch/`` (``--outdir`` or
``DRYRUN_OUT``), one JSON file a cell, under the reference's cell ids
(``DRYRUN_REMAT``, ``DRYRUN_SP`` and ``DRYRUN_MOE`` override the
configuration as there). A cell that fails records ``error`` and
``traceback``: a failing cell is a bug.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Optional

import torch

from ..configs import ARCHS, SHAPES, get_config
from ..configs.base import ArchConfig, ShapeConfig
from ..models import model as M
from ..models.layers import axes_tree, shape_tree
from ..models.transformer import stack_cache_defs
from ..optim.adamw import AdamWConfig, AdamWState, ShapeDtype, state_shapes
from ..parallel.sharding import batch_spec, param_shardings, spec_for
from ..train.serve import make_decode_step, make_prefill_step
from ..train.step import make_train_step, opt_state_shapes
from . import hw
from .mesh import make_production_mesh
from .op_analysis import dry_run

OUTDIR_DEFAULT = "experiments/dryrun_torch"
TRACE_DEVICE = "cpu"        # where the fake tensors live (see above)


# ---------------------------------------------------------------------------
# Input specs (meta-tensor stand-ins; no allocation)
# ---------------------------------------------------------------------------

def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict:
    """Batch inputs for one step of the given kind, as ``meta`` tensors
    (the reference's ``ShapeDtypeStruct``s: the same shapes and types);
    the dry run makes fake tensors of them."""
    b = shape.global_batch

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")
    if shape.kind == "train":
        s = shape.seq_len
        batch = {"tokens": spec((b, s), torch.int32),
                 "labels": spec((b, s), torch.int32)}
    elif shape.kind == "prefill":
        batch = {"tokens": spec((b, shape.seq_len), torch.int32)}
    else:  # decode: one new token against a cache of seq_len
        batch = {"tokens": spec((b, 1), torch.int32)}
    if (cfg.is_encdec or cfg.family == "vlm") and shape.kind != "decode":
        batch["src"] = spec((b, cfg.src_len, cfg.d_model), cfg.dtype)
    return batch


def batch_shardings(mesh, batch: Dict) -> Dict:
    return {k: batch_spec(mesh, v.shape[0], v.dim())
            for k, v in batch.items()}


def _opt_shardings(mesh, pshapes, paxes, opt_cfg: AdamWConfig):
    osh = state_shapes(pshapes, opt_cfg)
    if opt_cfg.state_bits == 8:
        # quantized moments keep the parameter's leading dims (blocks run
        # along the last axis), so they take the parameter's spec with
        # the trailing (blocks, block) / (blocks, 1) dims replicated
        def rec(sh, ax):
            if isinstance(sh, dict) and set(sh) == {"q", "s"}:
                lead = tuple(ax[:-1]) if ax else ()
                return {k: spec_for(mesh, lead + (None, None), sh[k].shape)
                        for k in ("q", "s")}
            return {k: rec(sh[k], ax[k]) for k in sh}
        return AdamWState(step=(), m=rec(osh.m, paxes), v=rec(osh.v, paxes))
    pshard = param_shardings(mesh, pshapes, paxes)
    return AdamWState(step=(), m=pshard, v=pshard)


def _pairs(shapes, specs):
    """(leaf, its spec) over a tree of dicts and ``AdamWState``s whose
    leaves have a ``.shape`` (meta tensors, ``ShapeDtype``)."""
    if hasattr(shapes, "shape") and hasattr(shapes, "dtype"):
        yield shapes, specs
    elif isinstance(shapes, dict):
        for k in sorted(shapes):
            yield from _pairs(shapes[k], specs[k])
    else:                                   # AdamWState
        for s, h in zip(shapes, specs):
            yield from _pairs(s, h)


def _sharded_bytes(sds, spec, mesh) -> float:
    """Per-device bytes of one array under its spec."""
    shards = 1
    for entry in spec:
        if entry is None:
            continue
        for n in (entry if isinstance(entry, tuple) else (entry,)):
            shards *= mesh.shape[n]
    return (sds.dtype.itemsize * float(math.prod(sds.shape))) / shards


def _tree_bytes(shapes, specs, mesh) -> float:
    return sum(_sharded_bytes(s, h, mesh) for s, h in _pairs(shapes, specs))


def _leaves(tree):
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:                                   # AdamWState
        for v in tree:
            yield from _leaves(v)


def _whole_bytes(tree) -> int:
    """Bytes of every leaf whole: what a rank of the port holds."""
    return sum(s.dtype.itemsize * math.prod(s.shape) for s in _leaves(tree))


# ---------------------------------------------------------------------------
# Cell construction
# ---------------------------------------------------------------------------

def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
               grad_accum: int = 1):
    """Returns ``(fn, args, analytic)``: the step, its arguments as
    stand-ins (``meta`` tensors and ``ShapeDtype`` leaves; ``pos`` an
    int), and the reference's analytic fields under the port's specs."""
    pshapes = M.param_shapes(cfg)
    paxes = M.param_axes(cfg)
    pshard = param_shardings(mesh, pshapes, paxes)
    batch = input_specs(cfg, shape)
    analytic = {"param_bytes_per_device": _tree_bytes(pshapes, pshard, mesh)}

    if shape.kind == "train":
        opt_cfg = AdamWConfig(state_bits=cfg.opt_bits)
        oshapes = opt_state_shapes(cfg, pshapes, opt_cfg)
        oshard = _opt_shardings(mesh, pshapes, paxes, opt_cfg)
        analytic["opt_bytes_per_device"] = _tree_bytes(oshapes, oshard, mesh)
        step_fn, _ = make_train_step(cfg, mesh, opt_cfg,
                                     grad_accum=grad_accum)
        return step_fn, (pshapes, oshapes, batch), analytic

    cdefs = stack_cache_defs(cfg, shape.global_batch, shape.seq_len)
    cshapes = shape_tree(cdefs)
    cshard = param_shardings(mesh, cshapes, axes_tree(cdefs))
    analytic["cache_bytes_per_device"] = _tree_bytes(cshapes, cshard, mesh)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, mesh), (pshapes, batch), analytic
    # decode: the last position of a full cache
    return (make_decode_step(cfg, mesh),
            (pshapes, cshapes, batch["tokens"], shape.seq_len - 1), analytic)


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """6*N*D (train) / 2*N*D (inference); N = active params for MoE."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # one token per sequence


def skip_reason(cfg: ArchConfig, shape: ShapeConfig) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("skipped (full attention): 500k-token decode requires "
                "sub-quadratic attention; this arch is full-attention "
                "(see DESIGN.md §4)")
    return None


def _materialize(tree, device: str):
    """Stand-ins as tensors on ``device`` (fake inside a dry run)."""
    if isinstance(tree, (torch.Tensor, ShapeDtype)):
        return torch.empty(tuple(tree.shape), dtype=tree.dtype,
                           device=device)
    if isinstance(tree, dict):
        return {k: _materialize(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_materialize(v, device) for v in tree)) \
            if hasattr(tree, "_fields") else \
            tuple(_materialize(v, device) for v in tree)
    return tree


def trace_step(fn, args, kind: str):
    """Run ``fn`` once on fake tensors made from the stand-ins ``args`` in
    a dry run; returns the counter (inference under ``no_grad``, as the
    port serves)."""
    with dry_run() as counter:
        fake = _materialize(args, TRACE_DEVICE)
        with torch.set_grad_enabled(kind == "train"):
            out = fn(*fake)
        del out, fake
    return counter


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, multi_pod: bool, outdir: str,
             resume: bool = True, mesh_shape=None, grad_accum: int = 1
             ) -> Dict:
    cfg = get_config(arch)
    remat = os.environ.get("DRYRUN_REMAT")
    if remat:
        cfg = dataclasses.replace(cfg, remat_policy=remat)
    sp_env = os.environ.get("DRYRUN_SP")
    if sp_env is not None:
        cfg = dataclasses.replace(cfg, seq_parallel=sp_env not in ("0", "off"))
    moe_impl = os.environ.get("DRYRUN_MOE")
    if moe_impl:
        cfg = dataclasses.replace(cfg, moe_impl=moe_impl)
    shape = SHAPES[shape_name]
    if mesh_shape is None:
        mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    else:
        base = "x".join(str(d) for d in mesh_shape)
        mesh_name = f"pod2x{base}" if multi_pod else f"pod{base}"
    cell_id = f"{arch}__{shape_name}__{mesh_name}"
    if grad_accum > 1:
        cell_id += f"__ga{grad_accum}"
    if remat:
        cell_id += f"__remat-{remat}"
    if sp_env is not None:
        cell_id += "__sp" if cfg.seq_parallel else "__nosp"
    if moe_impl:
        cell_id += f"__moe-{moe_impl}"
    path = os.path.join(outdir, cell_id + ".json")
    if resume and os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
        if "error" not in rec:
            print(f"[skip: done] {cell_id}")
            return rec

    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "n_devices": 512 if multi_pod else 256,
                 "kind": shape.kind,
                 "model_flops": model_flops(cfg, shape),
                 "n_params": cfg.n_params(),
                 "n_active_params": cfg.n_active_params()}
    reason = skip_reason(cfg, shape)
    if reason:
        rec["skipped"] = reason
        _save(path, rec)
        print(f"[skip: design] {cell_id}: {reason}")
        return rec

    try:
        mesh = make_production_mesh(multi_pod=multi_pod, shape=mesh_shape,
                                    device=TRACE_DEVICE, dry_run=True)
        try:
            t0 = time.time()
            fn, args, analytic = build_cell(cfg, shape, mesh,
                                            grad_accum=grad_accum)
            rec.update(analytic)
            counter = trace_step(fn, args, shape.kind)
            rec["trace_s"] = time.time() - t0
        finally:
            mesh.close()
        ops = counter.result()
        rec["op_analysis"] = ops
        caches = (None if shape.kind == "train" else shape_tree(
            stack_cache_defs(cfg, shape.global_batch, shape.seq_len)))
        rec["memory"] = {
            "held_param_bytes": _whole_bytes(args[0]),
            "held_opt_bytes": (_whole_bytes(args[1])
                               if shape.kind == "train" else 0),
            "held_cache_bytes": 0 if caches is None else _whole_bytes(caches),
            "peak_bytes": ops["peak_bytes"],
            "fits_hbm": ops["peak_bytes"] <= hw.HBM_BYTES}
        print(f"[ok] {cell_id}: trace {rec['trace_s']:.1f}s  "
              f"dot_flops/rank {ops['dot_flops']:.3e}  "
              f"coll/rank {ops['collective_total']:.3e}B  "
              f"peak {ops['peak_bytes'] / 1e9:.1f} GB")
    except Exception as e:  # record the failure; a failing cell is a bug
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {cell_id}: {rec['error']}")
    _save(path, rec)
    return rec


def _save(path: str, rec: Dict):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=float)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--outdir", default=os.environ.get("DRYRUN_OUT",
                                                       OUTDIR_DEFAULT))
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--mesh-shape", default=None,
                    help="override per-pod (data,model), e.g. 32x8")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--remat", default=None, choices=[None, "nothing", "dots"])
    args = ap.parse_args(argv)
    if args.remat:
        os.environ["DRYRUN_REMAT"] = args.remat
    mesh_shape = (tuple(int(d) for d in args.mesh_shape.split("x"))
                  if args.mesh_shape else None)

    archs = sorted(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    t0 = time.time()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                run_cell(arch, shape, mp, args.outdir,
                         resume=not args.no_resume, mesh_shape=mesh_shape,
                         grad_accum=args.grad_accum)
    print(f"dry run: {len(archs) * len(shapes) * len(meshes)} cells in "
          f"{time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
