"""Multi-rank runs of the port on the CPU for its tests: ``gloo`` process
groups in spawned processes, joined over a ``file://`` store.

:func:`spawn` (the port's ``launch.mesh.spawn_gloo``) starts ``world``
ranks of ``fn(rank, world, *args)`` with ``torch.multiprocessing`` (the
spawn method), each with one CPU thread. Each rank reports through a
file: what ``fn`` returns (``torch.save``) or its traceback. A run that
outlives its time limit is killed and fails; it never hangs the test.
Workers live in modules that import neither JAX nor the reference (this
one, for the tests' workers), so a rank starts in about two seconds.
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import spawn_gloo as spawn  # noqa: F401


# ---------------------------------------------------------------------------
# Workers (each runs on every rank; it returns numpy results)
# ---------------------------------------------------------------------------

def _np(t):
    return t.detach().float().numpy().copy()


def a2a_worker(rank, world, jobs):
    """``moe_ffn_a2a`` for each ``(shape, name, inputs, cotangent,
    kwargs)`` of ``jobs`` on a mesh of ``shape`` ((data, model), or
    (pod, data, model) for three axes): output, aux and the gradients of
    ``sum(out * cotangent) + aux`` by x, router and expert weights."""
    from repro_torch.launch.mesh import make_dev_mesh, make_production_mesh
    from repro_torch.models.moe_a2a import moe_ffn_a2a

    meshes, out = {}, {}
    for shape, name, inputs, ct, kw in jobs:
        if shape not in meshes:
            meshes[shape] = (
                make_dev_mesh(*shape, device="cpu") if len(shape) == 2 else
                make_production_mesh(multi_pod=True, shape=shape[1:],
                                     device="cpu"))
        ts = [torch.tensor(a, requires_grad=True) for a in inputs]
        y, aux = moe_ffn_a2a(*ts, mesh=meshes[shape], **kw)
        ((y * torch.from_numpy(ct)).sum() + aux).backward()
        out[(shape, name)] = {"out": _np(y), "aux": _np(aux),
                              "grads": [_np(t.grad) for t in ts]}
    return out


def _route_margins(margins):
    """Spy on the port's router: record the top-k margin (k-th largest
    router probability less the (k+1)-th) of every routing call. Returns
    the function that takes the spy away."""
    from repro_torch.models import moe, moe_a2a
    real = moe.router_topk

    def spy(logits, k):
        p = torch.softmax(logits.detach().double(), -1)
        top = torch.topk(p, k + 1, dim=-1).values
        margins.append(float((top[..., k - 1] - top[..., k]).min()))
        return real(logits, k)
    moe.router_topk = moe_a2a.router_topk = spy

    def restore():
        moe.router_topk = moe_a2a.router_topk = real
    return restore


def model_worker(rank, world, arch, shape, params_np, toks, labels):
    """A smoke-sized ``arch`` on a ``shape`` mesh (``None``: no mesh):
    prefill logits, one greedy decode step, ``loss_fn`` and its gradients,
    one ``make_train_step`` step; the a2a branch's count in the prefill
    and the smallest router margin."""
    from repro_torch import obs
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    margins = []
    restore = _route_margins(margins)
    cfg = reduce_for_smoke(get_config(arch))
    mesh = None if shape is None else make_dev_mesh(*shape, device="cpu")
    try:
        params = params_from_numpy(params_np, "cpu")
        tokens = torch.from_numpy(toks).long()
        s = tokens.shape[1]
        obs.reset()
        obs.enable(sync=False)
        try:
            with torch.no_grad():
                logits, caches = M.prefill(cfg, params, {"tokens": tokens},
                                           mesh=mesh)
                a2a = obs.counter_value("model.moe_a2a")
                caches = M.grow_caches(caches, s, s + 1)
                tok = torch.argmax(logits[:, -1], -1)[:, None]
                dec, _ = M.decode_step(cfg, params, caches, tok, s,
                                       mesh=mesh)
            a2a_decode = obs.counter_value("model.moe_a2a") - a2a
        finally:
            obs.disable()
            obs.reset()
        batch = {"tokens": tokens, "labels": torch.from_numpy(labels).long()}
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss, parts = M.loss_fn(cfg, tree_unflatten(params, leaves), batch,
                                mesh=mesh)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        step, ocfg = make_train_step(cfg, mesh)
        params, _, m = step(params, adamw_init(params, ocfg), batch)
        return {"prefill": _np(logits), "decode": _np(dec),
                "tok": tok.numpy(), "loss": _np(loss),
                "aux": _np(parts["aux"]),
                "grads": tree_unflatten(params, [_np(g) for g in grads]),
                "step_loss": _np(m["loss"]),
                "stepped": tree_map(_np, params),
                "a2a_prefill": a2a, "a2a_decode": a2a_decode,
                "margin": min(margins)}
    finally:
        restore()
        if mesh is not None:
            mesh.close()


def bmmc_worker(rank, world, cases):
    """``distributed_bmmc`` on a binary mesh of ``world`` ranks for each
    ``(rows, c, n, x)``: this rank's shard of the output."""
    from repro_torch.core.bmmc import Bmmc
    from repro_torch.core.distributed import binary_mesh, distributed_bmmc

    s = world.bit_length() - 1
    mesh = binary_mesh(s, device="cpu")
    out = []
    for rows, c, n, x in cases:
        nl = n - s
        shard = torch.from_numpy(x[rank << nl:(rank + 1) << nl])
        out.append(distributed_bmmc(shard, Bmmc(rows, c), s, mesh).numpy())
    return out


def model_jobs_worker(rank, world, jobs):
    """:func:`model_worker` for each ``(arch, shape, params, toks,
    labels)`` of ``jobs``, in order."""
    return [model_worker(rank, world, *job) for job in jobs]


def with_subprocess(cmd, env, cwd, timeout, fn):
    """Run ``fn()`` while ``cmd`` (the reference's multi-device script)
    runs beside it; returns ``(fn's result, the script's stdout)``, and
    fails with the script's stderr if it fails or outlives ``timeout``."""
    import subprocess
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=cwd)
    try:
        got = fn()
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    return got, out
