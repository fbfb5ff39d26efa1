"""Device meshes over ``torch.distributed``: the counterpart of
:mod:`repro.launch.mesh`.

A :class:`Mesh` lays this job's ranks out row-major over named axes
(:func:`torch.distributed.device_mesh.init_device_mesh`), one rank a
device. It offers what the reference's code reads of a ``jax`` mesh,
``axis_names`` and ``shape`` (a dict from axis name to size), and what
the port's collectives need: the process group of one axis or of a
tuple of axes, and this rank's coordinate on each axis.

The device picks the backend: NCCL for ``"cuda"``, ``gloo`` for
``"cpu"`` (the CPU tests' multi-rank meshes). Neither falls back to the
other: a mesh on ``"cuda"`` over a ``gloo`` process group raises. The
caller initializes the default process group (``init_process_group``
with its address, world size and rank); for a mesh of one rank, the
mesh creates that single-rank group itself, on a file store in a fresh
temporary directory (no network), and :meth:`Mesh.close` destroys it.

A **dry-run mesh** (``dry_run=True``, asked for by name, never a
default) stands on torch's ``fake`` backend over a ``FakeStore``: one
process holds rank 0 of a world of ``prod(shape)`` ranks (256 or 512 for
the production meshes) and its collectives move nothing, so a trace of
:func:`repro_torch.launch.op_analysis.dry_run` counts what rank 0 would
exchange. It refuses to start while a process group is initialized,
:meth:`Mesh.close` destroys its group, and a real (non-fake) tensor
handed to a collective on it raises.

Meshes are made by functions, never at import: importing this module
touches no device and no process group.

:func:`spawn_gloo` runs a function on ``world`` ``gloo`` CPU ranks in
spawned processes, joined over a ``file://`` store (no network): the
multi-rank runs of the CPU tests and of the distributed example.
"""
from __future__ import annotations

import itertools
import math
import os
import shutil
import tempfile
import time
import traceback
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple, Union

import torch.distributed as dist

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}

Axes = Union[str, Sequence[str]]


class Mesh:
    """``shape`` ranks (row-major, the last axis fastest) named
    ``axis_names``, on ``device`` (``"cuda"``: NCCL, ``"cpu"``: gloo).
    The default process group must hold exactly ``prod(shape)`` ranks;
    with ``dry_run=True`` the mesh starts its own group on the ``fake``
    backend instead, as rank 0 (see the module docstring).
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 device: str = "cuda", dry_run: bool = False):
        shape, axis_names = tuple(int(v) for v in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(
                axis_names):
            raise ValueError(f"mesh shape {shape} and axis names "
                             f"{axis_names} do not match")
        if device not in _BACKENDS:
            raise ValueError(f"mesh device {device!r}: one of "
                             f"{sorted(_BACKENDS)}")
        backend = _BACKENDS[device]
        size = math.prod(shape)
        self._store_dir: Optional[str] = None
        self.dry_run = dry_run
        if dry_run:
            from torch.testing._internal.distributed.fake_pg import FakeStore
            if dist.is_initialized():
                raise RuntimeError("a dry-run mesh starts its own fake "
                                   "process group; one is initialized "
                                   "already")
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=size)
            backend = "fake"
        elif not dist.is_initialized():
            if size != 1:
                raise RuntimeError(
                    f"a {shape} mesh needs {size} ranks: initialize the "
                    f"default process group ({backend}) on each first")
            self._store_dir = tempfile.mkdtemp(prefix="repro_torch_mesh_")
            dist.init_process_group(
                backend, init_method="file://" + os.path.join(
                    self._store_dir, "store"), rank=0, world_size=1)
        try:
            self._layout(shape, axis_names, device, backend)
        except BaseException:
            self.close()
            raise

    def _layout(self, shape, axis_names, device, backend) -> None:
        from torch.distributed.device_mesh import init_device_mesh
        got = dist.get_backend()
        if got != backend:
            raise RuntimeError(f"a mesh on {device!r} needs the {backend} "
                               f"backend; the process group runs {got}")
        size = math.prod(shape)
        if dist.get_world_size() != size:
            raise ValueError(f"a {shape} mesh needs {size} ranks; the "
                             f"process group has {dist.get_world_size()}")
        self.device = device
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        # a fake world's groups serve tensors of either device: its mesh
        # is laid out on the host, where a CPU-only build can make one
        self.device_mesh = init_device_mesh(
            "cpu" if self.dry_run else device, shape,
            mesh_dim_names=axis_names)
        self.rank = dist.get_rank()
        # global ranks in row-major mesh order
        self._flat = self.device_mesh.mesh.flatten().tolist()
        coord = self.device_mesh.get_coordinate()
        self.coords: Dict[str, int] = dict(zip(axis_names, coord))
        self._groups = {(a,): self.device_mesh.get_group(a)
                        for a in axis_names}
        # groups of several axes, each subset in mesh order: every rank
        # creates every group, in one order
        for k in range(2, len(axis_names) + 1):
            for sub in itertools.combinations(axis_names, k):
                mine, _ = dist.new_subgroups_by_enumeration(
                    self._rank_sets(sub))
                self._groups[sub] = mine

    def _axes(self, axes: Axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        order = [self.axis_names.index(a) for a in axes]
        if order != sorted(order) or len(set(order)) != len(order):
            raise ValueError(f"axes {axes} must be distinct and in the "
                             f"mesh's order {self.axis_names}")
        return axes

    def size(self, axes: Axes) -> int:
        """The number of ranks along ``axes`` (1 for none)."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def index(self, axes: Axes, coords: Optional[Dict[str, int]] = None
              ) -> int:
        """The row-major index over ``axes`` of this rank (or of
        ``coords``): JAX's linear index over a tuple of axes."""
        coords = self.coords if coords is None else coords
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + coords[a]
        return idx

    def group(self, axes: Axes):
        """The process group of this rank's ranks along ``axes``; its
        group ranks run in the mesh's row-major order over ``axes``."""
        return self._groups[self._axes(axes)]

    def coords_of(self, rank: int) -> Dict[str, int]:
        """The coordinates of a global rank."""
        rest, out = self._flat.index(rank), {}
        for a in reversed(self.axis_names):
            rest, out[a] = divmod(rest, self.shape[a])
        return {a: out[a] for a in self.axis_names}

    def rank_of(self, coords: Dict[str, int]) -> int:
        """The global rank at ``coords``."""
        return self._flat[self.index(self.axis_names, coords)]

    def _rank_sets(self, axes: Tuple[str, ...]) -> list:
        """Every group of ranks that share their coordinates off ``axes``,
        each in row-major order over ``axes``."""
        rest = [a for a in self.axis_names if a not in axes]
        sets = []
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in rest)):
            base = dict(zip(rest, fixed))
            sets.append([self.rank_of({**base, **dict(zip(axes, var))})
                         for var in itertools.product(
                             *(range(self.shape[a]) for a in axes))])
        return sets

    def close(self) -> None:
        """Destroy the process group this mesh created (a single-rank
        group, or a dry run's fake world), if it did; a group the caller
        initialized stays theirs to destroy."""
        if self.dry_run:
            if dist.is_initialized():
                dist.destroy_process_group()
            self.dry_run = False
        if self._store_dir is not None:
            if dist.is_initialized():
                dist.destroy_process_group()
            shutil.rmtree(self._store_dir, ignore_errors=True)
            self._store_dir = None

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, device={self.device!r}, "
                f"rank={self.rank}{', dry run' if self.dry_run else ''})")


def make_production_mesh(*, multi_pod: bool = False, shape=None,
                         device: str = "cuda",
                         dry_run: bool = False) -> Mesh:
    """Default (16, 16) / (2, 16, 16); ``shape`` overrides the per-pod
    (data, model) factorization (e.g. (32, 8) for 40-head
    configurations). Raises unless the world holds that many ranks;
    ``dry_run=True`` makes that world on the fake backend."""
    if shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    elif multi_pod:
        shape = (2,) + tuple(shape)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(tuple(shape), axes, device=device, dry_run=dry_run)


def make_dev_mesh(n_data: int = 2, n_model: int = 2, *,
                  device: str = "cuda", dry_run: bool = False) -> Mesh:
    """A small (data, model) mesh: (1, 1) on one card, or ``gloo`` CPU
    ranks in the tests (or a fake world with ``dry_run=True``)."""
    return Mesh((n_data, n_model), ("data", "model"), device=device,
                dry_run=dry_run)


# ---------------------------------------------------------------------------
# Collectives on a mesh's groups
# ---------------------------------------------------------------------------

def _check_operand(x, group) -> None:
    """A collective on the fake backend moves nothing, so it takes fake
    tensors only: a real one would come back unfilled."""
    if dist.get_backend(group) == "fake":
        from .op_analysis import is_fake
        if not is_fake(x):
            raise RuntimeError("a real tensor handed to a collective of a "
                               "dry-run (fake) process group, which "
                               "moves no data")


def all_to_all(x, group):
    """JAX's ``all_to_all(split_axis=0, concat_axis=0, tiled=True)`` over
    ``group``: chunk j of axis 0 goes to group rank j; chunk i of the
    result came from group rank i."""
    _check_operand(x, group)
    x = x.contiguous()
    out = x.new_empty(x.shape)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_gather(x, group) -> list:
    """Every group rank's ``x``, in group-rank order. Over a group of one
    rank that is ``[x]`` itself: no collective and no copy (a gather of an
    expert weight over a one-wide dp axis would copy 0.8 GB a layer at
    phi's width)."""
    if dist.get_world_size(group) == 1:
        return [x]
    _check_operand(x, group)
    parts = [x.new_empty(x.shape) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def ordered_sum(parts):
    """``((0 + p_0) + p_1) + ...``: one order of summation on every rank."""
    out = parts[0].new_zeros(parts[0].shape)
    for p in parts:
        out = out + p
    return out


def all_sum(x, group):
    """An all-reduce (sum) whose terms are added in group-rank order, so
    every rank holds the same bits."""
    return ordered_sum(all_gather(x, group))


# ---------------------------------------------------------------------------
# gloo ranks on the CPU
# ---------------------------------------------------------------------------

def _gloo_entry(rank, fn, world, out_dir, args):
    import torch
    torch.set_num_threads(1)
    out = Path(out_dir)
    try:
        dist.init_process_group(
            "gloo", init_method="file://" + str(out / "store"), rank=rank,
            world_size=world)
        result = fn(rank, world, *args)
        dist.barrier()
        torch.save(result, out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_gloo(fn, world: int, out_dir, *args,
               timeout: float = 120.0) -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` gloo ranks, each a
    spawned process with one CPU thread, joined over a file store in
    ``out_dir``; returns each rank's result (``torch.save``), in rank
    order. ``fn`` must be importable by name. A rank's error (its
    traceback is in the message) or a run past ``timeout`` seconds raises
    ``AssertionError``; no rank outlives the call."""
    import torch
    import torch.multiprocessing as tmp
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    ctx = tmp.start_processes(_gloo_entry, args=(fn, world, str(out), args),
                              nprocs=world, join=False,
                              start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__} on {world} ranks "
                                   f"passed {timeout} s")
    except Exception as err:
        errs = [p.read_text() for p in sorted(out.glob("rank*.err"))]
        raise AssertionError(f"{fn.__name__} on {world} ranks failed: "
                             f"{err}\n" + "\n".join(errs)) from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]
