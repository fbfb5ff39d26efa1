"""Op counts of the port's programs: collective bytes, dot FLOPs, kernel
launches and the peak of live storages.

The counterpart of :mod:`repro.launch.hlo_analysis`. The reference
parses the partitioned HLO text XLA compiles for one device; the port
has no such text, so :class:`OpCounter` (a ``TorchDispatchMode``)
counts the ops the port dispatches while a program runs, on one rank:

* every ``c10d`` collective contributes its local operand's bytes, by
  kind (``all-gather``, ``all-reduce``, ``reduce-scatter``,
  ``all-to-all``; a point-to-point ``send`` counts as
  ``collective-permute``);
* every matrix product (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  ``addbmm``, ``mv``, ``addmv``, ``dot``: what ``@``, ``matmul``,
  ``einsum`` and autograd's backward of them reach) contributes
  ``2 * prod(out) * contracted`` FLOPs; elementwise work is not counted,
  as ``analyze_hlo`` counts ``dot`` ops only;
* **trip weighting**: PyTorch runs eagerly, so every iteration of a
  loop (layers, KV blocks, chunks, remat's recompute) dispatches its ops
  again and is counted again. The count is trip-weighted by
  construction, where the reference reads ``known_trip_count`` off each
  ``while`` loop;
* **kernel launches** (the counterpart of the Pallas custom calls in
  the HLO): each hand-written kernel's launches under its name and
  schedule (``tile_wide``, ``tile_narrow``, ``tile_fused``,
  ``tile_bwd``, ``copy_words``, ``block``, ``lane``, the guarded
  variants) with the bytes each moves (each tensor operand read once,
  each output written once; the index tables left out). The kernel
  wrappers of :mod:`repro_torch.kernels.bmmc_permute` report them: a
  real launch when a counter is active, and inside a dry run the launch
  the card would make;
* **memory**: the bytes of every storage an op creates (``meta``
  stand-ins aside), live until the storage dies, plus what
  :meth:`OpCounter.hold` registers; ``peak_bytes`` is their peak.

All quantities are per rank. A **dry run** (:func:`dry_run`) is a
counter over ``FakeTensorMode``: tensors carry shapes, types and devices
but no memory, so a full-size step of any configuration runs on one host
and counts what one rank of the card would compute, exchange, launch and
hold. Entering a counter costs nothing to a program that runs without
one: the kernel wrappers test the length of the dispatch-mode stack.
"""
from __future__ import annotations

import collections
import contextlib
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# c10d op -> (kind, the argument that holds this rank's operand)
_C10D = {
    "c10d::allreduce_": ("all-reduce", 0),
    "c10d::allreduce_coalesced_": ("all-reduce", 0),
    "c10d::allgather_": ("all-gather", 1),
    "c10d::_allgather_base_": ("all-gather", 1),
    "c10d::allgather_coalesced_": ("all-gather", 1),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d::reduce_scatter_": ("reduce-scatter", 1),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d::reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "c10d::alltoall_": ("all-to-all", 1),
    "c10d::alltoall_base_": ("all-to-all", 1),
    "c10d::send": ("collective-permute", 0),
}

_aten = torch.ops.aten
# product -> the positions of its two factors
_DOTS = {_aten.mm.default: (0, 1), _aten.bmm.default: (0, 1),
         _aten.addmm.default: (1, 2), _aten.baddbmm.default: (1, 2),
         _aten.addbmm.default: (1, 2), _aten.mv.default: (0, 1),
         _aten.addmv.default: (1, 2), _aten.dot.default: (0, 1)}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dot_flops(func, args) -> float:
    """``2 * prod(out) * contracted`` of one product: the out elements are
    the batch and the two free dims, the contracted dim is the first
    factor's last (``addbmm`` sums its batch: the same count)."""
    i, j = _DOTS[func]
    a, b = args[i], args[j]
    out = a.numel() // a.shape[-1]
    if b.dim() >= 2:
        out *= b.shape[-1]
    return 2.0 * out * a.shape[-1]


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched inside its ``with`` block on this rank
    (see the module docstring). ``dry=True`` marks a dry run: kernel
    wrappers given a fake tensor count the launch and return an empty
    result instead of raising. Nest it above a ``FakeTensorMode`` (as
    :func:`dry_run` does) or use it alone over real tensors; the counts
    of the two agree."""

    def __init__(self, *, dry: bool = False):
        super().__init__()
        self.dry = dry
        self.collectives: Dict[str, float] = {k: 0.0
                                              for k in COLLECTIVE_KINDS}
        self.dot_flops = 0.0
        self.ops = 0
        self.kernels: Dict[str, Dict[str, int]] = collections.defaultdict(
            lambda: {"launches": 0, "bytes": 0})
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, tuple] = {}

    # -- what the kernel wrappers report -------------------------------
    def kernel(self, name: str, path: Optional[str], nbytes: int) -> None:
        """One launch of kernel ``name`` on schedule ``path`` moving
        ``nbytes``."""
        k = self.kernels[f"{name}_{path}" if path else name]
        k["launches"] += 1
        k["bytes"] += int(nbytes)

    # -- memory ----------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        if t.device.type == "meta":       # a stand-in: no memory anywhere
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()

        def dead(_, key=key, n=n, live=self._live):
            if live.pop(key, None) is not None:
                self.live_bytes -= n
        self._live[key] = (weakref.ref(st, dead), n)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def hold(self, *trees) -> None:
        """Count the storages of the tensors in ``trees`` (dicts, lists,
        tuples; the step's inputs made before the counter) as live."""
        for tree in trees:
            for t in tree_leaves(tree):
                if isinstance(t, torch.Tensor):
                    self._track(t)

    # -- the mode --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops += 1
        if func in _DOTS:
            self.dot_flops += _dot_flops(func, args)
        else:
            got = _C10D.get(func._schema.name)
            if got is not None:
                kind, pos = got
                self.collectives[kind] += sum(
                    _nbytes(t) for t in tree_leaves(args[pos])
                    if isinstance(t, torch.Tensor))
        out = func(*args, **kwargs)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out

    # -- results ---------------------------------------------------------
    def result(self) -> Dict:
        """``analyze_hlo``'s keys (every collective kind, ``collective_total``,
        ``dot_flops``), then ``kernel_launches``, ``peak_bytes`` and
        ``ops`` (aten calls dispatched)."""
        r: Dict = {k: float(v) for k, v in self.collectives.items()}
        r["collective_total"] = float(sum(self.collectives.values()))
        r["dot_flops"] = float(self.dot_flops)
        r["kernel_launches"] = {k: dict(v) for k, v in
                                sorted(self.kernels.items())}
        r["peak_bytes"] = int(self.peak_bytes)
        r["ops"] = self.ops
        return r

    def collective_bytes(self) -> Dict[str, float]:
        """Collective bytes by kind and their ``total`` (the reference's
        ``collective_bytes``)."""
        out = {k: float(v) for k, v in self.collectives.items()}
        out["total"] = float(sum(self.collectives.values()))
        return out


def active_counter() -> Optional[OpCounter]:
    """The innermost :class:`OpCounter` on this thread's dispatch-mode
    stack (autograd's backward threads inherit the stack), or None."""
    if not torch._C._len_torch_dispatch_stack():
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, OpCounter):
            return mode
    return None


def is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def in_fake_mode() -> bool:
    """True while a ``FakeTensorMode`` is active on this thread: every
    tensor made then is fake."""
    if not torch._C._len_torch_dispatch_stack():
        return False
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


def dry_counter(what: str) -> OpCounter:
    """The counter of the dry run a fake tensor reached ``what`` in;
    raises outside a dry run (a fake tensor has no memory to launch a
    kernel on)."""
    c = active_counter()
    if c is None or not c.dry:
        raise RuntimeError(f"{what}: a fake tensor outside a dry run "
                           f"(launch.op_analysis.dry_run); a kernel "
                           f"cannot run on it")
    return c


@contextlib.contextmanager
def dry_run():
    """A dry run: a ``FakeTensorMode`` with a dry :class:`OpCounter`
    above it. Tensors made inside are fake; host constants become fake
    too. Yields the counter."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True), \
            OpCounter(dry=True) as counter:
        yield counter
