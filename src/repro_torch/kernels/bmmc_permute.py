"""Host wrappers of the hand-written CUDA permutation kernels.

The counterpart of :mod:`repro.kernels.bmmc_permute`. Five kernels, each
a CUDA C++ source in ``csrc/`` (built and loaded by :mod:`.build`):

* K1 ``copy.cu``          — :func:`copy_blocks`, the bandwidth yardstick
  (reference: ``copy_through_vmem``): tiles of the widest word both
  pointers agree on, through registers (:func:`copy_schedule`; its
  alternative, bulk copies through a ring in shared memory, runs only on
  request; a launch also counts under ``copy_words`` or ``copy_bulk``);
* K2 ``block_permute.cu`` — :func:`block_permute`, whole 2^b blocks
  moved by a source-block table;
* K3 ``lane_permute.cu``  — :func:`lane_permute`, every row permuted in
  place by one lane table;
* K4a ``tile_permute.cu`` — :func:`tiled_permute`, one tiled-BMMC pass,
  on one of two schedules the host picks from the geometry
  (:func:`k4a_schedule`: ``narrow``, a tile staged in shared memory with
  16-byte copies, two in flight a block; ``wide``, elements of 64 bytes
  or more copied straight to their places; a launch also counts under
  ``tile_narrow`` or ``tile_wide``). :func:`tiled_permute` launches from a
  record built once per plan, device, shape, dtype and alignment and kept
  beside the plan's device tables;
* K4b ``tile_fused.cu``   — :func:`tiled_permute_tables` with a non-empty
  ``epilogue``: the same pass with compare-exchange (``cmp``), butterfly
  (``bfly``) and element-wise ``map`` stages applied to the tile before
  the gather, in registers under a layout plan (:mod:`.epilogue_plan`;
  reference: ``_tile_kernel``'s ``apply_computes``). A map's torch
  function runs in the kernel as the tape :mod:`.map_lower` lowers it to;
  one that is not lowered raises on a CUDA tensor;
* K5 ``tile_bwd.cu``      — :func:`tiled_permute_bwd_tables`, the
  transpose of one K4b pass: the saved input and the output cotangent in,
  the input cotangent out (reference: ``_tile_bwd_kernel``).

K4b and K5 run on a work-item schedule the host picks
(:func:`k4b_schedule`, :func:`k5_schedule`: work items of at most 4096
positions, a run of them a block, moved 16 bytes a thread where pointers
and rows allow) and take one launch descriptor (``_EpiArgs``) by
address.

Every wrapper takes the device of its tensor: a CUDA tensor launches the
kernel (or raises — there is no quiet fallback), a CPU tensor runs the
kernel's plain PyTorch version beside it (``_*_plain``), which repeats the
kernel's schedule with tensor indexing (K1's, the reference's schedule).
Each launch that runs adds one to :data:`LAUNCHES`; a launch recorded
into a CUDA graph, the graph's replays and the plain versions count
nothing.

Dry runs (:func:`repro_torch.launch.op_analysis.dry_run`): a wrapper
given a fake tensor inside a dry run still builds its plan (the numpy
planners need shapes only), counts the launch the card would make in the
dry run's :class:`~repro_torch.launch.op_analysis.OpCounter` (K4a with
the schedule :func:`k4a_schedule` picks for the tensor's shape, type and
alignment) and returns an empty result of the right shape and type; it
reads no data pointer, uploads no table and builds no launch record. A
fake tensor outside a dry run raises. A real launch is also reported to
an active counter, so a dry run and a real run count alike.

Guarded variants (ring 2 of :mod:`repro_torch.guard`): K2, K3, K4a and
K4b each have a second instantiation that tests every table entry before
the access it addresses and, on an entry out of range, sets bit 1 of a
flag word (one int32 on the tensor's device) and skips that access: a
block, lane or word not read is written as zeros, a tile row not read is
loaded as zeros, an output row out of range is not written. The wrappers
launch it (counted under ``block_guarded``, ``lane_guarded``,
``tile_guarded`` and ``tile_fused_guarded``) when given ``flags``, or
inside :func:`guard_flags`; their plain versions (``flags=``) apply the
same tests and set the same bit. A guarded variant that cannot build or
launch raises: it never gives way to the unguarded kernel.

Shapes follow the reference: ``x`` is ``(2^n,)`` or ``(2^n, d)``, and with
``batched=True`` ``(B, 2^n)`` or ``(B, 2^n, d)``. Internally every array is
seen as ``(B, 2^n, d)`` with ``B = d = 1`` when absent. Tables live on the
device once per plan (:func:`device_tables`).
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor as _FakeTensor

from .. import guard as _guard
from ..core.tiling import BlockPlan, LanePlan, TilePlan
from . import epilogue_plan as EP
from .map_lower import lower_map

LAUNCHES = {"copy": 0, "block": 0, "lane": 0, "tile": 0, "tile_fused": 0,
            "tile_bwd": 0, "copy_bulk": 0, "copy_words": 0,
            "tile_narrow": 0, "tile_wide": 0,
            "block_guarded": 0, "lane_guarded": 0, "tile_guarded": 0,
            "tile_fused_guarded": 0, "tile_fused_ext": 0, "tile_bwd_ext": 0}

_SMEM_MAX = 227 * 1024          # dynamic shared memory a block may use
_LANE_SMEM = 16 * 1024          # bytes of rows one lane-permute block stages
_BLOCK_CTA_WORDS = 1024         # words one block-permute block moves (at least)
_TILE_CTA_BYTES = 16 * 1024     # bytes of tiles one tile-permute block moves
_WIDE_ELEM_BYTES = 64           # K4a's wide schedule from elements this wide
_K4A_GROUPS = 2                 # 16 KiB work items a narrow K4a block takes
K4A_LAYOUTS = ("unpadded", "padded", "swizzled")
_PLAIN_CHUNK = 1 << 22          # elements per step of the plain tile version
_COPY_CHUNK = 32 * 1024         # K1's ring: stages of one bulk copy each
_COPY_STAGES = 4                # (copy.cu's BULK_CHUNK and BULK_STAGES)
_WORD_THREADS = (1024, 256)     # threads of a K1 words-path block: large
                                # copies, and those with fewer tiles of
                                # 1024 threads than the card has SMs
_SM_COUNTS: dict = {}           # device index -> multiprocessor count


def launch_counts() -> dict:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# shared plumbing
# ---------------------------------------------------------------------------

def _canonical(x: torch.Tensor, batched: bool) -> torch.Tensor:
    """``x`` as ``(B, 2^n, d)``."""
    lead = 1 if batched else 0
    if x.dim() not in (1 + lead, 2 + lead):
        raise ValueError(f"expected {'(B, 2^n[, d])' if batched else '(2^n[, d])'}"
                         f", got shape {tuple(x.shape)}")
    b = x.shape[0] if batched else 1
    d = x.shape[1 + lead] if x.dim() == 2 + lead else 1
    return x.reshape(b, x.shape[lead], d)


def check_no_grad(x, what: str) -> None:
    """Refuse a tensor that requires grad while grad mode is on: a kernel
    writes through a raw pointer, so autograd would drop the gradient
    without a word (the reference's ``pallas_call`` has no VJP either)."""
    if (isinstance(x, torch.Tensor) and x.requires_grad
            and torch.is_grad_enabled()):
        raise NotImplementedError(
            f"{what}: a kernel writes through a raw pointer, which autograd "
            f"cannot see, so it would drop the gradient; differentiate "
            f"through repro_torch.combinators (compile_expr, sort, fft), "
            f"whose autograd rules run the kernels on the cotangent, or "
            f"call this under torch.no_grad()")


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _report(name: str, path, moved: int) -> None:
    """A real launch, reported to the active op counter, if any (one test
    of the dispatch-mode stack's length when there is none)."""
    if torch._C._len_torch_dispatch_stack():
        from ..launch.op_analysis import active_counter
        c = active_counter()
        if c is not None:
            c.kernel(name, path, moved)


def _dry_launch(x: torch.Tensor, name: str, path, moved: int
                ) -> torch.Tensor:
    """A fake tensor's launch inside a dry run: counted, never run; an
    empty result shaped as ``x``. Raises outside a dry run."""
    from ..launch.op_analysis import dry_counter
    dry_counter(name).kernel(name, path, moved)
    return torch.empty_like(x)


def _dry_k4a(xc: torch.Tensor, geometry, moved: int) -> torch.Tensor:
    """K4a on a fake ``(B, 2^n, d)`` tensor: the schedule the card's record
    would hold (the output and the ``src0`` table are fresh allocations,
    so the tensor's own offset is the only misalignment)."""
    align = xc.storage_offset() * xc.element_size()
    s = k4a_schedule(geometry, xc.shape[0], xc.shape[2], xc.element_size(),
                     align)
    return _dry_launch(xc, "tile", s.schedule, moved)


def _route(x: torch.Tensor, what: str) -> bool:
    """True: launch the CUDA kernel; False: run the plain version (CPU
    tensor). Anything else raises, and so does a tensor that requires
    grad (:func:`check_no_grad`)."""
    check_no_grad(x, what)
    if x.device.type == "cuda":
        if not x.is_contiguous():
            raise ValueError(f"{what}: the CUDA kernel takes a contiguous "
                             f"tensor, got strides {x.stride()}")
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel for device {x.device}")


def _word_bytes(unit: int, *ptrs: int) -> int:
    """Widest word (<= 16 bytes) dividing ``unit`` and every pointer."""
    w = 16
    while w > 1 and (unit % w or any(p % w for p in ptrs)):
        w //= 2
    return w


def _shift(v: int) -> int:
    """log2(v) when v is a power of two, else -1."""
    return v.bit_length() - 1 if v > 0 and v & (v - 1) == 0 else -1


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _stream(x: torch.Tensor):
    """The raw handle of the current stream on ``x``'s device (what
    ``torch.cuda.current_stream(...).cuda_stream`` gives, without building
    a Stream object on every launch)."""
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(x.device.index))


def _launch(name: str, x: torch.Tensor, *args, path: str = None,
            moved: int = 0, dv: int = 1) -> None:
    """Launch kernel ``name`` (on the ``ext`` path from the ext library
    that holds ``x``'s element type with ``dv`` values a register slot:
    K4b's and K5's map kernels for typed tapes), counted under ``name``
    and ``name_path``."""
    from . import build as _build
    fn = _build.load(name if path != "ext" else _build.ext_library(
        name, _ELEM_TYPE[x.dtype], dv))
    if x.device.index == torch.cuda.current_device():
        rc = fn(*args, _stream(x))
    else:
        with torch.cuda.device(x.device):
            rc = fn(*args, _stream(x))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES[name] += 1     # a graph capture records, it does not run
        if path is not None:
            LAUNCHES[f"{name}_{path}"] += 1
        _report(name, path, moved)


def _device_table(tab, device, numel: int) -> torch.Tensor:
    """``tab`` as a contiguous int32 tensor on ``device`` with ``numel``
    entries (the count its geometry gives); raises otherwise."""
    t = tab if isinstance(tab, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(tab, dtype=np.int32))
    if t.dtype != torch.int32:
        raise ValueError(f"index tables are int32, got {t.dtype}")
    if t.numel() != numel:
        raise ValueError(f"index table of {t.numel()} entries, the "
                         f"geometry needs {numel}")
    return t.to(device).contiguous()


class _DeviceCache:
    """Tensors uploaded to a device once and kept: a least-recently-used
    store bounded by bytes, keyed by ``(id(owner), tag, device)``. The
    owner is held beside its entry, so its id cannot be reused while the
    entry lives; ``owner=None`` keys by ``tag`` alone (a tag that is the
    entry's whole content). A value larger than the whole store is
    returned without being kept.

    While :func:`pin_device_tables` is active on a thread, every entry
    that thread looks up is also kept in the pin's own dict and served
    from it first: a CUDA-graph capture replays exactly the tables its
    warm-up uploaded (an upload inside a capture would fail, and an
    eviction would free memory the graph still reads)."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._d: "collections.OrderedDict" = collections.OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.gen = 0        # bumped whenever an entry leaves the store
        self.on_drop = None     # called then, under the lock

    def _dropped(self) -> None:
        self.gen += 1
        if self.on_drop is not None:
            self.on_drop()

    @staticmethod
    def _size(value) -> int:
        """Bytes an entry keeps alive: each distinct buffer of the tensors
        and numpy arrays in it (tuples followed) counted once."""
        bufs, todo = {}, [value]
        while todo:
            v = todo.pop()
            if isinstance(v, tuple):
                todo.extend(v)
                continue
            if isinstance(v, torch.Tensor):
                st = v.untyped_storage()
                key, size = (v.device, st.data_ptr()), st.nbytes()
            elif isinstance(v, np.ndarray):
                key = (torch.device("cpu"), v.__array_interface__["data"][0])
                size = v.nbytes
            else:
                continue
            bufs[key] = max(size, bufs.get(key, 0))
        return sum(bufs.values())

    def get(self, owner, tag, device, make, *args):
        """The kept value, or ``make(*args)``'s, kept. Inside a fake mode
        (a dry run) nothing is looked up or kept: ``make(*args)``."""
        if torch._C._len_torch_dispatch_stack():
            from ..launch.op_analysis import in_fake_mode
            if in_fake_mode():
                return make(*args)
        name = _DEV_NAMES.get(device)
        if name is None:
            name = _DEV_NAMES.setdefault(device, str(device))
        key = (id(owner) if owner is not None else None, tag, name)
        pin = _PIN.tables
        if pin is not None:
            hit = pin.get(key)
            if hit is not None and hit[0] is owner:
                return hit[1]
        with self._lock:
            hit = self._d.get(key)
            if hit is not None and hit[0] is owner:
                self._d.move_to_end(key)
                self.hits += 1
                value = hit[1]
            else:
                hit = None
                self.misses += 1
        if hit is None:
            value = make(*args)
            size = self._size(value)
            if size <= self.max_bytes:
                with self._lock:
                    old = self._d.pop(key, None)
                    if old is not None:
                        self._bytes -= old[2]
                        self._dropped()
                    self._d[key] = (owner, value, size)
                    self._bytes += size
                    while self._bytes > self.max_bytes:
                        _, (_, _, s) = self._d.popitem(last=False)
                        self._bytes -= s
                        self._dropped()
        if pin is not None:
            pin[key] = (owner, value)
        return value

    def copies(self, owner, tag) -> dict:
        """``{device string: value}`` of every entry kept for ``(owner,
        tag)``, without touching its recency."""
        with self._lock:
            return {k[2]: v[1] for k, v in self._d.items()
                    if k[0] == id(owner) and k[1] == tag and v[0] is owner}

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
            self._bytes = 0
            self.hits = self.misses = 0
            self._dropped()

    def cache_info(self) -> tuple:
        """(hits, misses, maxsize, currsize), the ``lru_cache`` words."""
        return (self.hits, self.misses, None, len(self._d))


class _PinState(threading.local):
    # a class default, so reading an unset pin is an attribute hit (a
    # getattr default on a bare threading.local raises and catches
    # inside, about a microsecond on the launch path)
    tables = None


_PIN = _PinState()
_DEV_NAMES: dict = {}           # device (object or string) -> its name
_DEV_CACHE = _DeviceCache(max_bytes=1 << 30)


@contextlib.contextmanager
def pin_device_tables():
    """Keep every device table looked up on this thread inside the block
    in the dict it yields (see :class:`_DeviceCache`); whoever holds the
    dict keeps the tables alive."""
    prev = _PIN.tables
    _PIN.tables = {} if prev is None else prev
    try:
        yield _PIN.tables
    finally:
        _PIN.tables = prev


def device_cached(owner, tag, device, make):
    """``make()``'s tensor (or tuple of tensors) on ``device``, built once
    per ``(owner, tag, device)`` and kept (see :class:`_DeviceCache`)."""
    return _DEV_CACHE.get(owner, tag, device, make)


class _TileTables(tuple):
    """A tile plan's four tables on one device, with the K4a launch records
    built on them (``launch``: key -> :class:`_K4aLaunch`). The records
    live in the tables' entry of the device store, so they are pinned,
    evicted and cleared with the tables, and read the very tensors a
    poisoned copy would change (:mod:`repro_torch.guard.inject`)."""


def _upload_tables(plan, device) -> tuple:
    if isinstance(plan, TilePlan):
        tabs = _TileTables(_device_table(a, device, a.size) for a in (
            plan.in_rows, plan.out_rows, plan.xor_low, plan.src0))
        tabs.launch = {}
        return tabs
    if isinstance(plan, BlockPlan):
        return (_device_table(plan.src_rows, device, plan.src_rows.size),)
    if isinstance(plan, LanePlan):
        return (_device_table(plan.src_lane, device, plan.src_lane.size),)
    raise TypeError(f"no tables for {type(plan).__name__}")


def device_tables(plan, device) -> tuple:
    """A plan's index tables on ``device`` as int32 tensors, uploaded once
    and kept beside the plan."""
    return _DEV_CACHE.get(plan, "tables", device, _upload_tables, plan,
                          device)


def device_copies(owner, tag) -> dict:
    """``{device: value}`` of what :func:`device_cached` keeps for
    ``(owner, tag)`` (e.g. a plan's ``"tables"``), on every device."""
    return _DEV_CACHE.copies(owner, tag)


def clear_device_tables() -> None:
    _DEV_CACHE.clear()


class _GuardState(threading.local):
    flags = None            # see _PinState


_GUARD = _GuardState()


@contextlib.contextmanager
def guard_flags(flags: torch.Tensor):
    """Inside the block, the K2/K3/K4a/K4b wrappers on this thread launch
    their guarded variants (or guarded plain versions) into ``flags``, one
    int32 on the tensors' device, unless a call passes its own."""
    prev = _GUARD.flags
    _GUARD.flags = flags
    try:
        yield flags
    finally:
        _GUARD.flags = prev


def active_guard_flags():
    """The flag word of the enclosing :func:`guard_flags`, or None."""
    return _GUARD.flags


def _check_flags(flags, x: torch.Tensor) -> torch.Tensor:
    if (not isinstance(flags, torch.Tensor) or flags.dtype != torch.int32
            or flags.numel() != 1 or flags.device != x.device):
        raise ValueError(f"a guard flag word is one int32 on {x.device}, "
                         f"got {flags!r}")
    return flags


def _flags_for(x: torch.Tensor, flags):
    """The flag word a wrapper launches into: ``flags``, else the enclosing
    :func:`guard_flags` word, checked against ``x``; None for neither."""
    flags = active_guard_flags() if flags is None else flags
    return None if flags is None else _check_flags(flags, x)


def _in_range(tab, hi: int, flags: torch.Tensor, device) -> tuple:
    """``tab`` as int64 on ``device`` with the entries outside ``[0, hi)``
    replaced by 0, and the mask of the entries inside; sets bit 1 of
    ``flags`` when one is outside (the guarded plain versions' test)."""
    v = _long(tab, device)
    ok = (v >= 0) & (v < hi)
    flags.bitwise_or_((~ok).any().to(torch.int32))
    return torch.where(ok, v, torch.zeros_like(v)), ok


def _trap_tables(pairs) -> None:
    """Host-side descriptor trap at the kernel-launch boundary: when
    guards are on, refuse to launch a kernel whose gather / row tables
    address outside their geometry (the reference's
    ``bmmc_permute._trap_tables``, same switch). Inside a guarded run
    (:func:`guard_flags`) the guarded kernel owns this check, as the
    reference's in-program flag owns it under its guarded trace."""
    if not _guard.enabled() or active_guard_flags() is not None:
        return
    from ..guard.errors import DescriptorOOB
    for name, tab, hi in pairs:
        if isinstance(tab, torch.Tensor):
            tab = tab.cpu().numpy()
        if tab.size and (int(tab.min()) < 0 or int(tab.max()) >= hi):
            raise DescriptorOOB(
                f"kernel launch refused: table {name!r} addresses "
                f"[{int(tab.min())}, {int(tab.max())}] outside [0, {hi})")


def _long(tab, device) -> torch.Tensor:
    if isinstance(tab, torch.Tensor):
        return tab.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(tab), dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# K4a: one tiled pass
# ---------------------------------------------------------------------------

def default_num_buffers(n_tiles: int) -> int:
    """2 (double buffering) whenever there is more than one tile. Kept in
    the geometry for key parity with the reference; the CUDA kernel runs
    tiles in parallel blocks instead of a buffered loop."""
    return 1 if n_tiles == 1 else 2


def plan_geometry(plan: TilePlan, num_buffers: int = None) -> tuple:
    """The hashable tile geometry of a plan — everything that shapes the
    kernel *except* the index tables (the reference's tuple)."""
    if num_buffers is None:
        num_buffers = default_num_buffers(plan.n_tiles)
    return (plan.n, plan.t, plan.rows_per_tile, plan.in_run, plan.out_run,
            plan.n_tiles, num_buffers)


def _tile_plain(xc, in_rows, out_rows, xor_low, src0, geometry):
    """The K4a schedule with tensor indexing: tile ``g`` gathers
    ``tile.flat[src0.flat[r * 2^t + (l ^ xor_low[g])]]`` from its input
    rows and writes output rows ``out_rows[g]``; tiles in chunks."""
    n, t, rpt, _, _, n_tiles, _ = geometry
    row_len = 1 << t
    dev = xc.device
    ir, orow = _long(in_rows, dev), _long(out_rows, dev)
    xl, s0 = _long(xor_low, dev), _long(src0, dev).reshape(-1)
    j = torch.arange(rpt * row_len, device=dev)
    rp, cp = j >> t, j & (row_len - 1)
    xb = _bits(xc)
    out = torch.empty_like(xb)
    step = max(1, _PLAIN_CHUNK // (rpt * row_len))
    for g0 in range(0, n_tiles, step):
        gs = slice(g0, min(n_tiles, g0 + step))
        src = s0[(rp << t) | (cp[None, :] ^ xl[gs, None])]
        x_glob = torch.gather(ir[gs], 1, src >> t) * row_len + (src & (row_len - 1))
        y_glob = orow[gs][:, rp] * row_len + cp
        out[:, y_glob.reshape(-1)] = xb[:, x_glob.reshape(-1)]
    return out.view(xc.dtype)


def _tiles_per_cta(geometry, elem: int, max_positions: int = None) -> int:
    """Tiles one block takes: small tiles (a mixed complement's are one
    row) are grouped so one block still moves about _TILE_CTA_BYTES of
    ``elem``-byte elements (and holds at most ``max_positions``)."""
    _, t, rpt, _, _, n_tiles, _ = geometry
    per_cta = 1
    while (per_cta * 2 <= n_tiles
           and per_cta * 2 * rpt * (1 << t) * elem <= _TILE_CTA_BYTES
           and (max_positions is None
                or per_cta * 2 * rpt * (1 << t) <= max_positions)):
        per_cta *= 2
    return per_cta


def _tile_args(xc, geometry):
    """(out, kernel arguments after the tables) of a launch of the guarded
    K4a (the design before its schedules: ``_tiles_per_cta`` tiles a
    block, words of the widest width that divides the element and both
    pointers, rows padded by one 4-byte bank); raises when a block does
    not fit shared memory."""
    n, t, rpt, _, _, n_tiles, _ = geometry
    out = torch.empty_like(xc)
    batch, _, d = xc.shape
    elem = d * xc.element_size()
    wb = _word_bytes(elem, xc.data_ptr(), out.data_ptr())
    wpe = elem // wb
    pad = max(1, 4 // wb)
    per_cta = _tiles_per_cta(geometry, elem)
    rows = per_cta * rpt
    tile = rows * ((1 << t) * wpe + pad) * wb
    smem = (((2 * rows + per_cta) * 4 + 15) & ~15) + tile
    if smem > _SMEM_MAX:
        raise ValueError(f"tile of {rpt} x 2^{t} elements of {elem} bytes "
                         f"needs {smem} bytes of shared memory (> {_SMEM_MAX})")
    return out, (n_tiles, 1 << (n - t), _shift(rpt), per_cta, t, wpe,
                 _shift(wpe), _shift((1 << t) * wpe), pad, batch, wb)


class K4aSchedule(NamedTuple):
    """How K4a runs one geometry on the card (``tile_permute.cu``). Words
    of ``word_bytes`` (the widest that divides the element and every
    pointer), ``wpe`` of them an element. ``narrow``: a work item is
    ``per_cta`` tiles of one batch row (``n_groups`` a batch row,
    ``n_work`` in all), a block takes ``groups`` of them with two in
    flight, staged in a tile of ``layout`` (rows of ``stride`` words,
    16-byte chunks XORed with ``row & swz``); ``vec`` 1 copies and stores
    16 bytes a thread. ``wide``: a block copies ``per_cta`` output
    elements of ``groups`` batch rows (``n_groups`` element chunks a batch
    row). ``grid`` blocks of ``smem`` bytes of dynamic shared memory;
    ``wpe_shift`` and ``row_shift`` are log2 of ``wpe`` and of a narrow
    row's (a wide block's batch row's) words, -1 if not a power of two."""
    schedule: str
    word_bytes: int
    vec: int
    wpe: int
    wpe_shift: int
    row_shift: int
    per_cta: int
    groups: int
    n_groups: int
    n_work: int
    layout: str
    stride: int
    swz: int
    grid: int
    smem: int


def k4a_schedule(geometry, batch: int, d: int, itemsize: int,
                 align: int = 0, *, schedule: str = None, layout: str = None,
                 groups: int = None) -> K4aSchedule:
    """K4a's schedule for ``batch`` rows of a ``geometry`` with elements of
    ``d`` items of ``itemsize`` bytes; ``align`` is the OR of the data,
    output and src0 pointers (only its residue mod 16 matters). The
    schedule is ``wide`` from elements of ``_WIDE_ELEM_BYTES``, else
    ``narrow``; ``schedule``, ``layout`` and ``groups`` override the
    defaults (for the layout study and the sweep). Raises when a narrow
    block does not fit shared memory."""
    return _k4a_schedule(tuple(geometry), int(batch), int(d), int(itemsize),
                         int(align) & 15, schedule, layout, groups)


@functools.lru_cache(maxsize=1024)
def _k4a_schedule(geometry, batch, d, itemsize, align, schedule, layout,
                  groups):
    n, t, rpt, _, _, n_tiles, _ = geometry
    elem = d * itemsize
    wb = _word_bytes(elem, align)
    wpe = elem // wb
    row_len = 1 << t
    if schedule is None:
        schedule = "wide" if elem >= _WIDE_ELEM_BYTES else "narrow"
    if schedule == "wide":
        epb = min(1 << n, 1 << max(0, (_TILE_CTA_BYTES // elem).bit_length()
                                   - 1))
        bpb = max(1, min(batch, _TILE_CTA_BYTES // (epb * elem)))
        chunks = (1 << n) // epb
        return K4aSchedule("wide", wb, 0, wpe, _shift(wpe), _shift(epb * wpe),
                           epb, bpb, chunks, batch, "", 0, 0,
                           chunks * -(-batch // bpb), 8 * epb)
    if schedule != "narrow":
        raise ValueError(f"no K4a schedule {schedule!r} (narrow, wide)")
    row_words = row_len * wpe
    vec = int(align == 0 and row_len * elem % 16 == 0
              and (wpe == 1 or wb == 16))
    cw = max(1, 16 // wb)                 # words of a 16-byte chunk
    cpr = row_words // cw if row_words % cw == 0 else 0
    # swizzled, where a gather reads down the tile's columns; one-row
    # tiles (a gather within a row) run about 2 % faster padded
    # (tools/k4a_sweep.py, chip_smoke.py phase 5)
    layout = layout or ("padded" if rpt == 1 else "swizzled")
    if layout not in K4A_LAYOUTS:
        raise ValueError(f"no tile layout {layout!r} {K4A_LAYOUTS}")
    if layout == "swizzled" and (cpr < 2 or cpr & (cpr - 1)):
        layout = "padded"                 # chunks a row: not a power of two
    stride = row_words + (cw if layout == "padded" else 0)
    swz = cpr - 1 if layout == "swizzled" else 0
    per_cta = _tiles_per_cta(geometry, elem)
    rows = per_cta * rpt
    n_groups = n_tiles // per_cta
    n_work = batch * n_groups
    groups = max(1, min(groups or _K4A_GROUPS, n_work))
    tile = (rows * stride * wb + 15) & ~15
    smem = (((groups * 8 + 15) & ~15)
            + ((groups * (2 * rows + per_cta) * 4 + 15) & ~15)
            + min(2, groups) * tile)
    if smem > _SMEM_MAX:
        raise ValueError(f"tile of {rpt} x 2^{t} elements of {elem} bytes "
                         f"needs {smem} bytes of shared memory "
                         f"(> {_SMEM_MAX})")
    return K4aSchedule("narrow", wb, vec, wpe, _shift(wpe), _shift(row_words),
                       per_cta, groups, n_groups, n_work, layout, stride, swz,
                       -(-n_work // groups), smem)


class _K4aArgs(ctypes.Structure):
    """``TilePermuteArgs`` of ``tile_permute.cu``, field for field."""
    _fields_ = [(k, ctypes.c_void_p) for k in ("in_rows", "out_rows",
                                               "xor_low", "src0")] + [
        ("batch", ctypes.c_longlong), ("n_work", ctypes.c_longlong)] + [
        (k, ctypes.c_int) for k in (
            "schedule", "word_bytes", "vec", "n_rows", "t", "rpt_shift",
            "wpe", "wpe_shift", "row_shift", "per_cta", "per_cta_shift",
            "groups", "n_groups", "stride", "swz", "grid", "smem")]


def _k4a_args(s: K4aSchedule, tabs, geometry, batch: int) -> _K4aArgs:
    """The launch descriptor of schedule ``s`` on device tables ``tabs``."""
    n, t, rpt, _, _, _, _ = geometry
    return _K4aArgs(*(a.data_ptr() for a in tabs), batch, s.n_work,
                    int(s.schedule == "wide"), s.word_bytes, s.vec,
                    1 << (n - t), t, _shift(rpt), s.wpe, s.wpe_shift,
                    s.row_shift, s.per_cta, _shift(s.per_cta), s.groups,
                    s.n_groups, s.stride, s.swz, s.grid, s.smem)


class _K4aLaunch:
    """One K4a launch record: the loaded entry point, the launch descriptor
    (kept alive here, passed by address) and the schedule it holds."""
    __slots__ = ("fn", "args", "ref", "schedule", "path")

    def __init__(self, fn, args: _K4aArgs, schedule: K4aSchedule):
        self.fn, self.args, self.schedule = fn, args, schedule
        self.ref = ctypes.addressof(args)
        self.path = f"tile_{schedule.schedule}"


def _k4a_record(x: torch.Tensor, plan: TilePlan, tabs, batched: bool,
                align: int) -> _K4aLaunch:
    """The launch record of ``plan`` on its device tables ``tabs`` for
    tensors shaped, typed and aligned as ``x`` (``align``: the data and
    output pointers' OR), built and kept in ``tabs.launch`` at first
    use."""
    key = (x.shape, x.dtype, batched, align & 15)
    rec = tabs.launch.get(key)
    if rec is None:
        rec = tabs.launch[key] = _new_record(x, plan, tabs, batched, align)
    return rec


def _new_record(x, plan, tabs, batched, align) -> _K4aLaunch:
    from . import build as _build
    xc = _canonical(x, batched)
    geometry = plan_geometry(plan)
    if xc.shape[1] != 1 << plan.n:
        raise ValueError(f"axis of {xc.shape[1]} elements, the plan "
                         f"permutes 2^{plan.n}")
    s = k4a_schedule(geometry, xc.shape[0], xc.shape[2], x.element_size(),
                     align | tabs[3].data_ptr())
    return _K4aLaunch(_build.load("tile"), _k4a_args(s, tabs, geometry,
                                                     xc.shape[0]), s)


def k4a_record(x: torch.Tensor, plan: TilePlan, *,
               batched: bool = False) -> _K4aLaunch:
    """The launch record :func:`tiled_permute` uses for ``x`` (built and
    kept if there is none yet; the output's alignment taken as 16
    bytes)."""
    return _k4a_record(x, plan, device_tables(plan, x.device), batched,
                       x.data_ptr())


# (id(plan), device index) -> (plan, its tables, the store's generation)
_HOT: dict = {}
_DEV_CACHE.on_drop = _HOT.clear


def _launch_tables(plan: TilePlan, device) -> tuple:
    """:func:`device_tables` for the launch path: the tables (and launch
    records) looked up last for this plan and device, while the device
    store has dropped no entry since (its generation; a drop also forgets
    every remembered lookup, so none keeps a dropped table alive) and no
    pin is active; else the store's lookup, remembered."""
    key = (id(plan), device.index)
    hot = _HOT.get(key)
    gen = _DEV_CACHE.gen
    if (hot is not None and hot[0] is plan and hot[2] == gen
            and _PIN.tables is None):
        return hot[1]
    tabs = device_tables(plan, device)
    _HOT[key] = (plan, tabs, gen)
    return tabs


def _k4a_call(x: torch.Tensor, plan: TilePlan, batched: bool,
              device=None) -> torch.Tensor:
    """K4a on a CUDA tensor through the plan's launch record: the checks,
    the output, one alignment test, one foreign call."""
    check_no_grad(x, "tiled_permute")
    if not x.is_contiguous():
        raise ValueError(f"tiled_permute: the CUDA kernel takes a contiguous "
                         f"tensor, got strides {x.stride()}")
    device = x.device if device is None else device
    tabs = _launch_tables(plan, device)
    out = torch.empty_like(x)
    xp, op = x.data_ptr(), out.data_ptr()
    rec = _k4a_record(x, plan, tabs, batched, xp | op)
    dev = device.index
    if dev == torch._C._cuda_getDevice():
        rc = rec.fn(xp, op, rec.ref, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            rc = rec.fn(xp, op, rec.ref,
                        torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"tile kernel launch failed: CUDA error {rc}")
    if not torch._C._cuda_isCurrentStreamCapturing():
        LAUNCHES["tile"] += 1       # a graph capture records, it does not run
        LAUNCHES[rec.path] += 1
        if torch._C._len_torch_dispatch_stack():
            _report("tile", rec.schedule.schedule, 2 * _nbytes(x))
    return out


def _tile_launch(xc, tabs, geometry, flags=None):
    """K4a on tables passed as arguments: the guarded variant with
    ``flags`` (the design before the two schedules), else the schedule
    :func:`k4a_schedule` picks, its descriptor built for this call."""
    if flags is not None:
        out, args = _tile_args(xc, geometry)
        _launch("tile_guarded", xc, _ptr(xc), _ptr(out),
                *(_ptr(a) for a in tabs), *args, _ptr(flags),
                moved=2 * _nbytes(xc))
        return out
    out = torch.empty_like(xc)
    s = k4a_schedule(geometry, xc.shape[0], xc.shape[2], xc.element_size(),
                     xc.data_ptr() | out.data_ptr() | tabs[3].data_ptr())
    args = _k4a_args(s, tabs, geometry, xc.shape[0])
    _launch("tile", xc, _ptr(xc), _ptr(out), ctypes.addressof(args),
            path=s.schedule, moved=2 * _nbytes(xc))
    return out


# ---------------------------------------------------------------------------
# K4b: the tiled pass with fused compute epilogues
# ---------------------------------------------------------------------------

# The element types K4b and the guarded K4b take, by the code the kernels
# switch on: the class (signed or unsigned integer, float32, a half float
# widened to float, float64) and the storage width. bool is uint8 (max is
# OR and min is AND on 0 and 1).
_ELEM_TYPE = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2,
              torch.float16: 3, torch.int8: 4, torch.uint8: 5,
              torch.bool: 5, torch.int16: 6, torch.uint16: 7,
              torch.uint32: 8, torch.int64: 9, torch.uint64: 10,
              torch.float64: 11}
_FLOAT_TYPES = (torch.float32, torch.bfloat16, torch.float16,
                torch.float64)  # and K5's
_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
# unsigned types torch's CPU build lacks max, index_select and index_put for
_WIDE_UNSIGNED = (torch.uint16, torch.uint32, torch.uint64)


def _int_view(x: torch.Tensor) -> torch.Tensor:
    """``x``'s bits as the signed integer type of its width."""
    return x.view(_SIGNED[x.element_size()])


def _bits(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the plain versions move it: a signed integer view of its
    width (a permutation moves bits; torch on the CPU has no index ops
    for uint16, uint32 and uint64, and its bfloat16 gather rewrites NaN
    payloads), or ``x`` itself for a 16-byte element."""
    return _int_view(x) if x.element_size() in _SIGNED else x


def _unsigned_op(op, a, b, out):
    """``op`` (torch.maximum or torch.minimum) on unsigned ``a``, ``b`` as
    signed views with the sign bit flipped, which keeps their order."""
    m = torch.iinfo(_SIGNED[a.element_size()]).min
    r = op(_int_view(a) ^ m, _int_view(b) ^ m)
    if out is None:
        return (r ^ m).view(a.dtype)
    torch.bitwise_xor(r, m, out=_int_view(out))
    return out


def cmp_max(a: torch.Tensor, b: torch.Tensor, *,
            out: torch.Tensor = None) -> torch.Tensor:
    """``max(a, b)`` as the fused compare-exchange computes it, the same
    on every device. Integers: plain max (uint16, uint32 and uint64 as
    signed views with the sign bit flipped; bool is OR). Floats: NaN
    propagates (``a`` when ``a`` is NaN, else ``b`` when ``b`` is), -0 <
    +0, and equal values give the bitwise AND of the two (``max(-0, +0) =
    +0``) — what ``jnp.maximum`` gives on the CPU. The CUDA kernel
    computes the same (``cmp_sel`` in ``tile_epilogue.cuh``);
    ``torch.maximum`` would not pin the sign of a zero. ``out`` receives
    the result when given."""
    if a.dtype in _WIDE_UNSIGNED:
        return _unsigned_op(torch.maximum, a, b, out)
    if not a.is_floating_point():
        return torch.maximum(a, b, out=out)
    r = torch.where(b > a, b, (_int_view(a) & _int_view(b)).view(a.dtype))
    r = torch.where(a > b, a, r)
    r = torch.where(torch.isnan(b), b, r)
    return torch.where(torch.isnan(a), a, r, out=out)


def cmp_min(a: torch.Tensor, b: torch.Tensor, *,
            out: torch.Tensor = None) -> torch.Tensor:
    """``min(a, b)``: as :func:`cmp_max`, with equal values giving the
    bitwise OR (``min(-0, +0) = -0``)."""
    if a.dtype in _WIDE_UNSIGNED:
        return _unsigned_op(torch.minimum, a, b, out)
    if not a.is_floating_point():
        return torch.minimum(a, b, out=out)
    r = torch.where(b < a, b, (_int_view(a) | _int_view(b)).view(a.dtype))
    r = torch.where(a < b, a, r)
    r = torch.where(torch.isnan(b), b, r)
    return torch.where(torch.isnan(a), a, r, out=out)


def _epi_entries(epilogue, epi_scalar, epi_vmem, map_fns=(), dtype=None):
    """Per epilogue ``(kind, vr, vc, hi_row, hi_lane, hi_base, tw_row,
    tw_lane, tw_base, w)`` (the ``tw_*`` and ``w`` None for cmp); a map's
    ``(2, 0, 0, None x 6, tape)``, its function from ``map_fns`` (in
    order) lowered for ``dtype`` (:func:`.map_lower.lower_map`)."""
    if not (len(epilogue) == len(epi_scalar) == len(epi_vmem)):
        raise ValueError("epilogue, epi_scalar and epi_vmem differ in length")
    if sum(sig[0] == "map" for sig in epilogue) != len(map_fns):
        raise ValueError("one function in map_fns per map epilogue")
    out = []
    fns = iter(map_fns)
    for sig, scal, vm in zip(epilogue, epi_scalar, epi_vmem):
        kind = sig[0]
        if kind == "map":
            out.append((EP.KIND_MAP, 0, 0) + (None,) * 6
                       + (lower_map(sig[1], next(fns), dtype),))
        elif kind == "cmp":
            (hi_base,), (hi_row, hi_lane) = scal, vm
            out.append((0, sig[1], sig[2], hi_row, hi_lane, hi_base,
                        None, None, None, None))
        elif kind == "bfly":
            (hi_base, tw_base), (hi_row, hi_lane, tw_row, tw_lane, w) = \
                scal, vm
            out.append((1, sig[1], sig[2], hi_row, hi_lane, hi_base,
                        tw_row, tw_lane, tw_base, w))
        else:
            raise ValueError(f"unknown epilogue kind {kind!r}")
    return out


def _check_epi_input(xc, entries, geometry):
    _, t, rpt, _, _, _, _ = geometry
    if xc.dtype not in _ELEM_TYPE:
        raise ValueError(f"fused epilogues take integers of 8, 16, 32 and "
                         f"64 bits, bool, float32, bfloat16, float16 and "
                         f"float64, got {xc.dtype}")
    for e in entries:
        if e[0] == EP.KIND_MAP:
            if e[9].dtype != xc.dtype:
                raise ValueError(f"map {e[9].name!r} lowered for "
                                 f"{e[9].dtype}, the tensor is {xc.dtype}")
            continue
        if not (0 <= e[1] < rpt and 0 <= e[2] < (1 << t)) or not (
                e[1] or e[2]):
            raise ValueError(f"epilogue partner XOR ({e[1]}, {e[2]}) outside "
                             f"a tile of {rpt} x 2^{t}")
        if e[0] == 1 and (xc.dtype not in _FLOAT_TYPES
                          or xc.shape[2] != 2):
            raise ValueError("a butterfly epilogue needs float32, bfloat16, "
                             "float16 or float64 with a planar (re, im) "
                             f"tail of 2, got {xc.dtype} with a tail of "
                             f"{xc.shape[2]}")


def _apply_epilogue(tile, e, hi_base_g, tw_base_g):
    """One epilogue on tiles ``(B, G, rpt, row_len, d)``: position (r, c)
    pairs with (r ^ vr, c ^ vc); ``hi`` picks max / the "hi" butterfly
    output, exactly as the reference's ``apply_computes``; a map calls its
    function on the tile, as the reference does (beside butterflies on
    both planar values). A butterfly on bfloat16 or float16 rounds each
    product and sum to the tile's type, its twiddles ``w`` already in it
    (:func:`_plain_entries`); a float64 one computes in float64."""
    kind, vr, vc, hi_row, hi_lane, _, tw_row, tw_lane, _, w = e
    if kind == EP.KIND_MAP:
        out = w.fn(tile)
        if out.shape != tile.shape or out.dtype != tile.dtype:
            raise ValueError(f"map {w.name!r} turned a {tuple(tile.shape)} "
                             f"{tile.dtype} tile into {tuple(out.shape)} "
                             f"{out.dtype}")
        return out
    dev = tile.device
    rpt, row_len = tile.shape[2], tile.shape[3]
    pv = _bits(tile).index_select(2, torch.arange(rpt, device=dev) ^ vr)
    pv = pv.index_select(3, torch.arange(row_len, device=dev) ^ vc).view(
        tile.dtype)
    hi = ((hi_row[:, None] ^ hi_lane[None, :])[None]
          ^ hi_base_g[:, None, None]) == 1                 # (G, rpt, row_len)
    if kind == 0:   # selected as bits: no torch.where for every type
        return torch.where(hi[None, ..., None], _bits(cmp_max(tile, pv)),
                           _bits(cmp_min(tile, pv))).view(tile.dtype)
    tw = (tw_row[:, None] ^ tw_lane[None, :])[None] ^ tw_base_g[:, None, None]
    wr, wi = w[:, 0][tw][None], w[:, 1][tw][None]
    hi = hi[None]
    v_re, v_im, p_re, p_im = tile[..., 0], tile[..., 1], pv[..., 0], pv[..., 1]
    lo_re = torch.where(hi, p_re, v_re)
    lo_im = torch.where(hi, p_im, v_im)
    hi_re = torch.where(hi, v_re, p_re)
    hi_im = torch.where(hi, v_im, p_im)
    t_re = wr * hi_re - wi * hi_im
    t_im = wr * hi_im + wi * hi_re
    return torch.stack([torch.where(hi, lo_re - t_re, lo_re + t_re),
                        torch.where(hi, lo_im - t_im, lo_im + t_im)], dim=-1)


def _tiles_of(tab, gs):
    """A per-tile table's entries for tiles ``gs`` (None for a map)."""
    return None if tab is None else tab[gs]


def _tile_fused_plain(xc, in_rows, out_rows, xor_low, src0, geometry,
                      entries, flags=None):
    """The K4b schedule with tensor indexing: tile ``g`` loads its input
    rows, applies every epilogue in order, then gathers
    ``tile.flat[src0.flat[r * 2^t + (l ^ xor_low[g])]]`` into its output
    rows; tiles in chunks. With ``flags``, the guarded variant's schedule
    (K4b's, and K4a's with no epilogues): a row id, lane XOR or src0 entry
    out of range sets bit 1 and its access is skipped (see the module
    docstring)."""
    n, t, rpt, _, _, n_tiles, _ = geometry
    row_len = 1 << t
    dev = xc.device
    batch, _, d = xc.shape
    if flags is None:
        ir, orow = _long(in_rows, dev), _long(out_rows, dev)
        xl, s0 = _long(xor_low, dev), _long(src0, dev).reshape(-1)
    else:
        n_rows = 1 << (n - t)
        ir, ir_ok = _in_range(in_rows, n_rows, flags, dev)
        orow, or_ok = _in_range(out_rows, n_rows, flags, dev)
        xl, xl_ok = _in_range(xor_low, row_len, flags, dev)
        s0, s0_ok = _in_range(_long(src0, dev).reshape(-1), rpt * row_len,
                              flags, dev)
        ir, orow = ir.reshape(n_tiles, rpt), orow.reshape(n_tiles, rpt)
        ir_ok, or_ok = ir_ok.reshape(n_tiles, rpt), or_ok.reshape(n_tiles, rpt)
    ents = _plain_entries(entries, dev, xc.dtype)
    lane = torch.arange(row_len, device=dev)
    j = torch.arange(rpt * row_len, device=dev)
    rp, cp = j >> t, j & (row_len - 1)
    xb = _bits(xc)
    out = torch.empty_like(xb)
    step = max(1, _PLAIN_CHUNK // (rpt * row_len))
    for g0 in range(0, n_tiles, step):
        gs = slice(g0, min(n_tiles, g0 + step))
        ng = gs.stop - gs.start
        x_glob = (ir[gs][:, :, None] * row_len + lane).reshape(-1)
        tile = xb[:, x_glob].reshape(batch, ng, rpt, row_len, d)
        if flags is not None:   # rows not read load as zeros
            tile = tile.masked_fill(~ir_ok[gs][None, :, :, None, None], 0)
        tile = tile.view(xc.dtype)
        for e in ents:
            tile = _apply_epilogue(tile, e, _tiles_of(e[5], gs),
                                   _tiles_of(e[8], gs))
        idx = (rp << t) | (cp[None, :] ^ xl[gs, None])        # (G, rpt*len)
        src = s0[idx]
        flat = tile.reshape(batch, ng, rpt * row_len, d)
        # gathered as integers: torch.gather on CPU bfloat16 rewrites NaN
        # payloads, and a permutation moves bits
        got = torch.gather(_bits(flat), 2, src[None, :, :, None].expand(
            batch, ng, rpt * row_len, d))
        y_glob = orow[gs][:, rp] * row_len + cp
        if flags is None:
            out[:, y_glob.reshape(-1)] = got.reshape(batch, -1, d)
            continue
        got = got.masked_fill(~(xl_ok[gs, None] & s0_ok[idx])[None, :, :,
                                                               None], 0)
        keep = or_ok[gs][:, rp]                             # rows written
        out[:, y_glob[keep]] = got[:, keep]
    return out.view(xc.dtype)


def _tw_type(dtype):
    """The type the kernels read a tile of ``dtype``'s twiddles in:
    float64 for float64, float32 for the others."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _device_float(a, device) -> torch.Tensor:
    """A float32 or float64 twiddle table on ``device``."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    if t.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"twiddle tables are float32 or float64, got "
                         f"{t.dtype}")
    return t.to(device).contiguous()


def _host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _epi_plan_tensor(entries, geometry, dev, per_cta: int, *,
                     elem_bytes: int, stride_bytes: int, access: int,
                     dv: int, reg_bits: int,
                     dtype=torch.float32,
                     map_slots: Optional[int] = None) -> torch.Tensor:
    """The register-epilogue plan of a K4b or K5 launch on ``dev``
    (:func:`.epilogue_plan.plan_epilogues`, with the device pointers of
    each epilogue's per-tile tables and twiddle values filled in), built
    once per set of tables, launch geometry and element type and kept
    (twiddles as float32 values rounded to ``dtype``; float64 ones for a
    float64 tile). The tensor
    carries the plan's summary as ``.info`` and holds every table it
    points to (or was built from) in ``._keep``; the cache counts those
    tables in the entry's bytes. A table that is not linear (affine per
    block) raises ValueError. ``map_slots``: the sets of map inputs K5
    keeps (:func:`.epilogue_plan.map_checkpoints`)."""
    n, t, rpt, _, _, n_tiles, _ = geometry
    tables = tuple(a for e in entries for a in e[3:10])
    key = ("epi_plan", tuple(id(a) for a in tables),
           tuple(e[:3] for e in entries), tuple(geometry), per_cta,
           elem_bytes, stride_bytes, access, dv, reg_bits, str(dtype),
           map_slots)

    def make():
        # the plan reads the index tables and a map's tape, not the
        # twiddle values (e[9] of a butterfly)
        host = [e[:3] + tuple(None if a is None else _host(a)
                              for a in e[3:9])
                + (e[9] if e[0] == EP.KIND_MAP else None,) for e in entries]
        words, info = EP.plan_epilogues(
            host, geometry, per_cta, elem_bytes=elem_bytes,
            stride_bytes=stride_bytes, access=access, dv=dv,
            reg_bits=reg_bits, map_slots=map_slots)
        keep = [a for a in tables if a is not None]
        for k, e in enumerate(entries):
            if e[0] == EP.KIND_MAP:
                continue
            ep = EP.epi_slice(words, k)
            hb = _device_table(e[5], dev, n_tiles)
            ep[EP.EP_HI_BASE] = hb.data_ptr()
            keep.append(hb)
            if e[0] == 1:
                tb = _device_table(e[8], dev, n_tiles)
                w = _device_float(e[9], dev).to(dtype).to(_tw_type(dtype))
                if w.shape != (1 << (n - 1), 2):
                    raise ValueError(
                        f"twiddle table of shape {tuple(w.shape)}, a 2^{n} "
                        f"butterfly needs ({1 << (n - 1)}, 2)")
                ep[EP.EP_TW_BASE] = tb.data_ptr()
                ep[EP.EP_W] = w.data_ptr()
                keep += [tb, w]
        plan = torch.from_numpy(words).to(dev)
        plan.info = info
        plan._keep = tuple(keep)
        return plan, plan._keep
    owner = next((a for a in tables if a is not None), None)
    return device_cached(owner, key, dev, make)[0]


class EpiSchedule(NamedTuple):
    """How K4b (``tile_fused.cu``) or K5 (``tile_bwd.cu``) runs one
    geometry on the card (the work-item schedule of ``tile_items.cuh``).
    Words of ``word_bytes`` (the element type's own width), ``wpe`` of
    them an element; ``vec`` 1 moves 16 bytes a thread (cp.async copies
    in, 16-byte gathers or row copies out), 0 one word. A work item is
    ``per_cta`` tiles of one batch row (at most 4096 positions;
    ``n_groups`` a batch row, ``n_work`` in all); a block takes
    ``groups`` consecutive items with ``n_buf`` of them in flight (two
    where the block's shared memory stays within _EPI_TWO_SMEM), each in
    a tile (K5: an x and a ct tile) whose rows are padded by one 16-byte
    chunk (``stride`` words a row). ``grid`` blocks of ``smem`` bytes of
    dynamic shared memory; ``wpe_shift`` and ``row_shift`` are log2 of
    ``wpe`` and of a row's words, -1 if not a power of two."""
    word_bytes: int
    vec: int
    wpe: int
    wpe_shift: int
    row_shift: int
    per_cta: int
    groups: int
    n_groups: int
    n_work: int
    n_buf: int
    stride: int
    grid: int
    smem: int


_EPI_GROUPS = 2         # work items a K4b or K5 block takes
_EPI_TWO_SMEM = 48 * 1024   # a block keeps two work items in flight only
                            # within this much shared memory: above it
                            # (K5 on float32, 71 KiB) one ran faster on the
                            # H100 (tools/fused_ab.py)


def _epi_item(geometry, elem: int) -> tuple:
    """(tiles a work item, bytes a tile row takes in shared memory) of
    K4b and K5 for ``elem``-byte elements: items of at most 4096
    positions (a block's register layout) and about _TILE_CTA_BYTES,
    rows padded by one 16-byte chunk."""
    t = geometry[1]
    return (_tiles_per_cta(geometry, elem, EP.REGS * EP.THREADS),
            ((1 << t) * elem) + 16)


def k4b_schedule(geometry, batch: int, d: int, itemsize: int,
                 align: int = 0, *, n_words: int, n_epi: int, dv: int = 1,
                 groups: int = None, n_buf: int = None) -> EpiSchedule:
    """K4b's schedule for ``batch`` rows of a ``geometry`` with elements of
    ``d`` items of ``itemsize`` bytes under a plan of ``n_words`` int64
    words and ``n_epi`` epilogues (``dv`` tail values a register slot);
    ``align`` is the OR of the data, output and src0 pointers (only its
    residue mod 16 matters); ``groups`` and ``n_buf`` override the work
    items a block and those in flight (for a sweep). Raises when a block
    does not fit shared memory."""
    return _epi_schedule(tuple(geometry), int(batch), int(d), int(itemsize),
                         int(align) & 15, int(n_words), int(n_epi), int(dv),
                         1, 0, groups, n_buf)


def k5_schedule(geometry, batch: int, d: int, itemsize: int,
                align: int = 0, *, n_words: int, n_epi: int, dv: int = 1,
                n_spill: int = 0, n_map_sets: int = 0, groups: int = None,
                n_buf: int = None) -> EpiSchedule:
    """K5's schedule, as :func:`k4b_schedule` (``align`` also ORs in the
    cotangent's pointer), for a plan whose compare bits keep ``n_spill``
    sets in shared memory and whose maps keep ``n_map_sets`` sets of
    inputs there (8 registers a thread). A work item holds two tiles (x
    and ct); a second item is in flight where the block's shared memory
    stays within _EPI_TWO_SMEM."""
    extra = (n_spill * dv * EP.THREADS * 4 + n_map_sets * itemsize
             * EP.THREADS) * 8
    return _epi_schedule(tuple(geometry), int(batch), int(d), int(itemsize),
                         int(align) & 15, int(n_words), int(n_epi), int(dv),
                         2, extra, groups, n_buf)


@functools.lru_cache(maxsize=1024)
def _epi_schedule(geometry, batch, d, itemsize, align, n_words, n_epi, dv,
                  tiles_per_item, extra, groups, n_buf):
    n, t, rpt, _, _, n_tiles, _ = geometry
    elem = d * itemsize
    per_cta, stride_bytes = _epi_item(geometry, elem)
    row_len = 1 << t
    row_words = row_len * d
    vec = int(align == 0 and row_len * elem % 16 == 0 and d == dv)
    rows = per_cta * rpt
    n_groups = n_tiles // per_cta
    n_work = batch * n_groups
    groups = max(1, min(groups or _EPI_GROUPS, n_work))
    tile = (rows * stride_bytes + 15) & ~15

    def smem_of(g, in_flight):
        return (((g * 8 + 15) & ~15)
                + ((g * (2 * rows + per_cta + 2 * n_epi) * 4 + 15) & ~15)
                + ((n_words * 4 + 15) & ~15)
                + in_flight * tiles_per_item * tile + extra)
    if n_buf is None:
        n_buf = 2 if smem_of(groups, 2) <= _EPI_TWO_SMEM else 1
    n_buf = min(n_buf, groups)
    if n_buf > 1 and smem_of(groups, n_buf) > _SMEM_MAX:
        n_buf = 1                         # one item in flight
    smem = smem_of(groups, n_buf)
    if smem > _SMEM_MAX:
        raise ValueError(f"tile of {rpt} x 2^{t} elements of {elem} bytes "
                         f"with {extra} bytes of compare bits and map "
                         f"inputs needs {smem} bytes of shared memory "
                         f"(> {_SMEM_MAX})")
    return EpiSchedule(itemsize, vec, d, _shift(d), _shift(row_words),
                       per_cta, groups, n_groups, n_work, n_buf,
                       stride_bytes // itemsize, -(-n_work // groups), smem)


class _EpiArgs(ctypes.Structure):
    """``EpiTileArgs`` of ``tile_items.cuh``, field for field."""
    _fields_ = [(k, ctypes.c_void_p) for k in (
        "in_rows", "out_rows", "xor_low", "src0", "plan")] + [
        ("batch", ctypes.c_longlong), ("n_work", ctypes.c_longlong)] + [
        (k, ctypes.c_int) for k in (
            "n_words", "n_epi", "n_rows", "t", "rpt_shift", "wpe",
            "wpe_shift", "row_shift", "per_cta", "per_cta_shift", "groups",
            "n_groups", "n_buf", "stride", "word_bytes", "vec", "elem_type",
            "d", "dv", "regs", "maps", "has_cmp", "n_spill", "n_map_sets",
            "grid", "smem")]


def _epi_args(s: EpiSchedule, tabs, plan, geometry, batch: int, dtype,
              d: int, dv: int, **k5) -> _EpiArgs:
    """The launch descriptor of schedule ``s`` on device tables ``tabs``
    and plan tensor ``plan`` (K5 passes has_cmp, n_spill, n_map_sets)."""
    n, t, rpt, _, _, _, _ = geometry
    info = plan.info
    return _EpiArgs(*(a.data_ptr() for a in tabs), plan.data_ptr(), batch,
                    s.n_work, plan.numel(), len(info["hmask"]),
                    1 << (n - t), t, _shift(rpt), s.wpe, s.wpe_shift,
                    s.row_shift, s.per_cta, _shift(s.per_cta), s.groups,
                    s.n_groups, s.n_buf, s.stride, s.word_bytes, s.vec,
                    _ELEM_TYPE[dtype], d, dv, 1 << info["reg_bits"],
                    int(info["maps"] > 0), k5.get("has_cmp", 0),
                    k5.get("n_spill", 0), k5.get("n_map_sets", 0), s.grid,
                    s.smem)


def _epi_plan(xc, geometry, entries, n_buf: int, stride_bytes: int):
    """(plan tensor, dv) of a K4b (``n_buf`` 1) or K5 (2: an x and a ct
    tile) launch on work items of :func:`_epi_item`'s tiles, its layouts
    chosen for tile rows of ``stride_bytes``. K5 keeps the input values of
    as many maps as fit its shared memory with one work item in flight
    (:func:`k5_map_slots`); the others it recomputes."""
    _, t, rpt, _, _, _, _ = geometry
    size = xc.element_size()
    d = xc.shape[2]
    dv = 2 if any(e[0] == 1 for e in entries) else 1
    per_cta = _epi_item(geometry, d * size)[0]

    def plan_of(map_slots=None):
        return _epi_plan_tensor(
            entries, geometry, xc.device, per_cta, elem_bytes=d * size,
            stride_bytes=stride_bytes, access=size, dv=dv,
            reg_bits=EP.regs_for(t + _shift(rpt) + _shift(per_cta), dv,
                                 n_buf > 1,
                                 any(e[0] == EP.KIND_MAP for e in entries)),
            dtype=xc.dtype, map_slots=map_slots)
    plan = plan_of()
    if n_buf > 1 and plan.info["maps"]:
        fit = k5_map_slots(geometry, xc.shape[0], d, size, dv, plan)
        if fit < plan.info["maps"]:
            plan = plan_of(fit)
    return plan, dv


def k5_map_slots(geometry, batch: int, d: int, itemsize: int, dv: int,
                 plan) -> int:
    """The sets of map inputs (one a map: a value a register, thread,
    chunk and planar value) K5's block keeps beside its tables, plan,
    tiles and spilled compare bits within _SMEM_MAX, one work item in
    flight."""
    info = plan.info
    base = k5_schedule(geometry, batch, d, itemsize, 0,
                       n_words=plan.numel(), n_epi=len(info["hmask"]),
                       dv=dv, n_spill=EP.spill_sids(info), n_buf=1).smem
    per_map = (itemsize * EP.THREADS * (1 << info["reg_bits"])
               << info["outer_bits"]) * dv
    return max(0, (_SMEM_MAX - base) // per_map)


def _epi_launch_args(xc, geometry, entries, n_buf: int = 1,
                     align: int = 0) -> tuple:
    """(out, schedule, plan tensor, dv) of a K4b (``n_buf`` 1) or K5 (2)
    launch: the plan for the schedule's tile layout, then
    :func:`k4b_schedule` or :func:`k5_schedule` for ``xc``, its output and
    the pointers OR-ed into ``align``."""
    size, d = xc.element_size(), xc.shape[2]
    plan, dv = _epi_plan(xc, geometry, entries, n_buf,
                         _epi_item(geometry, d * size)[1])
    out = torch.empty_like(xc)
    align |= xc.data_ptr() | out.data_ptr()
    kw = dict(n_words=plan.numel(), n_epi=len(entries), dv=dv)
    if n_buf > 1:
        s = k5_schedule(geometry, xc.shape[0], d, size, align,
                        n_spill=EP.spill_sids(plan.info),
                        n_map_sets=_map_sets(plan.info, dv), **kw)
    else:
        s = k4b_schedule(geometry, xc.shape[0], d, size, align, **kw)
    return out, s, plan, dv


def _map_sets(info: dict, dv: int) -> int:
    """Sets of map inputs K5 keeps in shared memory: one a kept map slot,
    chunk and planar value."""
    return (info["map_slots"] << info["outer_bits"]) * dv


def _map_path(entries):
    """``"ext"`` when a map of the cluster holds a typed tape (K4b's and
    K5's ext map kernels run it, beside butterflies in their planar
    variants), else None."""
    if any(e[0] == EP.KIND_MAP and e[9].typed for e in entries):
        return "ext"
    return None


def _tile_fused_launch(xc, tabs, geometry, entries, flags=None):
    """K4b on tables passed as arguments under :func:`k4b_schedule`, its
    descriptor built for this call; with ``flags`` the guarded K4b, the
    same schedule with its tests, which takes no map epilogues."""
    out, s, plan, dv = _epi_launch_args(xc, geometry, entries,
                                        align=tabs[3].data_ptr())
    if flags is not None and plan.info["maps"]:
        raise ValueError("the guarded K4b variant takes no map epilogues "
                         "(guarded programs with maps run unguarded)")
    a = _epi_args(s, tabs, plan, geometry, xc.shape[0], xc.dtype,
                  xc.shape[2], dv)
    if flags is None:
        _launch("tile_fused", xc, _ptr(xc), _ptr(out), ctypes.addressof(a),
                path=_map_path(entries), moved=2 * _nbytes(xc), dv=dv)
    else:
        _launch("tile_fused_guarded", xc, _ptr(xc), _ptr(out),
                ctypes.addressof(a), _ptr(flags), moved=2 * _nbytes(xc))
    return out


def tiled_permute_tables(x: torch.Tensor, in_rows, out_rows, xor_low, src0,
                         *, geometry: tuple, epilogue: tuple = (),
                         epi_scalar: tuple = (), epi_vmem: tuple = (),
                         map_fns: tuple = (), batched: bool = False,
                         flags: torch.Tensor = None) -> torch.Tensor:
    """One tiled-BMMC pass with the index tables as arguments (int32
    tensors on ``x``'s device, or numpy arrays). ``geometry`` is
    :func:`plan_geometry` output. ``flags`` (or an enclosing
    :func:`guard_flags`) runs the guarded variant into that flag word.

    ``epilogue`` is the fused-compute signature of the reference: a tuple
    of ``("cmp", vr, vc)`` / ``("bfly", vr, vc, wlen)`` / ``("map",
    name)`` entries, with the matching tables in ``epi_scalar``
    (``(hi_base,)`` / ``(hi_base, tw_base)`` / ``()``) and ``epi_vmem``
    (``(hi_row, hi_lane)`` / ``(hi_row, hi_lane, tw_row, tw_lane,
    w_planar)`` / ``()``), and the maps' torch functions in ``map_fns``.
    A non-empty epilogue runs K4b (``tile_fused.cu``), an empty one K4a.
    On a CUDA tensor a map runs as its lowered tape and one that is not
    lowered raises ValueError; the plain version calls the function."""
    xc = _canonical(x, batched)
    if xc.shape[1] != 1 << geometry[0]:
        raise ValueError(f"axis of {xc.shape[1]} elements, geometry says "
                         f"2^{geometry[0]}")
    entries = _epi_entries(epilogue, epi_scalar, epi_vmem, map_fns, x.dtype)
    if entries:
        _check_epi_input(xc, entries, geometry)
    flags = _flags_for(x, flags)
    if isinstance(x, _FakeTensor):
        check_no_grad(x, "tiled_permute")
        moved = 2 * _nbytes(x)
        if entries:
            name = "tile_fused" if flags is None else "tile_fused_guarded"
            out = _dry_launch(xc, name, None, moved)
        elif flags is not None:
            out = _dry_launch(xc, "tile_guarded", None, moved)
        else:
            out = _dry_k4a(xc, geometry, moved)
    elif _route(x, "tiled_permute"):
        n, t, rpt, _, _, n_tiles, _ = geometry
        tabs = tuple(_device_table(a, x.device, k) for a, k in (
            (in_rows, n_tiles * rpt), (out_rows, n_tiles * rpt),
            (xor_low, n_tiles), (src0, rpt << t)))
        out = (_tile_fused_launch(xc, tabs, geometry, entries, flags)
               if entries else _tile_launch(xc, tabs, geometry, flags))
    elif entries or flags is not None:
        out = _tile_fused_plain(xc, in_rows, out_rows, xor_low, src0,
                                geometry, entries, flags)
    else:
        out = _tile_plain(xc, in_rows, out_rows, xor_low, src0, geometry)
    return out.reshape(x.shape)


# ---------------------------------------------------------------------------
# K5: the transpose of one fused pass (the gradient kernel)
# ---------------------------------------------------------------------------

def tie_masks(ueq: torch.Tensor, peq: torch.Tensor, dtype) -> tuple:
    """jax's balanced tie masks of a compare with input ``u``, partner
    ``P(u)`` and output ``o``: ``m1 = 1{u==o} / (1 + 1{P(u)==o})`` and
    ``m2`` with the roles swapped, as exact {0, 1/2, 1} values built by
    selects (``ueq = u == o``, ``peq = P(u) == o``). The transposed
    compare is ``ct * m1 + P(ct * m2)``; K5 computes the same
    (``mask_self`` / ``mask_cross`` in ``tile_bwd.cu``)."""
    one, half, zero = (torch.tensor(v, dtype=dtype, device=ueq.device)
                       for v in (1.0, 0.5, 0.0))
    return (torch.where(ueq, torch.where(peq, half, one), zero),
            torch.where(peq, torch.where(ueq, half, one), zero))


def bfly_transpose(c, q, lo, wr, wi) -> torch.Tensor:
    """The transposed planar butterfly on ``(..., 2)`` cotangents, ``q``
    the partner of ``c``: the pair's "lo" member (``lo``) takes ``c + q``,
    its "hi" member ``Wᵀ(q - c)`` with ``W`` its twiddle ``(wr, wi)``."""
    s_re = q[..., 0] - c[..., 0]
    s_im = q[..., 1] - c[..., 1]
    wt_re = wr * s_re + wi * s_im
    wt_im = wr * s_im - wi * s_re
    return torch.stack([torch.where(lo, c[..., 0] + q[..., 0], wt_re),
                        torch.where(lo, c[..., 1] + q[..., 1], wt_im)],
                       dim=-1)


def _transposed_epilogue(ct, u, o, e, hi_base_g, tw_base_g):
    """The transpose of one epilogue on cotangent tiles ``(B, G, rpt,
    row_len, d)``, given the epilogue's input ``u`` and output ``o`` (the
    reference's ``transposed_epilogues``)."""
    kind, vr, vc, hi_row, hi_lane, _, tw_row, tw_lane, _, w = e
    dev = ct.device
    rpt, row_len = ct.shape[2], ct.shape[3]
    rows = torch.arange(rpt, device=dev) ^ vr
    lanes = torch.arange(row_len, device=dev) ^ vc

    def partner(v):
        return v.index_select(2, rows).index_select(3, lanes)

    if kind == 0:
        m1, m2 = tie_masks(u == o, partner(u) == o, ct.dtype)
        return ct * m1 + partner(ct * m2)
    if kind == EP.KIND_MAP:   # the reference's jax.vjp of the function
        with torch.enable_grad():
            uu = u.detach().requires_grad_(True)
            return torch.autograd.grad(w.fn(uu), uu, ct)[0]
    hi = (((hi_row[:, None] ^ hi_lane[None, :])[None]
           ^ hi_base_g[:, None, None]) == 1)[None]
    tw = (tw_row[:, None] ^ tw_lane[None, :])[None] ^ tw_base_g[:, None, None]
    wr, wi = w[:, 0][tw][None], w[:, 1][tw][None]
    return bfly_transpose(ct, partner(ct), ~hi, wr, wi)


def _plain_entries(entries, dev, dtype=torch.float32) -> list:
    """Epilogue entries with their tables as int64 tensors on ``dev`` and
    the twiddles in the tile's type ``dtype``, rounded from float32
    (float64 for a float64 tile: the plain versions' form; the kernels read
    the same values as float32, or float64)."""
    ents = []
    for e in entries:
        if e[0] == EP.KIND_MAP:
            ents.append(e)
            continue
        tabs = [None if a is None else _long(a, dev) for a in e[3:9]]
        w = None if e[9] is None else torch.as_tensor(
            e[9], device=dev).to(_tw_type(dtype)).to(dtype)
        ents.append(e[:3] + tuple(tabs) + (w,))
    return ents


def _tile_bwd_plain(xc, cc, in_rows, out_rows, xor_low, inv_src0, geometry,
                    entries):
    """The K5 schedule with tensor indexing: tile ``g`` loads ``x`` rows
    at ``in_rows[g]`` and cotangent rows at ``out_rows[g]``, un-gathers
    the cotangent (``ct_pre.flat[k] = ct.flat[inv_src0.flat[k] ^
    xor_low[g]]``), replays the epilogues on the x tile, applies their
    transposes in reverse and writes rows ``in_rows[g]``; tiles in
    chunks."""
    n, t, rpt, _, _, n_tiles, _ = geometry
    row_len = 1 << t
    dev = xc.device
    batch, _, d = xc.shape
    ir, orow = _long(in_rows, dev), _long(out_rows, dev)
    xl, inv = _long(xor_low, dev), _long(inv_src0, dev).reshape(-1)
    ents = _plain_entries(entries, dev, xc.dtype)
    lane = torch.arange(row_len, device=dev)
    out = torch.empty_like(xc)
    step = max(1, _PLAIN_CHUNK // (rpt * row_len))
    for g0 in range(0, n_tiles, step):
        gs = slice(g0, min(n_tiles, g0 + step))
        ng = gs.stop - gs.start
        x_glob = (ir[gs][:, :, None] * row_len + lane).reshape(-1)
        y_glob = (orow[gs][:, :, None] * row_len + lane).reshape(-1)
        shape = (batch, ng, rpt, row_len, d)
        us = [xc[:, x_glob].reshape(shape)]
        for e in ents:
            us.append(_apply_epilogue(us[-1], e, _tiles_of(e[5], gs),
                                      _tiles_of(e[8], gs)))
        flat = cc[:, y_glob].reshape(batch, ng, rpt * row_len, d)
        idx = inv[None, :] ^ xl[gs, None]                  # (G, rpt*len)
        # gathered as integers, as the forward gathers
        ct = torch.gather(_int_view(flat), 2, idx[None, :, :, None].expand(
            batch, ng, rpt * row_len, d)).view(flat.dtype).reshape(shape)
        for k in range(len(ents) - 1, -1, -1):
            e = ents[k]
            ct = _transposed_epilogue(ct, us[k], us[k + 1], e,
                                      _tiles_of(e[5], gs), _tiles_of(e[8], gs))
        out[:, x_glob] = ct.reshape(batch, -1, d)
    return out


def _tile_bwd_launch(xc, cc, tabs, geometry, entries):
    out, s, plan, dv = _epi_launch_args(
        xc, geometry, entries, n_buf=2,
        align=cc.data_ptr() | tabs[3].data_ptr())
    info = plan.info
    a = _epi_args(s, tabs, plan, geometry, xc.shape[0], xc.dtype,
                  xc.shape[2], dv, has_cmp=int(info["groups"] > 0),
                  n_spill=EP.spill_sids(info),
                  n_map_sets=_map_sets(info, dv))
    _launch("tile_bwd", xc, _ptr(xc), _ptr(out), _ptr(cc),
            ctypes.addressof(a), path=_map_path(entries),
            moved=3 * _nbytes(xc), dv=dv)
    return out


def tiled_permute_bwd_tables(x: torch.Tensor, ct: torch.Tensor, in_rows,
                             out_rows, xor_low, inv_src0, *, geometry: tuple,
                             epilogue: tuple = (), epi_scalar: tuple = (),
                             epi_vmem: tuple = (), map_fns: tuple = (),
                             batched: bool = False) -> torch.Tensor:
    """The VJP of one fused tiled pass (K5, ``tile_bwd.cu``) — the
    reference's signature. ``x`` is the saved input of the pass, ``ct``
    the cotangent of its output (same shape), ``inv_src0`` the offline
    inverse of the pass's ``src0`` table; the geometry and the epilogue
    signature and tables are the forward's own (see
    :func:`tiled_permute_tables`). Returns the input's cotangent, shaped
    as ``x``. It takes float32, bfloat16, float16 and float64 (integers
    have no gradient), butterflies on their planar (re, im) tail; a map's
    gradient is reverse mode over its lowered tape in the kernel, autograd
    through its function in the plain version. A CUDA tensor launches the
    kernel, a CPU tensor runs its plain version."""
    check_no_grad(ct, "tiled_permute_bwd_tables")
    xc, cc = _canonical(x, batched), _canonical(ct, batched)
    if xc.shape != cc.shape or x.dtype != ct.dtype or x.device != ct.device:
        raise ValueError(f"x {tuple(x.shape)} {x.dtype} and ct "
                         f"{tuple(ct.shape)} {ct.dtype} differ")
    if xc.shape[1] != 1 << geometry[0]:
        raise ValueError(f"axis of {xc.shape[1]} elements, geometry says "
                         f"2^{geometry[0]}")
    entries = _epi_entries(epilogue, epi_scalar, epi_vmem, map_fns, x.dtype)
    if not entries:
        raise ValueError("the gradient kernel transposes a fused pass; a "
                         "pass without epilogues inverts as a plain pass")
    _check_epi_input(xc, entries, geometry)
    if x.dtype not in _FLOAT_TYPES:
        raise ValueError(f"gradients take float32, bfloat16, float16 or "
                         f"float64, got {x.dtype}")
    if isinstance(x, _FakeTensor):
        out = _dry_launch(xc, "tile_bwd", None, 3 * _nbytes(x))
    elif _route(x, "tiled_permute_bwd_tables"):
        if not ct.is_contiguous():
            raise ValueError("tiled_permute_bwd_tables: the CUDA kernel "
                             "takes a contiguous cotangent")
        n, t, rpt, _, _, n_tiles, _ = geometry
        tabs = tuple(_device_table(a, x.device, k) for a, k in (
            (in_rows, n_tiles * rpt), (out_rows, n_tiles * rpt),
            (xor_low, n_tiles), (inv_src0, rpt << t)))
        out = _tile_bwd_launch(xc, cc, tabs, geometry, entries)
    else:
        out = _tile_bwd_plain(xc, cc, in_rows, out_rows, xor_low, inv_src0,
                              geometry, entries)
    return out.reshape(x.shape)


def tiled_permute_bwd_tables_plain(x: torch.Tensor, ct: torch.Tensor, in_rows,
                                   out_rows, xor_low, inv_src0, *,
                                   geometry: tuple, epilogue: tuple = (),
                                   epi_scalar: tuple = (),
                                   epi_vmem: tuple = (), map_fns: tuple = (),
                                   batched: bool = False) -> torch.Tensor:
    """The plain version of :func:`tiled_permute_bwd_tables` (K5) on any
    device."""
    xc, cc = _canonical(x, batched), _canonical(ct, batched)
    entries = _epi_entries(epilogue, epi_scalar, epi_vmem, map_fns, x.dtype)
    _check_epi_input(xc, entries, geometry)
    return _tile_bwd_plain(xc, cc, in_rows, out_rows, xor_low, inv_src0,
                           geometry, entries).reshape(x.shape)


def tiled_permute(x: torch.Tensor, plan: TilePlan, *,
                  batched: bool = False) -> torch.Tensor:
    """Apply one tiled-BMMC pass. ``x``: (2^n,) or (2^n, d); with
    ``batched=True``, (B, 2^n) or (B, 2^n, d). A CUDA tensor launches K4a
    through the plan's launch record (the guarded variant inside
    :func:`guard_flags`), a CPU tensor runs the plain version."""
    device = x.device
    if device.type == "cuda" and active_guard_flags() is None:
        if _guard.enabled():
            _trap_tables(_plan_traps(plan))
        if not isinstance(x, _FakeTensor):
            return _k4a_call(x, plan, batched, device)
    _trap_tables(_plan_traps(plan))
    tabs = (device_tables(plan, x.device) if x.device.type == "cuda"
            and not isinstance(x, _FakeTensor) else
            (plan.in_rows, plan.out_rows, plan.xor_low, plan.src0))
    return tiled_permute_tables(x, *tabs, geometry=plan_geometry(plan),
                                batched=batched)


def _plan_traps(plan: TilePlan) -> list:
    n_rows = 1 << (plan.n - plan.t)
    return [("in_rows", plan.in_rows, n_rows),
            ("out_rows", plan.out_rows, n_rows),
            ("xor_low", plan.xor_low, plan.row_len),
            ("src0", plan.src0, plan.rows_per_tile * plan.row_len)]


# ---------------------------------------------------------------------------
# K2: block permute
# ---------------------------------------------------------------------------

def block_geometry(plan) -> tuple:
    """Hashable kernel geometry of a :class:`BlockPlan`."""
    return (plan.n, plan.b, plan.n_rows)


def _block_plain(xc, src_rows, geometry):
    n, b, n_rows = geometry
    xv = _bits(xc).reshape(xc.shape[0], n_rows, 1 << b, xc.shape[2])
    return xv.index_select(1, _long(src_rows, xc.device)).view(
        xc.dtype).reshape(xc.shape)


def _block_plain_guarded(xc, src_rows, geometry, flags):
    """:func:`_block_plain` with the guarded variant's test: a block whose
    ``src_rows`` entry is out of range sets bit 1 and is written as
    zeros."""
    n, b, n_rows = geometry
    src, ok = _in_range(src_rows, n_rows, flags, xc.device)
    xv = _bits(xc).reshape(xc.shape[0], n_rows, 1 << b, xc.shape[2])
    out = xv.index_select(1, src)
    out[:, ~ok] = 0
    return out.view(xc.dtype).reshape(xc.shape)


def _block_launch(xc, src_rows, geometry, flags=None):
    n, b, n_rows = geometry
    out = torch.empty_like(xc)
    blk = (1 << b) * xc.shape[2] * xc.element_size()
    wb = _word_bytes(blk, xc.data_ptr(), out.data_ptr())
    wpb = blk // wb
    per_cta = max(1, -(-_BLOCK_CTA_WORDS // wpb))
    args = (_ptr(xc), _ptr(out), _ptr(src_rows), n_rows, wpb, _shift(wpb),
            per_cta, xc.shape[0], wb)
    if flags is None:
        _launch("block", xc, *args, moved=2 * _nbytes(xc))
    else:
        _launch("block_guarded", xc, *args, _ptr(flags),
                moved=2 * _nbytes(xc))
    return out


def block_permute_tables(x: torch.Tensor, src_rows, *, geometry: tuple,
                         batched: bool = False,
                         flags: torch.Tensor = None) -> torch.Tensor:
    """Block-remapped copy: output block ``g`` reads input block
    ``src_rows[g]``. ``geometry`` is :func:`block_geometry` output.
    ``flags`` (or an enclosing :func:`guard_flags`) runs the guarded
    variant into that flag word."""
    xc = _canonical(x, batched)
    if xc.shape[1] != 1 << geometry[0]:
        raise ValueError(f"axis of {xc.shape[1]} elements, geometry says "
                         f"2^{geometry[0]}")
    flags = _flags_for(x, flags)
    if isinstance(x, _FakeTensor):
        check_no_grad(x, "block_permute")
        out = _dry_launch(xc, "block" if flags is None else "block_guarded",
                          None, 2 * _nbytes(x))
    elif _route(x, "block_permute"):
        out = _block_launch(xc, _device_table(src_rows, x.device,
                                              geometry[2]), geometry, flags)
    elif flags is not None:
        out = _block_plain_guarded(xc, src_rows, geometry, flags)
    else:
        out = _block_plain(xc, src_rows, geometry)
    return out.reshape(x.shape)


def block_permute(x: torch.Tensor, plan: BlockPlan, *,
                  batched: bool = False) -> torch.Tensor:
    _trap_tables([("src_rows", plan.src_rows, plan.n_rows)])
    tab = (device_tables(plan, x.device)[0] if x.device.type == "cuda"
           and not isinstance(x, _FakeTensor) else plan.src_rows)
    return block_permute_tables(x, tab, geometry=block_geometry(plan),
                                batched=batched)


# ---------------------------------------------------------------------------
# K3: lane permute
# ---------------------------------------------------------------------------

def lane_geometry(plan) -> tuple:
    """Hashable kernel geometry of a :class:`LanePlan`."""
    return (plan.n, plan.t, plan.rows_per_block)


def _lane_plain(xc, src_lane, geometry):
    n, t, _ = geometry
    xv = _bits(xc).reshape(xc.shape[0], 1 << (n - t), 1 << t, xc.shape[2])
    return xv.index_select(2, _long(src_lane, xc.device)).view(
        xc.dtype).reshape(xc.shape)


def _lane_launch(xc, src_lane, geometry, flags=None):
    n, t, _ = geometry
    out = torch.empty_like(xc)
    elem = xc.shape[2] * xc.element_size()
    wb = _word_bytes(elem, xc.data_ptr(), out.data_ptr())
    wpe = elem // wb
    row_bytes = (1 << t) * elem
    tab = ((1 << t) * 4 + 15) & ~15
    if tab + row_bytes > _SMEM_MAX:
        raise ValueError(f"a row of 2^{t} elements of {elem} bytes does "
                         f"not fit shared memory ({_SMEM_MAX} bytes)")
    # rows_per_block is the TPU's staging size; a block here stages
    # about _LANE_SMEM bytes of rows (at least one row)
    rows = max(1, min(1 << (n - t), _LANE_SMEM // row_bytes))
    args = (_ptr(xc), _ptr(out), _ptr(src_lane), 1 << (n - t), 1 << t, wpe,
            _shift(wpe), _shift((1 << t) * wpe), rows, xc.shape[0], wb)
    if flags is None:
        _launch("lane", xc, *args, moved=2 * _nbytes(xc))
    else:
        _launch("lane_guarded", xc, *args, _ptr(flags),
                moved=2 * _nbytes(xc))
    return out


def _lane_plain_guarded(xc, src_lane, geometry, flags):
    """:func:`_lane_plain` with the guarded variant's test: a lane whose
    ``src_lane`` entry is out of range sets bit 1 and is written as
    zeros."""
    n, t, _ = geometry
    src, ok = _in_range(src_lane, 1 << t, flags, xc.device)
    xv = _bits(xc).reshape(xc.shape[0], 1 << (n - t), 1 << t, xc.shape[2])
    out = xv.index_select(2, src)
    out[:, :, ~ok] = 0
    return out.view(xc.dtype).reshape(xc.shape)


def lane_permute_tables(x: torch.Tensor, src_lane, *, geometry: tuple,
                        batched: bool = False,
                        flags: torch.Tensor = None) -> torch.Tensor:
    """Row gather: ``out[.., row, lane] = x[.., row, src_lane[lane]]``.
    ``geometry`` is :func:`lane_geometry` output. ``flags`` (or an
    enclosing :func:`guard_flags`) runs the guarded variant into that flag
    word."""
    xc = _canonical(x, batched)
    if xc.shape[1] != 1 << geometry[0]:
        raise ValueError(f"axis of {xc.shape[1]} elements, geometry says "
                         f"2^{geometry[0]}")
    flags = _flags_for(x, flags)
    if isinstance(x, _FakeTensor):
        check_no_grad(x, "lane_permute")
        out = _dry_launch(xc, "lane" if flags is None else "lane_guarded",
                          None, 2 * _nbytes(x))
    elif _route(x, "lane_permute"):
        out = _lane_launch(xc, _device_table(src_lane, x.device,
                                             1 << geometry[1]), geometry,
                           flags)
    elif flags is not None:
        out = _lane_plain_guarded(xc, src_lane, geometry, flags)
    else:
        out = _lane_plain(xc, src_lane, geometry)
    return out.reshape(x.shape)


def lane_permute(x: torch.Tensor, plan: LanePlan, *,
                 batched: bool = False) -> torch.Tensor:
    _trap_tables([("src_lane", plan.src_lane, 1 << plan.t)])
    tab = (device_tables(plan, x.device)[0] if x.device.type == "cuda"
           and not isinstance(x, _FakeTensor) else plan.src_lane)
    return lane_permute_tables(x, tab, geometry=lane_geometry(plan),
                               batched=batched)


# ---------------------------------------------------------------------------
# K1: the copy yardstick (paper §2.3, §6)
# ---------------------------------------------------------------------------

def copy_pad_elems(size: int, rows_per_block: int = 8,
                   row_len: int = 256) -> int:
    """Elements of zero padding the reference's ``copy_through_vmem``
    appends so the array divides into whole blocks (0 = exact fit). The
    CUDA kernel pads nothing (it copies a ragged head and tail byte by
    byte); benchmarks keep this number as the label of a ragged copy."""
    blk = rows_per_block * row_len
    return (-size) % blk


def _copy_plain(x, rows_per_block, row_len):
    """The reference's schedule: zero-pad to whole blocks, copy block by
    block, slice back."""
    blk = rows_per_block * row_len
    flat = _bits(x).reshape(-1)
    pad = copy_pad_elems(flat.numel(), rows_per_block, row_len)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, rows_per_block, row_len)
    out = torch.empty_like(blocks)
    out[:] = blocks
    return out.reshape(-1)[:x.numel()].view(x.dtype).reshape(x.shape)


class CopySchedule(NamedTuple):
    """How K1 copies ``nbytes``: byte ranges ``(start, stop)`` of the head
    (before the source's first boundary of ``word_bytes``), the body of
    whole words and the tail (the rest, shorter than a word); the path,
    ``"words"`` (one block of ``threads`` a tile of ``chunk_bytes``,
    through registers) or ``"bulk"`` (bulk copies of ``chunk_bytes``
    through a ring of ``stages`` stages of ``chunk_bytes`` each); ``grid``
    blocks."""
    nbytes: int
    head: tuple
    body: tuple
    tail: tuple
    path: str
    word_bytes: int
    chunk_bytes: int
    stages: int
    threads: int
    grid: int


def copy_schedule(nbytes: int, src_ptr: int, dst_ptr: int, n_sm: int, *,
                  path: str = "words") -> CopySchedule:
    """K1's schedule for ``nbytes`` from ``src_ptr`` to ``dst_ptr`` on a
    card of ``n_sm`` multiprocessors. The words path (K1's own) moves the
    widest word both pointers agree on, one block per tile of 16 bytes a
    thread (1024 threads, or 256 below one such tile an SM). The bulk
    path, run only on request (``path="bulk"``, for testing and timing
    the ring), needs both pointers alike modulo 16 and a body of 16 bytes
    or more; its ring of 128 KiB leaves room for one block an SM."""
    return _copy_schedule(int(nbytes), src_ptr % 16, dst_ptr % 16, int(n_sm),
                          path)


@functools.lru_cache(maxsize=256)
def _copy_schedule(nbytes, src_mod, dst_mod, n_sm, path):
    if nbytes < 0 or n_sm < 1:
        raise ValueError(f"copy_schedule: nbytes {nbytes}, n_sm {n_sm}")
    w = 16
    while w > 1 and (src_mod - dst_mod) % w:
        w //= 2
    head = min(nbytes, -src_mod % w)
    body = (nbytes - head) // w * w
    if path == "words":
        big, small = _WORD_THREADS
        threads = big if body >= n_sm * big * 16 else small
        chunk, stages = threads * 16, 0
        grid = max(1, -(-body // chunk))
    elif path == "bulk":
        if w < 16 or not body:
            raise ValueError("copy_schedule: a bulk copy needs both pointers "
                             "alike modulo 16 and a body of 16 bytes or more")
        threads, chunk, stages = 32, _COPY_CHUNK, _COPY_STAGES
        grid = min(n_sm, -(-body // chunk))
    else:
        raise ValueError(f"copy_schedule: no path {path!r}")
    return CopySchedule(nbytes, (0, head), (head, head + body),
                        (head + body, nbytes), path, w, chunk, stages,
                        threads, grid)


def _sm_count(device: torch.device) -> int:
    n = _SM_COUNTS.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _SM_COUNTS[device.index] = n
    return n


def _copy_cuda(x: torch.Tensor, path: str = "words") -> torch.Tensor:
    """One launch of K1 on a contiguous CUDA tensor under
    :func:`copy_schedule` on ``path``, counted under it."""
    out = torch.empty_like(x)
    nbytes = x.numel() * x.element_size()
    if nbytes:
        s = copy_schedule(nbytes, x.data_ptr(), out.data_ptr(),
                          _sm_count(x.device), path=path)
        _launch("copy", x, _ptr(x), _ptr(out), nbytes, s.head[1],
                s.body[1] - s.body[0], 0 if s.path == "bulk" else 1,
                s.word_bytes, s.threads, s.grid, path=s.path,
                moved=2 * nbytes)
    return out


def copy_blocks(x: torch.Tensor, *, rows_per_block: int = 8,
                row_len: int = 256) -> torch.Tensor:
    """Copy, the bandwidth yardstick (the reference's
    ``copy_through_vmem``). On the card one launch of K1 under
    :func:`copy_schedule`; on the CPU the reference's schedule, whose
    block of ``rows_per_block`` x ``row_len`` elements also fixes
    :func:`copy_pad_elems`."""
    if isinstance(x, _FakeTensor):
        check_no_grad(x, "copy_blocks")
        if not x.numel():
            return torch.empty_like(x)
        return _dry_launch(x, "copy", "words", 2 * _nbytes(x))
    if not _route(x, "copy_blocks"):
        return _copy_plain(x, rows_per_block, row_len)
    return _copy_cuda(x)


# ---------------------------------------------------------------------------
# The plain versions at the plan level, on any device: what a kernel is
# held against on the card (the wrappers above take them for CPU tensors
# only).
# ---------------------------------------------------------------------------

def copy_plain(x: torch.Tensor) -> torch.Tensor:
    return _copy_plain(x, 8, 256)


def block_permute_plain(x: torch.Tensor, plan: BlockPlan, *,
                        batched: bool = False, src_rows=None,
                        flags: torch.Tensor = None) -> torch.Tensor:
    """K2's plain version on ``plan`` (its table, or ``src_rows``); the
    guarded one with ``flags``."""
    xc = _canonical(x, batched)
    tab = plan.src_rows if src_rows is None else src_rows
    if flags is not None:
        return _block_plain_guarded(xc, tab, block_geometry(plan),
                                    _check_flags(flags, x)).reshape(x.shape)
    return _block_plain(xc, tab, block_geometry(plan)).reshape(x.shape)


def lane_permute_plain(x: torch.Tensor, plan: LanePlan, *,
                       batched: bool = False, src_lane=None,
                       flags: torch.Tensor = None) -> torch.Tensor:
    """K3's plain version on ``plan`` (its table, or ``src_lane``); the
    guarded one with ``flags``."""
    xc = _canonical(x, batched)
    tab = plan.src_lane if src_lane is None else src_lane
    if flags is not None:
        return _lane_plain_guarded(xc, tab, lane_geometry(plan),
                                   _check_flags(flags, x)).reshape(x.shape)
    return _lane_plain(xc, tab, lane_geometry(plan)).reshape(x.shape)


def tiled_permute_plain(x: torch.Tensor, plan: TilePlan, *,
                        batched: bool = False, tables: tuple = None,
                        flags: torch.Tensor = None) -> torch.Tensor:
    """K4a's plain version on ``plan`` (its tables, or ``tables``: in_rows,
    out_rows, xor_low, src0); the guarded one with ``flags``."""
    return tiled_permute_tables_plain(
        x, *(tables or (plan.in_rows, plan.out_rows, plan.xor_low,
                        plan.src0)),
        geometry=plan_geometry(plan), batched=batched, flags=flags)


def tiled_permute_tables_plain(x: torch.Tensor, in_rows, out_rows, xor_low,
                               src0, *, geometry: tuple, epilogue: tuple = (),
                               epi_scalar: tuple = (), epi_vmem: tuple = (),
                               map_fns: tuple = (), batched: bool = False,
                               flags: torch.Tensor = None) -> torch.Tensor:
    """The plain version of :func:`tiled_permute_tables` (K4a or K4b) on
    any device; the guarded one with ``flags``."""
    xc = _canonical(x, batched)
    entries = _epi_entries(epilogue, epi_scalar, epi_vmem, map_fns, x.dtype)
    if entries:
        _check_epi_input(xc, entries, geometry)
    if entries or flags is not None:
        out = _tile_fused_plain(
            xc, in_rows, out_rows, xor_low, src0, geometry, entries,
            None if flags is None else _check_flags(flags, x))
    else:
        out = _tile_plain(xc, in_rows, out_rows, xor_low, src0, geometry)
    return out.reshape(x.shape)
