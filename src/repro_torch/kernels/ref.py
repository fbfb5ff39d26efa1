"""Plain PyTorch oracle for BMMC permutations (the kernels' reference).

The counterpart of :mod:`repro.kernels.ref`. Semantics:
``out[A x ^ c] = in[x]``, i.e. ``out[y] = in[A^-1 (y ^ c)]`` — a gather
with affine-computed source indices.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.bmmc import Bmmc
from ..obs import metrics as _ometrics


def _np_parity(vals: np.ndarray) -> np.ndarray:
    v = vals.astype(np.int64)
    for s in (32, 16, 8, 4, 2, 1):
        v ^= v >> s
    return v & 1


def bmmc_indices(bmmc: Bmmc) -> np.ndarray:
    """Gather indices realizing the permutation: src[y] = A^-1 (y ^ c)."""
    binv = bmmc.inverse()  # (A^-1, A^-1 c)
    y = np.arange(1 << bmmc.n, dtype=np.int64)
    src = np.zeros_like(y)
    for i, r in enumerate(binv.rows):
        src |= _np_parity(y & r) << i
    src ^= binv.c
    return src.astype(np.int32)


@functools.lru_cache(maxsize=256)
def _src_table(rows: tuple, c: int) -> np.ndarray:
    return bmmc_indices(Bmmc(rows, c))


def audit_src_table(bmmc: Bmmc) -> np.ndarray:
    """Guard hook (ring 1): bounds- and bijection-check the CACHED gather
    table. Raises :class:`repro_torch.guard.DescriptorOOB`; returns the
    table when sound."""
    from ..guard.errors import DescriptorOOB

    tab = _src_table(bmmc.rows, bmmc.c)
    size = bmmc.size
    if tab.shape != (size,):
        raise DescriptorOOB(
            f"ref gather table shape {tab.shape} != ({size},)")
    if int(tab.min()) < 0 or int(tab.max()) >= size:
        raise DescriptorOOB(
            f"ref gather table addresses [{int(tab.min())}, "
            f"{int(tab.max())}] outside [0, {size})")
    if np.unique(tab).size != size:
        raise DescriptorOOB("ref gather table is not a bijection")
    return tab


def _check_axis(x: torch.Tensor, bmmc: Bmmc, axis: int) -> None:
    if x.dim() <= axis or x.shape[axis] != bmmc.size:
        from ..guard.errors import BadInput
        raise BadInput(f"a permutation of 2^{bmmc.n} indices needs axis "
                       f"{axis} of length {bmmc.size}, got shape "
                       f"{tuple(x.shape)}")


def bmmc_ref(x: torch.Tensor, bmmc: Bmmc, *,
             batched: bool = False) -> torch.Tensor:
    """Apply the BMMC permutation along the leading axis (a gather through
    the offline host table).

    ``batched=True`` shifts the permuted axis to axis 1: ``x`` is
    ``(B, 2^n)`` or ``(B, 2^n, d)`` and every batch row shares the one
    gather table.

    Inside a guarded run (:func:`repro_torch.kernels.bmmc_permute.
    guard_flags`) the table is tested on the tensor's device first: an
    entry outside ``[0, 2^n)`` sets bit 1 of the flag word and is clamped
    into range, so the gather never addresses outside ``x`` (on the card
    an index out of range fires a device-side assert, which loses the
    CUDA context).
    """
    from .bmmc_permute import active_guard_flags, device_cached
    axis = 1 if batched else 0
    _check_axis(x, bmmc, axis)
    _ometrics.inc("dispatch.kernel", kernel="ref")
    tab = _src_table(bmmc.rows, bmmc.c)
    # kept on the device beside the cached host table: a CUDA-graph
    # capture of a program on the "ref" engine uploads nothing
    idx = device_cached(tab, "src_index", x.device, lambda: torch.from_numpy(
        tab).to(device=x.device, dtype=torch.int64))
    flags = active_guard_flags()
    if flags is not None:
        bad = (idx < 0) | (idx >= bmmc.size)
        flags.bitwise_or_(bad.any().to(torch.int32))
        idx = idx.clamp(0, bmmc.size - 1)
    return torch.index_select(x, axis, idx)


def _parity(v: torch.Tensor) -> torch.Tensor:
    for s in (32, 16, 8, 4, 2, 1):
        v = v ^ (v >> s)
    return v & 1


def _apply_linear(rows: tuple, y: torch.Tensor) -> torch.Tensor:
    """``A y`` over F2 for an int64 index tensor (row i of ``A`` gives
    bit i)."""
    out = torch.zeros_like(y)
    for i, r in enumerate(rows):
        out |= _parity(y & r) << i
    return out


def bmmc_src_index(bmmc: Bmmc, device="cuda", *, start: int = 0,
                   stop: int = None) -> torch.Tensor:
    """Source indices ``A^-1 (y ^ c)`` for ``y`` in ``[start, stop)``,
    computed on ``device`` as int64. ``A^-1`` is linear, so it is applied
    to the high and the low half of ``y``'s bits separately: two small
    tables on the device, one gather from each."""
    n = bmmc.n
    stop = (1 << n) if stop is None else stop
    binv = bmmc.inverse()
    k = (n + 1) // 2
    lo_tab = _apply_linear(binv.rows, torch.arange(
        1 << k, dtype=torch.int64, device=device))
    hi_tab = _apply_linear(binv.rows, torch.arange(
        1 << (n - k), dtype=torch.int64, device=device) << k)
    y = torch.arange(start, stop, dtype=torch.int64, device=device)
    return hi_tab[y >> k] ^ lo_tab[y & ((1 << k) - 1)] ^ binv.c


def bmmc_ref_device(x: torch.Tensor, bmmc: Bmmc, *, batched: bool = False,
                    chunk: int = 1 << 26) -> torch.Tensor:
    """Same semantics as :func:`bmmc_ref`, source indices computed on the
    tensor's device in chunks (the counterpart of the reference's
    ``bmmc_ref_jnp``): no host table, and memory bounded by ``chunk``,
    so it serves as the oracle at the paper's size (n = 30)."""
    axis = 1 if batched else 0
    _check_axis(x, bmmc, axis)
    out = torch.empty_like(x)
    for s in range(0, bmmc.size, chunk):
        e = min(bmmc.size, s + chunk)
        idx = bmmc_src_index(bmmc, x.device, start=s, stop=e)
        out.narrow(axis, s, e - s).copy_(torch.index_select(x, axis, idx))
    return out
