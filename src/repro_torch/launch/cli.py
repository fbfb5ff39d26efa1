"""Helpers of the port's example scripts (``examples/*_torch.py``).

Each example takes ``--device`` (default ``cuda``). :func:`device_of`
refuses a CUDA device that is not there instead of falling back to the
CPU; ``--device cpu`` runs every kernel's plain version. :func:`timed_ms`
times a call with CUDA events on a card and with the host clock on the
CPU. :func:`counting` records the executor's counters (fused clusters,
fallbacks) for a block of calls. :func:`check` turns a failed self-check
into a non-zero exit. :func:`print_launches` prints the kernel launch
counts as one line of ``name=count`` pairs, which ``chip_smoke.py``
reads back.
"""
from __future__ import annotations

import contextlib
import time

import torch

from .. import obs
from ..kernels import bmmc_permute as _K


class SelfCheckFailed(SystemExit):
    """A self-check of an example failed: the process exits non-zero."""


def device_of(name: str, prog: str = "example") -> torch.device:
    """``name`` as a torch device. A CUDA device that torch cannot see
    raises :class:`SelfCheckFailed`: nothing falls back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SelfCheckFailed(
            f"{prog}: --device {name}: no CUDA device is visible to torch "
            f"(--device cpu runs the kernels' plain versions)")
    return dev


def check(ok, what: str) -> None:
    """Exit non-zero with ``what`` unless ``ok``."""
    if not ok:
        raise SelfCheckFailed(f"self-check failed: {what}")


def timed_ms(fn, device: torch.device):
    """``(fn(), ms)``: CUDA events around the call on a card (the time
    ends when the card is done), the host clock on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def print_launches(where: str = "") -> dict:
    """Print ``kernel launches[ where]: name=count ...`` for every
    kernel wrapper's count (0 on the CPU, where the plain versions run)
    and return the counts."""
    counts = _K.launch_counts()
    tag = f" {where}" if where else ""
    print(f"kernel launches{tag}: "
          + " ".join(f"{k}={v}" for k, v in counts.items()), flush=True)
    return counts


@contextlib.contextmanager
def counting():
    """Telemetry on, its counters from zero, for the body (they stay
    readable after it); off again after unless it was on before."""
    was = obs.enabled()
    obs.reset()
    obs.enable(sync=False)
    try:
        yield obs
    finally:
        if not was:
            obs.disable()
