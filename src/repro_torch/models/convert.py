"""Carry parameter, cache and optimizer-state trees across from the
reference.

The reference's trees, brought to the host as nested dicts of numpy
arrays (``jax.tree.map(np.asarray, params)``), become the port's nested
dicts of tensors, path for path; its ``AdamWState`` (the step, float32
moments or the ``{"q", "s"}`` dicts of 8-bit moments) becomes the port's
and back, bit for bit. A bfloat16 array arrives with the
``ml_dtypes`` bfloat16 type; it is read through a ``uint16`` view and
reinterpreted as ``torch.bfloat16``, so the bits carry over unchanged and
neither ``ml_dtypes`` nor JAX is imported here.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..optim.adamw import AdamWState


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """One array as a tensor on ``device``, bit for bit. The tensor owns
    a copy (the caches are written in place by decode)."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor as a numpy array on the host. numpy has no bfloat16 of
    its own, so a bfloat16 tensor comes back as float32 (exactly)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree: Dict, device="cuda") -> Dict:
    """The reference's parameter tree (numpy leaves) as the port's."""
    return _map(lambda a: tensor_from_numpy(a, device), tree)


# The reference's KV caches (numpy leaves) as the port's: the same walk.
caches_from_numpy = params_from_numpy


def caches_to_numpy(tree: Dict) -> Dict:
    """The port's KV caches as numpy leaves (bfloat16 as float32)."""
    return _map(_tensor_to_numpy, tree)


def opt_state_from_numpy(state, device="cuda") -> AdamWState:
    """The reference's ``AdamWState`` (numpy leaves; any object with
    ``step``, ``m`` and ``v``) as the port's, bit for bit."""
    return AdamWState(step=tensor_from_numpy(state.step, device),
                      m=params_from_numpy(state.m, device),
                      v=params_from_numpy(state.v, device))


def opt_state_to_numpy(state: AdamWState) -> AdamWState:
    """The port's ``AdamWState`` with numpy leaves, bit for bit (the
    reference's is ``repro.optim.adamw.AdamWState(*this)``)."""
    def host(t):
        return t.detach().cpu().numpy()
    return AdamWState(step=host(state.step), m=_map(host, state.m),
                      v=_map(host, state.v))
