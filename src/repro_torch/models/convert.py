"""Carry parameter and cache trees across from the reference.

The reference's trees, brought to the host as nested dicts of numpy
arrays (``jax.tree.map(np.asarray, params)``), become the port's nested
dicts of tensors, path for path. A bfloat16 array arrives with the
``ml_dtypes`` bfloat16 type; it is read through a ``uint16`` view and
reinterpreted as ``torch.bfloat16``, so the bits carry over unchanged and
neither ``ml_dtypes`` nor JAX is imported here.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


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
