"""Checkpoint/restore with an integrity manifest.

The counterpart of :mod:`repro.checkpoint.ckpt`, in the same layout (one
directory per step)::

    <dir>/step_00000100/
        manifest.json      # step, data-pipeline state, leaf index,
                           # per-leaf sha256 — integrity-checked on restore
        arrays.npz         # flattened leaves (full arrays on the host)

Leaves are keyed by the reference's paths (``0/embed``, ``1/.m/embed``,
``1/.step`` for a ``(params, AdamWState)`` tree), so either package
restores what the other saved. numpy has no bfloat16 of its own: a
bfloat16 leaf is written as its raw 16-bit words with numpy type ``V2``
and ``"bfloat16"`` in the manifest, as the reference writes it (through
``ml_dtypes``), so the bytes and their sha256 are the same. Restore
returns tensors, on ``device`` (the host by default): ``device`` takes
the place of the reference's ``shardings``.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_BF16 = "bfloat16"
_V2 = np.dtype("V2")


def _children(tree) -> Optional[list]:
    """``(key, child)`` pairs of an inner node (the reference's path
    keys: a dict key, a tuple index, ``.name`` for a NamedTuple field),
    or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _walk(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for k, v in kids:
        yield from _walk(v, f"{prefix}/{k}" if prefix else k)


def _rebuild(template, leaf_of, prefix: str = ""):
    """``template``'s structure with each leaf replaced by
    ``leaf_of(key)``."""
    kids = _children(template)
    if kids is None:
        return leaf_of(prefix)
    built = [_rebuild(v, leaf_of, f"{prefix}/{k}" if prefix else k)
             for k, v in kids]
    if isinstance(template, dict):
        return dict(zip(sorted(template), built))
    if hasattr(template, "_fields"):
        return type(template)(*built)
    return type(template)(built)


def _to_numpy(leaf) -> np.ndarray:
    """One leaf on the host; bfloat16 as its 16-bit words typed ``V2``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_V2)
        return t.numpy()
    a = np.asarray(leaf)
    if a.dtype.name == _BF16:
        return np.ascontiguousarray(a).view(_V2)
    return a


def _dtype_name(a: np.ndarray) -> str:
    return _BF16 if a.dtype == _V2 else str(a.dtype)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in _walk(tree)}


def _fsync_dir(path: str) -> None:
    """Best-effort directory fsync (persists the rename itself)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - platform without dir-open
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(dirpath: str, step: int, tree: Any, *,
         extra_state: Optional[Dict] = None, keep_last: int = 3) -> str:
    """Atomic + durable checkpoint write; prunes old steps.

    Every payload is flushed and fsync'd inside a hidden tmp dir, the tmp
    dir itself is fsync'd, and only then does a single ``os.replace``
    publish the step directory (parent dir fsync'd after, so the rename
    survives a power cut). A job killed at ANY instant therefore leaves
    either the complete published step or an invisible ``.tmp_ckpt_*``
    orphan — never a torn ``step_*`` a restore could trip over.
    """
    target = os.path.join(dirpath, f"step_{step:08d}")
    os.makedirs(dirpath, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=dirpath, prefix=".tmp_ckpt_")
    try:
        flat = _flatten(tree)
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        manifest = {
            "step": step,
            "extra_state": extra_state or {},
            "leaves": {k: {"shape": list(v.shape), "dtype": _dtype_name(v),
                           "sha256": hashlib.sha256(v.tobytes()).hexdigest()}
                       for k, v in flat.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        if os.path.exists(target):
            shutil.rmtree(target)
        os.replace(tmp, target)
        _fsync_dir(dirpath)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _prune(dirpath, keep_last)
    return target


def _prune(dirpath: str, keep_last: int):
    steps = sorted(d for d in os.listdir(dirpath) if d.startswith("step_"))
    for d in steps[:-keep_last] if keep_last else []:
        shutil.rmtree(os.path.join(dirpath, d), ignore_errors=True)


def latest_step(dirpath: str) -> Optional[int]:
    if not os.path.isdir(dirpath):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(dirpath)
             if d.startswith("step_")]
    return max(steps) if steps else None


def _to_tensor(a: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    if dtype_name == _BF16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t if device is None else t.to(device)


def restore(dirpath: str, step: int, template: Any, *,
            device=None, verify: bool = True):
    """Restore a tree of tensors shaped like ``template`` (tensors on
    ``device``, the host by default); raises on integrity mismatch.
    Returns (tree, extra_state).
    """
    target = os.path.join(dirpath, f"step_{step:08d}")
    with open(os.path.join(target, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(target, "arrays.npz"))

    def leaf_of(key):
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = data[key]
        meta = manifest["leaves"][key]
        if verify:
            digest = hashlib.sha256(arr.tobytes()).hexdigest()
            if digest != meta["sha256"]:
                raise IOError(f"integrity failure for leaf {key!r}")
        return _to_tensor(arr, meta["dtype"], device)

    return _rebuild(template, leaf_of), manifest["extra_state"]
