"""Build and load the hand-written CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, and loaded with
``ctypes``. Pointers and the CUDA stream cross that interface as
``c_void_p``; every entry point returns ``cudaGetLastError()`` and the
caller raises when it is not 0.

The libraries go to ``<checkout>/build/kernels`` (``REPRO_TORCH_BUILD_DIR``
overrides it), named by a hash of the sources and flags, so a library is
rebuilt exactly when its source changes. :func:`build_all` starts one
``nvcc`` per library, all at once (K4b's and K5's map kernels for typed
tapes are their sources built again with ``-DREPRO_MAP_EXT=1`` to ``=4``:
libraries of their own, split by element class and planar layout, so
that the base kernels keep their code and no library takes longer to
build than they; these ``nvcc`` run at a lower priority, so that the base
libraries' ``nvcc`` take the cores first).
Nothing here runs at import time, and
nothing falls back: a missing ``nvcc``, a failed compile or a failed load
raises :class:`KernelBuildError`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"

# kernel name -> (source file, C entry point, argument types after the
# two data pointers). A guarded variant (name ``*_guarded``) lives in its
# kernel's source and takes the flag word's pointer before the stream.
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the ext build's parts (kExtPart in tile_epilogue.cuh)
EXT_PARTS = (1, 2, 3, 4)
KERNELS = {
    "copy": ("copy.cu", "repro_copy", [_L, _L, _L] + [_I] * 4 + [_P]),
    "block": ("block_permute.cu", "repro_block_permute",
              [_P, _I, _I, _I, _I, _L, _I, _P]),
    "lane": ("lane_permute.cu", "repro_lane_permute",
             [_P, _I, _I, _I, _I, _I, _I, _L, _I, _P]),
    # K4a takes its launch descriptor (TilePermuteArgs) by address
    "tile": ("tile_permute.cu", "repro_tile_permute", [_P, _P]),
    # K4b and K5 take their launch descriptor (EpiTileArgs) by address
    "tile_fused": ("tile_fused.cu", "repro_tile_fused", [_P, _P]),
    "tile_bwd": ("tile_bwd.cu", "repro_tile_bwd", [_P, _P, _P]),
    "block_guarded": ("block_permute.cu", "repro_block_permute_guarded",
                      [_P, _I, _I, _I, _I, _L, _I, _P, _P]),
    "lane_guarded": ("lane_permute.cu", "repro_lane_permute_guarded",
                     [_P, _I, _I, _I, _I, _I, _I, _L, _I, _P, _P]),
    "tile_guarded": ("tile_permute.cu", "repro_tile_permute_guarded",
                     [_P, _P, _P, _P] + [_I] * 9 + [_L, _I, _P, _P]),
    "tile_fused_guarded": ("tile_fused.cu", "repro_tile_fused_guarded",
                           [_P, _P, _P]),
    # K4b's and K5's map kernels for typed tapes (map_lower.Tape.typed):
    # the same sources built with EXT_FLAGS into libraries of their own,
    # four each (ext_library)
    **{f"{k}_ext{part}": (f"{k}.cu", f"repro_{k}", rest)
       for k, rest in (("tile_fused", [_P, _P]), ("tile_bwd", [_P, _P, _P]))
       for part in EXT_PARTS},
}
GUARDED = {"block": "block_guarded", "lane": "lane_guarded",
           "tile": "tile_guarded", "tile_fused": "tile_fused_guarded"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags past NVCC_FLAGS of the libraries built from a shared source: an
# ext library instantiates the map kernels of its part's element classes
EXT_FLAGS = {name: (f"-DREPRO_MAP_EXT={name[-1]}",) for name in KERNELS
             if "_ext" in name}
EXT_NICE = 19   # the niceness added to an ext library's nvcc


def ext_library(name: str, elem_type: int, dv: int = 1) -> str:
    """The ext library of kernel ``name`` that holds the map kernel of the
    element type code ``elem_type`` (``bmmc_permute._ELEM_TYPE``) with
    ``dv`` values a register slot (``kExtPart`` in ``tile_epilogue.cuh``):
    single values part 1 for int32, float32 and bfloat16 and part 2 for
    the others; planar (re, im) pairs beside butterflies part 3 for
    float32 and float64 and part 4 for bfloat16 and float16."""
    if dv == 2:
        return f"{name}_ext{4 if elem_type in (2, 3) else 3}"
    return f"{name}_ext{1 if elem_type <= 2 else 2}"

_lock = threading.Lock()
_libs: dict = {}
BUILD_LOG: dict = {}     # kernel name -> {"seconds", "ptxas", "path"}


class KernelBuildError(RuntimeError):
    """A kernel could not be compiled or loaded."""


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + EXT_FLAGS.get(name, ())


def _lib_path(name: str) -> Path:
    src = KERNELS[name][0]
    h = hashlib.sha256()
    for part in (CSRC / src, *sorted(CSRC.glob("*.cuh"))):
        h.update(part.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    stem = name if name in EXT_FLAGS else Path(src).stem
    return build_dir() / f"{stem}-{h.hexdigest()[:16]}.so"


def _lower_priority() -> None:
    """Run this process (an ext library's ``nvcc``, before it starts) at
    :data:`EXT_NICE`: the base libraries' ``nvcc`` take the cores first."""
    os.nice(EXT_NICE)


def build_all(names=None) -> dict:
    """Compile every kernel (or ``names``) not built yet, one ``nvcc`` per
    library, all started together (a guarded variant shares its kernel's
    library, logged under the kernel's name; an ext library is its
    source built with its EXT_FLAGS, at a lower priority). Returns
    :data:`BUILD_LOG`."""
    names = list(KERNELS) if names is None else list(names)
    by_src = {}
    for n in names:
        by_src.setdefault((KERNELS[n][0], EXT_FLAGS.get(n, ())), n)
    todo = [n for n in by_src.values() if not _lib_path(n).exists()]
    if todo:
        exe = nvcc()
        build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *_flags(name), "-o", str(tmp),
               str(CSRC / KERNELS[name][0])]
        try:
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
                preexec_fn=_lower_priority if name in EXT_FLAGS else None)
        except OSError as e:
            for p, *_ in procs.values():
                p.kill()
                p.wait()
            raise KernelBuildError(f"cannot run {exe}: {e}") from e
        procs[name] = (proc, tmp, out, time.perf_counter())
    def finish(name):
        """Wait for ``name``'s nvcc: (its log, its own seconds)."""
        proc, _, _, t0 = procs[name]
        log, _ = proc.communicate()
        return log, time.perf_counter() - t0

    with ThreadPoolExecutor(max(1, len(procs))) as pool:
        done = dict(zip(procs, pool.map(finish, procs)))
    failed = []
    for name, (proc, tmp, out, _) in procs.items():
        log, seconds = done[name]
        BUILD_LOG[name] = {"seconds": seconds, "ptxas": log,
                           "path": str(out)}
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return BUILD_LOG


def load(name: str):
    """The loaded C entry point of kernel ``name``, built on first use."""
    with _lock:
        fn = _libs.get(name)
        if fn is not None:
            return fn
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise KernelBuildError(f"cannot load {path}: {e}") from e
        _, sym, rest = KERNELS[name]
        fn = getattr(lib, sym)
        fn.argtypes = [_P, _P] + rest
        fn.restype = ctypes.c_int
        _libs[name] = fn
        return fn
