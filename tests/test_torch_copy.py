"""K1's host schedule (``copy_schedule``) on the CPU.

The CUDA kernel runs only on the card (``tests/test_torch_cuda.py`` holds
it bit for bit against ``copy_plain``). Here the schedule it launches
from is held to its contract: the head, body and tail partition the
bytes exactly, the bulk path's body is 16-byte aligned on both sides,
the grid never exceeds the chunks; and a plain emulation of the two
kernels' loops (byte ranges copied block by block, in the kernels'
order) reproduces the input byte for byte, each byte written once, and
equals the reference's ``copy_through_vmem`` (interpret mode). No
tolerance: a copy computes nothing.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import bmmc_permute as rk
from repro_torch.kernels import bmmc_permute as pk

S = pk._COPY_CHUNK          # one default stage of the bulk ring
T = 16 * pk._WORD_THREADS[0]  # one tile of the words path, 1024 threads
SIZES = ([0, 1, 15, 16, 17]
         + [k * st + d for st in (T, S) for k in (1, 2, 3) for d in (-1, 0, 1)]
         + [(1 << 32) - 4, 1 << 32, (1 << 32) + 4])
BASE = 1 << 20              # a made-up 512-byte-aligned allocation


def _check(s, nbytes, src, dst, n_sm):
    h0, h1 = s.head
    b0, b1 = s.body
    t0, t1 = s.tail
    assert (h0, h1, b1, t1) == (0, b0, t0, nbytes) and h1 <= b1 <= t1
    w = s.word_bytes
    assert w == 16 or (src - dst) % (2 * w) != 0      # the widest word
    assert (src - dst) % w == 0
    assert h1 < w and t1 - t0 < w and h1 < 16 and t1 - t0 < 16
    assert (b1 - b0) % w == 0
    if b1 > b0:
        assert (src + b0) % w == 0 and (dst + b0) % w == 0
    n_chunks = -(-(b1 - b0) // s.chunk_bytes)
    if s.path == "bulk":
        assert w == 16 and b1 - b0 >= 16
        assert (src + b0) % 16 == 0 and (dst + b0) % 16 == 0
        assert (s.chunk_bytes, s.stages, s.threads) == (S, 4, 32)
        assert s.grid == min(n_sm, n_chunks)    # one block an SM at most
    else:
        big, small = pk._WORD_THREADS
        assert s.path == "words" and s.chunk_bytes == 16 * s.threads
        assert s.threads == (big if b1 - b0 >= n_sm * 16 * big else small)
        assert s.stages == 0
        assert s.grid == max(1, n_chunks)   # a block a tile; one for edges
    assert 1 <= s.grid <= max(1, n_chunks)


@pytest.mark.parametrize("nbytes", SIZES)
def test_copy_schedule_partitions_every_alignment(nbytes):
    for n_sm in (132, 1):
        for a in range(16):
            for b in range(16):
                src, dst = BASE + a, 2 * BASE + b
                s = pk.copy_schedule(nbytes, src, dst, n_sm)
                _check(s, nbytes, src, dst, n_sm)
                if (a - b) % 16 or nbytes - (-a % 16) < 16:
                    continue
                s = pk.copy_schedule(nbytes, src, dst, n_sm, path="bulk")
                _check(s, nbytes, src, dst, n_sm)


def test_copy_schedule_defaults():
    """2^30 int32 in 16 KiB tiles, one block each (2^14 int32 in 4 KiB
    tiles, so 16 multiprocessors take part); a ragged 2^30 - 1 keeps
    the same 16-byte words but for its last 12 bytes; a view at a 4-byte
    offset moves 4-byte words; the bulk ring is 4 stages of 32 KiB, one
    block per multiprocessor."""
    big = pk.copy_schedule(1 << 32, BASE, 2 * BASE, 132)
    assert (big.path, big.word_bytes, big.grid) == ("words", 16,
                                                    (1 << 32) // T)
    ragged = pk.copy_schedule((1 << 32) - 4, BASE, 2 * BASE, 132)
    assert ragged.word_bytes == 16 and ragged.body == (0, (1 << 32) - 16)
    assert ragged.tail == ((1 << 32) - 16, (1 << 32) - 4)
    small = pk.copy_schedule(1 << 16, BASE, 2 * BASE, 132)
    assert (small.threads, small.grid) == (256, 16)
    view = pk.copy_schedule((1 << 32) - 4, BASE + 4, 2 * BASE, 132)
    assert (view.path, view.word_bytes) == ("words", 4)
    ring = pk.copy_schedule(1 << 32, BASE, 2 * BASE, 132, path="bulk")
    assert (ring.chunk_bytes, ring.stages, ring.grid) == (S, 4, 132)
    few = pk.copy_schedule(3 * S - 5, BASE + 5, 2 * BASE + 5, 132,
                           path="bulk")
    assert few.grid == 3 and few.head == (0, 11)


def test_copy_schedule_refuses_what_the_kernels_cannot_run():
    with pytest.raises(ValueError, match="bulk copy needs"):
        pk.copy_schedule(1 << 20, BASE + 4, 2 * BASE, 132, path="bulk")
    with pytest.raises(ValueError, match="bulk copy needs"):
        pk.copy_schedule(15, BASE, 2 * BASE, 132, path="bulk")
    with pytest.raises(ValueError, match="no path"):
        pk.copy_schedule(1 << 20, BASE, 2 * BASE, 132, path="dma")
    with pytest.raises(ValueError):
        pk.copy_schedule(-1, BASE, 2 * BASE, 132)


def _emulate(src: np.ndarray, s) -> np.ndarray:
    """``copy.cu`` under schedule ``s`` on a byte array: each block's
    writes in the kernel's order (block 0's edges, then a words block's
    one tile, or a bulk block's chunks through its ring, grid-strided);
    every byte must be written exactly once."""
    out = np.zeros_like(src)
    seen = np.zeros(src.size, np.int64)

    def put(lo, hi):
        out[lo:hi] = src[lo:hi]
        seen[lo:hi] += 1

    h1, (b0, b1), t0 = s.head[1], s.body, s.tail[0]
    for blk in range(s.grid):
        if blk == 0:
            put(0, h1)
            put(t0, s.nbytes)
        j = blk
        while j < -(-(b1 - b0) // s.chunk_bytes):
            lo = j * s.chunk_bytes
            if s.path == "bulk":
                put(b0 + lo, b0 + min(lo + s.chunk_bytes, b1 - b0))
            else:    # word k * threads + t of the tile is thread t's k-th
                w = s.word_bytes
                k, t = np.divmod(np.arange(16 // w * s.threads), s.threads)
                at = lo + (k * s.threads + t) * w
                at = b0 + at[at < b1 - b0]
                idx = (at[:, None] + np.arange(w)).ravel()
                out[idx] = src[idx]
                np.add.at(seen, idx, 1)
            j += s.grid
    assert (seen == 1).all()
    return out


DTYPES = [np.uint8, np.bool_, np.int16, ml_dtypes.bfloat16, np.float16,
          np.int32, np.float32, np.int64, np.float64, np.complex64]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("src_off,dst_off", [(0, 0), (3, 3), (4, 0), (1, 2)])
def test_schedule_emulation_copies_every_byte(dtype, src_off, dst_off):
    rng = np.random.default_rng(16 + src_off)
    itemsize = np.dtype(dtype).itemsize
    n = int(rng.integers(3 * S, 5 * S)) // itemsize + 3   # ragged
    src = rng.integers(0, 256, n * itemsize, dtype=np.uint8)
    x = src.view(dtype)
    for n_sm, path in ((132, "words"), (1, "words"), (2, "bulk"),
                       (1, "bulk")):
        if path == "bulk" and (src_off - dst_off) % 16:
            continue
        s = pk.copy_schedule(src.size, BASE + src_off, 2 * BASE + dst_off,
                             n_sm, path=path)
        got = _emulate(src, s).view(dtype)
        assert np.array_equal(got.view(np.uint8), x.view(np.uint8))
    t = torch.from_numpy(src)
    assert torch.equal(pk.copy_blocks(t), t)     # the CPU's plain version


@pytest.mark.parametrize("dtype", [np.float32, np.int32, ml_dtypes.bfloat16],
                         ids=lambda d: np.dtype(d).name)
def test_schedule_emulation_matches_pallas_copy(dtype):
    """The same ragged input through the reference's copy (interpret
    mode) and through the emulated schedule of a misaligned view. The
    bits stay below bfloat16's NaNs, which XLA's CPU copy makes
    canonical."""
    n = 3 * 2048 + 37
    raw = np.random.default_rng(5).integers(0, 0x7F00, n).astype(np.int16)
    arr = raw.astype(dtype) if dtype != ml_dtypes.bfloat16 else raw.view(dtype)
    want = np.asarray(rk.copy_through_vmem(jnp.asarray(arr), interpret=True))
    src = arr.view(np.uint8)
    for off in (0, 4, 6):
        s = pk.copy_schedule(src.size, BASE + off, 2 * BASE, 4)
        got = _emulate(src, s)
        assert np.array_equal(got, want.view(np.uint8)), off


def test_copy_on_the_cpu_counts_no_launch():
    before = pk.launch_counts()
    x = torch.arange(5000, dtype=torch.int32)
    assert torch.equal(pk.copy_blocks(x[1:]), x[1:])
    assert torch.equal(pk.copy_blocks(x.view(torch.uint8)[3:]),
                       x.view(torch.uint8)[3:])
    assert pk.launch_counts() == before
    assert {"copy", "copy_bulk", "copy_words"} <= set(before)
