"""On the card: each CUDA kernel of the PyTorch port against its plain
PyTorch version, bit for bit, and ``bmmc_permute`` against the plain
gather. This file imports only torch, numpy and ``repro_torch`` (the
machine with the card has no JAX); its tests are marked ``cuda`` and
skip where torch sees no CUDA device::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import random

import pytest
import torch

from repro_torch.core.bmmc import Bmmc
from repro_torch.kernels import bmmc_permute as pk
from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref

import _torch_typed_maps as _TM


def _bmmc(kind, n, rng):
    ident = tuple(1 << i for i in range(n))
    if kind == "block":
        sub = Bmmc.random(n - n // 2, rng)
        return Bmmc(ident[:n // 2] + tuple(r << (n // 2) for r in sub.rows),
                    sub.c << (n // 2))
    if kind == "lane":
        sub = Bmmc.random(2, rng)
        return Bmmc(tuple(sub.rows) + ident[2:], sub.c)
    return {"bitrev": lambda: Bmmc.bit_reverse(n),
            "bmmc": lambda: Bmmc.random(n, rng),
            "mixed": lambda: Bmmc.xor_shift(n, 5 | (1 << (n - 2)))}[kind]()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tail,batch", [
    (torch.int32, (), None), (torch.bfloat16, (), None),
    (torch.float32, (8,), None), (torch.int32, (), 3),
    (torch.bool, (3,), 2)])
def test_cuda_kernels_match_plain(cuda_device, dtype, tail, batch):
    n = 12
    rng = random.Random(41)
    shape = ((batch,) if batch else ()) + (1 << n,) + tail
    raw = torch.randint(0, 1 << 15, shape, device=cuda_device)
    x = raw.to(dtype) if dtype != torch.bfloat16 else raw.to(
        torch.int16).view(torch.bfloat16)
    bb = bool(batch)
    counts = pk.launch_counts()
    for kind in ("bitrev", "bmmc", "block", "lane", "mixed"):
        b = _bmmc(kind, n, rng)
        kernel, payload = pops.class_plan(b, 3)
        if kernel == "block":
            got, want = (pk.block_permute(x, payload, batched=bb),
                         pk.block_permute_plain(x, payload, batched=bb))
        elif kernel == "lane":
            got, want = (pk.lane_permute(x, payload, batched=bb),
                         pk.lane_permute_plain(x, payload, batched=bb))
        else:
            got, want = (pk.tiled_permute(x, payload[0], batched=bb),
                         pk.tiled_permute_plain(x, payload[0], batched=bb))
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
        assert torch.equal(
            pops.bmmc_permute(x, b, batched=bb).view(torch.uint8),
            pref.bmmc_ref(x, b, batched=bb).view(torch.uint8))
    y = x.reshape(-1)[: x.numel() - 5]
    assert torch.equal(pk.copy_blocks(y).view(torch.uint8),
                       pk.copy_plain(y).view(torch.uint8))
    after = pk.launch_counts()
    assert all(after[k] > counts[k] for k in ("copy", "block", "lane",
                                              "tile")), (counts, after)


@pytest.mark.cuda
def test_cuda_kernels_on_a_card_that_is_not_current(cuda_device):
    """K1-K4a on tensors of the second card while the first is current:
    each wrapper launches on its tensor's device and stream (``_launch``
    switches device only then), bit-equal to the plain versions, and
    leaves the current device as it was."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA device")
    dev = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    rng = random.Random(7)
    n = 12
    x = torch.randint(0, 1 << 30, (1 << n,), device=dev, dtype=torch.int32)
    counts = pk.launch_counts()
    for kind in ("bitrev", "bmmc", "block", "lane"):
        b = _bmmc(kind, n, rng)
        assert torch.equal(pops.bmmc_permute(x, b), pref.bmmc_ref(x, b))
    y = x.view(torch.uint8)[3:]
    assert torch.equal(pk.copy_blocks(y), pk.copy_plain(y))
    torch.cuda.synchronize(dev)
    after = pk.launch_counts()
    assert all(after[k] > counts[k] for k in ("copy", "block", "lane",
                                              "tile")), (counts, after)
    assert torch.cuda.current_device() == 0


_COPY_DTYPES = [torch.uint8, torch.bool, torch.int16, torch.bfloat16,
                torch.float16, torch.int32, torch.float32, torch.int64,
                torch.float64, torch.complex64]


def _copy_checked(x, path=None):
    """K1 on ``x`` (``copy_blocks``, or ``_copy_cuda`` on ``path``)
    against ``copy_plain``, bit for bit, with the launch counted once
    under the path its schedule names."""
    before = pk.launch_counts()
    got = pk._copy_cuda(x, path) if path else pk.copy_blocks(x)
    want = pk.copy_plain(x)
    assert got.shape == x.shape and got.dtype == x.dtype
    assert torch.equal(got.contiguous().view(torch.uint8),
                       want.contiguous().view(torch.uint8))
    after = pk.launch_counts()
    nbytes = x.numel() * x.element_size()
    if nbytes == 0:
        assert after == before
        return None
    path = path or "words"
    assert after["copy"] == before["copy"] + 1
    assert after[f"copy_{path}"] == before[f"copy_{path}"] + 1
    return path


def _random_bytes(n, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, (n,), generator=gen, device=device,
                         dtype=torch.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", _COPY_DTYPES, ids=str)
def test_cuda_copy_matches_plain(cuda_device, dtype):
    """Every dtype the port moves, at sizes around the edges, a tile and a
    stage: 0, 1, 15, 16 and 17 bytes (as uint8), a stage +- 1 element,
    3 * 2048 + 37 int32 worth of bytes (and, in int32, a ragged copy of
    more than five chunks an SM, so the ring wraps); through K1's words
    path and through the bulk ring (where the body has 16 bytes)."""
    item = torch.empty((), dtype=dtype).element_size()
    stage = pk._COPY_CHUNK // item
    counts = [0, 1, 15, 16, 17] if dtype == torch.uint8 else [0, 1, 17]
    counts += [stage - 1, stage, stage + 1, (3 * 2048 + 37) * 4 // item]
    if dtype == torch.int32:
        counts.append(5 * pk._sm_count(cuda_device) * stage + 3)
    for i, n in enumerate(counts):
        raw = _random_bytes(n * item, cuda_device, i)
        x = raw.view(dtype) if dtype != torch.bool else raw.bool()
        _copy_checked(x)
        if n * item >= 16:
            _copy_checked(x, path="bulk")


@pytest.mark.cuda
def test_cuda_copy_of_misaligned_views(cuda_device):
    """Sources that are uint8 views at byte offsets 0-15 (the output is a
    fresh, aligned tensor): the words path with the widest word both
    pointers agree on; at offset 0 the bulk ring too."""
    base = _random_bytes(3 * pk._COPY_CHUNK + 64, cuda_device, 16)
    for off in range(16):
        for n in (1, 15, 16, 17, pk._COPY_CHUNK - 1, pk._COPY_CHUNK + 1,
                  3 * pk._COPY_CHUNK + 5):
            v = base[off:off + n]
            assert _copy_checked(v) == "words"
            if off == 0 and n >= 16:
                _copy_checked(v, path="bulk")
    x = base[4:4 + 4 * 6181].view(torch.int32)
    assert _copy_checked(x) == "words"


@pytest.mark.cuda
def test_cuda_copy_under_graph_capture(cuda_device):
    """K1 recorded into a CUDA graph (words path, aligned and at a 3-byte
    offset; the bulk ring) and replayed copies what it copies eagerly;
    the capture and the replays count no launch."""
    big = _random_bytes(4 * (3 * 2048 + 37) + 7, cuda_device, 3)
    xs = [big[:4 * (3 * 2048 + 37)].view(torch.int32), big[3:]]
    calls = [lambda x: pk.copy_blocks(x), lambda x: pk.copy_blocks(x),
             lambda x: pk._copy_cuda(x, path="bulk")]
    xs.append(xs[0])
    for call, x in zip(calls, xs):
        call(x)
    torch.cuda.synchronize()
    before = pk.launch_counts()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs = [call(x) for call, x in zip(calls, xs)]
    big.copy_(_random_bytes(big.numel(), cuda_device, 4))
    g.replay()
    torch.cuda.synchronize()
    for x, out in zip(xs, outs):
        assert torch.equal(out.view(torch.uint8),
                           pk.copy_plain(x).view(torch.uint8))
    assert pk.launch_counts() == before


@pytest.mark.cuda
def test_cuda_wrappers_refuse_wrong_tables(cuda_device):
    plan = pops.class_plan(Bmmc.bit_reverse(12), 3)[1][0]
    x = torch.zeros(1 << 12, dtype=torch.int32, device=cuda_device)
    geom = pk.plan_geometry(plan)
    with pytest.raises(ValueError, match="index table"):
        pk.tiled_permute_tables(x, plan.in_rows[:-1], plan.out_rows,
                                plan.xor_low, plan.src0, geometry=geom)
    with pytest.raises(ValueError, match="contiguous"):
        pk.tiled_permute(torch.zeros(2, 1 << 12, dtype=torch.int32,
                                     device=cuda_device)[:, ::1].t(), plan,
                         batched=False)


def _fused_clusters(expr, n, t):
    from repro_torch.combinators import FusedStage, compile_expr
    prog = compile_expr(expr).clustered_program(n, t)
    return [s for s in prog if isinstance(s, FusedStage) and s.computes]


def _fused(fs, t, x, batched, plain):
    """One cluster's first pass through K4b (tables given as numpy, as a
    caller of the wrapper may), or through its plain version."""
    from repro_torch.combinators import execute as ex
    plans, entries = ex._fused_plan_cached(fs, t)
    plan = plans[0]
    sig, scal, vmem, fns = ex._fused_kernel_args(entries, x.dtype)
    kw = dict(geometry=pk.plan_geometry(plan), epilogue=sig,
              epi_scalar=scal, epi_vmem=vmem, map_fns=fns, batched=batched)
    if plain:
        return pk.tiled_permute_tables_plain(
            x, plan.in_rows, plan.out_rows, plan.xor_low, plan.src0, **kw)
    return pk.tiled_permute_tables(x, *pk.device_tables(plan, x.device),
                                   **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tail,batch", [
    (torch.int32, (), None), (torch.float32, (), None),
    (torch.bfloat16, (), None), (torch.float32, (3,), None),
    (torch.int32, (), 3)])
def test_cuda_fused_cmp_matches_plain(cuda_device, dtype, tail, batch):
    """K4b compare-exchange epilogues bit for bit against the plain
    version, NaNs and signed zeros included."""
    from repro_torch.combinators.sort import sort_expr
    n = 12
    d = tail[0] if tail else 1
    t = pops.choose_tile(n, torch.tensor([], dtype=dtype).element_size(), d)
    shape = ((batch,) if batch else ()) + (1 << n,) + tail
    v = torch.randint(-4, 5, shape, device=cuda_device).to(torch.float32)
    u = torch.rand(shape, device=cuda_device)
    v = torch.where(u < 0.05, torch.full_like(v, float("nan")), v)
    v = torch.where((u > 0.5) & (v == 0), torch.full_like(v, -0.0), v)
    x = v.to(dtype)
    before = pk.launch_counts()["tile_fused"]
    clusters = _fused_clusters(sort_expr(n), n, t)
    for fs in clusters[:4]:
        got = _fused(fs, t, x, bool(batch), plain=False)
        want = _fused(fs, t, x, bool(batch), plain=True)
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert pk.launch_counts()["tile_fused"] == before + min(4, len(clusters))


@pytest.mark.cuda
def test_cuda_fused_bfly_matches_plain(cuda_device):
    from repro_torch.combinators.fft import fft_expr
    n, t = 12, 5
    x = torch.randn(1 << n, 2, device=cuda_device)
    for fs in _fused_clusters(fft_expr(n), n, t):
        got = _fused(fs, t, x, False, plain=False)
        want = _fused(fs, t, x, False, plain=True)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_cuda_sort_and_fft_through_the_graph(cuda_device):
    """The combinator path on the card: the first call runs eagerly and
    captures a CUDA graph, later calls replay it; both agree with the
    library and with each other, and no result aliases another."""
    from repro_torch.combinators import fft as pfft
    from repro_torch.combinators import sort as psort
    from repro_torch.combinators import execute as ex
    from repro_torch import obs as pobs
    n = 16
    x = torch.randint(-1000, 1000, (1 << n,), device=cuda_device,
                      dtype=torch.int32)
    pk.reset_launch_counts()
    y1 = psort.sort(x)          # an eager run, then the capture
    eager_then_capture = pk.launch_counts()
    captured = ex._program_executable.cache_info().currsize
    y2 = psort.sort(x)
    x2 = x.flip(0).contiguous()
    y3 = psort.sort(x2)
    want = torch.sort(x).values
    assert torch.equal(y1, want) and torch.equal(y2, want)
    assert torch.equal(y3, torch.sort(x2).values)
    assert torch.equal(y2, want)   # y3's replay did not overwrite y2
    assert ex._program_executable.cache_info().currsize == captured
    pk.reset_launch_counts()
    assert torch.equal(psort.compiled_sort(n).call_per_stage(x), want)
    # the kernels recorded into the graph are not counted as launched
    assert pk.launch_counts() == eager_then_capture
    assert torch.equal(psort.sort(x.cpu().numpy()).cpu(), want.cpu())
    ref = psort.compiled_sort(n, engine="ref")
    assert torch.equal(ref(x), want) and torch.equal(ref(x), want)
    z = torch.complex(torch.randn(1 << n, device=cuda_device),
                      torch.randn(1 << n, device=cuda_device))
    want = torch.fft.fft(z.to(torch.complex128))
    # complex64 takes the kernels: its butterfly clusters run K4b on the
    # planar view, its permutations move 8-byte words
    pk.reset_launch_counts()
    pobs.reset()
    pobs.enable()
    try:
        pfft.fft(z)
        fallbacks = pobs.counter_total("dispatch.fused_fallback")
        gathers = pobs.counter_value("dispatch.kernel", kernel="ref")
    finally:
        pobs.disable()
        pobs.reset()
    assert fallbacks == 0 and gathers == 0
    assert pk.launch_counts()["tile_fused"] > 0
    assert torch.equal(pfft.fft(z), pfft.from_planar(
        pfft.fft_planar(pfft.to_planar(z))))
    for _ in range(2):
        for got in (pfft.from_planar(pfft.fft_planar(pfft.to_planar(z))),
                    pfft.fft(z)):
            err = (torch.linalg.vector_norm(got.to(torch.complex128) - want)
                   / torch.linalg.vector_norm(want))
            assert float(err) < 1e-5


def _bwd(fs, t, x, ct, batched, plain):
    """One cluster's backward through K5 (its tables on the card, as the
    executor keeps them) or through K5's plain version."""
    from repro_torch.combinators import execute as ex
    plans, entries, inv, _ = ex._fused_bwd_kernel_plan(fs, t)
    if not plain:
        return ex._fused_bwd_cuda(fs, t, batched, x, ct)
    plan = plans[0]
    sig, scal, vmem, fns = ex._fused_kernel_args(entries, x.dtype)
    return pk.tiled_permute_bwd_tables_plain(
        x, ct, plan.in_rows, plan.out_rows, plan.xor_low, inv,
        geometry=pk.plan_geometry(plan), epilogue=sig, epi_scalar=scal,
        epi_vmem=vmem, map_fns=fns, batched=batched)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tail,batch", [
    (torch.float32, (), None), (torch.bfloat16, (), None),
    (torch.float32, (3,), None), (torch.float32, (), 3)])
def test_cuda_k5_cmp_matches_plain(cuda_device, dtype, tail, batch):
    """K5 on compare clusters bit for bit against its plain version, on
    inputs with ties, NaNs and signed zeros."""
    from repro_torch.combinators.sort import sort_expr
    n = 12
    d = tail[0] if tail else 1
    t = pops.choose_tile(n, torch.tensor([], dtype=dtype).element_size(), d)
    shape = ((batch,) if batch else ()) + (1 << n,) + tail
    v = torch.randint(-4, 5, shape, device=cuda_device).to(torch.float32)
    u = torch.rand(shape, device=cuda_device)
    v = torch.where(u < 0.05, torch.full_like(v, float("nan")), v)
    v = torch.where((u > 0.5) & (v == 0), torch.full_like(v, -0.0), v)
    x = v.to(dtype)
    ct = torch.randn(shape, device=cuda_device).to(dtype)
    clusters = _fused_clusters(sort_expr(n), n, t)
    picked = clusters[:2] + [max(clusters, key=lambda s: len(s.computes))]
    before = pk.launch_counts()["tile_bwd"]
    for fs in picked:
        got = _bwd(fs, t, x, ct, bool(batch), plain=False)
        want = _bwd(fs, t, x, ct, bool(batch), plain=True)
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert pk.launch_counts()["tile_bwd"] == before + len(picked)


@pytest.mark.cuda
def test_cuda_k5_bfly_matches_plain(cuda_device):
    from repro_torch.combinators.fft import fft_expr
    n, t = 12, 5
    x = torch.randn(1 << n, 2, device=cuda_device)
    ct = torch.randn(1 << n, 2, device=cuda_device)
    for fs in _fused_clusters(fft_expr(n), n, t):
        got = _bwd(fs, t, x, ct, False, plain=False)
        want = _bwd(fs, t, x, ct, False, plain=True)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _hand_cmp(n, t, n_epi, seed):
    """A compare cluster built by hand on the bit reversal's tile plan at
    2^n, tile t: partner XORs on every tile position bit, then random
    XORs of several bits; random linear hi tables. (plan, signature,
    per-tile tables, row and lane tables.)"""
    import numpy as np
    from repro_torch.core.tiling import _affine_table, plan_bmmc
    rng = np.random.default_rng(seed)
    plan = plan_bmmc(Bmmc.bit_reverse(n), t)[0]
    rpt, n_tiles = plan.rows_per_tile, plan.n_tiles
    rb, gb = rpt.bit_length() - 1, n_tiles.bit_length() - 1

    def table(bits, const=False):
        imgs = [int(v) for v in rng.integers(0, 2, bits)]
        c = int(rng.integers(0, 2)) if const else 0
        return _affine_table(imgs, c).astype(np.int32)
    vs = [1 << b for b in range(t + rb)]
    while len(vs) < n_epi:
        vs.append(int(rng.integers(3, rpt << t)))
    sig = tuple(("cmp", v >> t, v & ((1 << t) - 1)) for v in vs[:n_epi])
    return (plan, sig, tuple((table(gb, True),) for _ in sig),
            tuple((table(rb), table(t)) for _ in sig))


def _ties(shape, dtype, device, seed):
    """Small integers (ties), NaNs and signed zeros, as ``dtype``."""
    g = torch.Generator(device=device).manual_seed(seed)
    v = torch.randint(-4, 5, shape, generator=g, device=device).float()
    u = torch.rand(shape, generator=g, device=device)
    v = torch.where(u < 0.05, torch.full_like(v, float("nan")), v)
    v = torch.where((u > 0.5) & (v == 0), torch.full_like(v, -0.0), v)
    return v.to(dtype)


def _offset(x, off):
    """``x``'s values in a contiguous view ``off`` elements into a larger
    buffer (a pointer off 16-byte alignment: K4b's and K5's word path)."""
    if not off:
        return x
    buf = torch.empty(x.numel() + off, dtype=x.dtype, device=x.device)
    view = buf[off:].view(x.shape)
    view.copy_(x)
    return view


# (label, cluster, log2 n, t, dtype, batch, element offset); cluster
# "sort" is the 2^n sort's largest (one 4096-position work item a batch
# row, so batch 3 makes three items: a block of two spanning batch rows,
# then a last block of one)
_EDGE_CASES = [
    ("items across batch rows, a last block of one", "sort", 12, 6,
     torch.float32, 3, 0),
    ("float32 4 bytes off (word path)", "sort", 12, 6, torch.float32, 3, 1),
    ("bfloat16 2 bytes off (word path)", "sort", 12, 6, torch.bfloat16, 1,
     1),
    ("bfloat16 at 16 registers", "sort", 12, 6, torch.bfloat16, 3, 0),
    ("int32 at 16 registers", "sort", 12, 6, torch.int32, 3, 0),
    ("planar butterflies", "fft", 12, 5, torch.float32, 3, 0),
    ("planar butterflies 4 bytes off", "fft", 12, 5, torch.float32, 1, 1),
    ("maps (tanh >> sort)", "tanh", 12, 6, torch.float32, 3, 0),
    ("maps, bfloat16 2 bytes off", "tanh", 12, 6, torch.bfloat16, 1, 1),
    ("20 compares (two compare groups)", "hand20", 12, 6, torch.float32, 3,
     0),
    ("2^14-position tiles (chunks)", "hand14", 14, 7, torch.float32, 1, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("label,kind,n,t,dtype,batch,off", _EDGE_CASES)
def test_cuda_k4b_k5_schedule_edges(cuda_device, label, kind, n, t, dtype,
                                    batch, off):
    """K4b and K5 on their work-item schedules, bit for bit against their
    plain versions at the schedule's edges: work items across batch rows
    and a last block with fewer of them, pointers off 16-byte alignment
    (the word path), bfloat16 at 16 registers, planar butterflies, maps,
    more than 16 compares, and tiles run in chunks."""
    import numpy as np
    from repro_torch.combinators import execute as ex
    from repro_torch.combinators import vocab as V
    from repro_torch.combinators.fft import fft_expr
    from repro_torch.combinators.sort import sort_expr
    d = 2 if kind == "fft" else 1
    shape = (batch, 1 << n) + ((d,) if d > 1 else ())
    if kind == "fft":
        x = torch.randn(shape, device=cuda_device)
    elif kind == "tanh":
        x = (torch.rand(shape, device=cuda_device) - 0.5).to(dtype) * 4
    else:
        x = _ties(shape, dtype, cuda_device, n + t)
    ct = torch.randn(shape, device=cuda_device).to(x.dtype)
    x, ct = _offset(x, off), _offset(ct, off)
    if kind.startswith("hand"):
        plan, sig, scal, vmem = _hand_cmp(n, t, 20 if kind == "hand20"
                                          else 14, seed=n + t)
        s0 = plan.src0.reshape(-1)
        inv = np.empty_like(s0)
        inv[s0] = np.arange(s0.size, dtype=s0.dtype)
        kw = dict(geometry=pk.plan_geometry(plan), epilogue=sig,
                  epi_scalar=scal, epi_vmem=vmem, batched=True)
        tabs = (plan.in_rows, plan.out_rows, plan.xor_low)
        fwd = (lambda: pk.tiled_permute_tables(x, *tabs, plan.src0, **kw),
               lambda: pk.tiled_permute_tables_plain(x, *tabs, plan.src0,
                                                     **kw))
        bwd = (lambda: pk.tiled_permute_bwd_tables(
            x, ct, *tabs, inv.reshape(plan.src0.shape), **kw),
            lambda: pk.tiled_permute_bwd_tables_plain(
                x, ct, *tabs, inv.reshape(plan.src0.shape), **kw))
        entries = pk._epi_entries(sig, scal, vmem)
        geometry = kw["geometry"]
    else:
        expr = {"sort": sort_expr(n), "fft": fft_expr(n),
                "tanh": V.emap("tanh", torch.tanh) >> sort_expr(n)}[kind]
        clusters = _fused_clusters(expr, n, t)
        fs = (clusters[0] if kind == "tanh" else
              max(clusters, key=lambda c: len(c.computes)))
        fwd = (lambda: _fused(fs, t, x, True, plain=False),
               lambda: _fused(fs, t, x, True, plain=True))
        bwd = (lambda: _bwd(fs, t, x, ct, True, plain=False),
               lambda: _bwd(fs, t, x, ct, True, plain=True))
        plans, ents = ex._fused_plan_cached(fs, t)
        sig, scal, vmem, fns = ex._fused_kernel_args(ents, x.dtype)
        entries = pk._epi_entries(sig, scal, vmem, fns, x.dtype)
        geometry = pk.plan_geometry(plans[0])
    xc = x.reshape(batch, 1 << n, d)
    for n_buf, (kern, plain) in ((1, fwd), (2, bwd)):
        if n_buf == 2 and dtype == torch.int32:
            continue
        _, s, plan_t, _ = pk._epi_launch_args(xc, geometry, entries,
                                              n_buf=n_buf)
        assert s.vec == int(not off), (label, s)
        if kind == "sort" and batch == 3:
            assert s.groups == 2 and s.n_work == 3 and s.grid == 2
        if label == "bfloat16 at 16 registers" and n_buf == 1:
            assert plan_t.info["reg_bits"] == 4
        if kind == "hand14":
            assert plan_t.info["outer_bits"] >= 1
        name = "tile_bwd" if n_buf == 2 else "tile_fused"
        before = pk.launch_counts()[name]
        got, want = kern(), plain()
        torch.cuda.synchronize()
        assert pk.launch_counts()[name] == before + 1, label
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8)), (
            label, name)


@pytest.mark.cuda
def test_cuda_sort_and_fft_gradients(cuda_device):
    """Gradients on the card: the sort's equals the scatter of w to the
    sorting permutation bit for bit, the gradient kernel route equals the
    collapsed route bit for bit on ties, and the FFT's is within 1e-5 of
    float64 ``torch.fft.fft`` under autograd. Each cold backward counts
    the modeled round trips, and K5 runs once per compute cluster."""
    from repro_torch import obs as pobs
    from repro_torch.combinators import execute as ex
    from repro_torch.combinators import fft as pfft
    from repro_torch.combinators import sort as psort
    n = 14
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randperm(1 << n, generator=gen, device=cuda_device).float()
    w = torch.randn(1 << n, generator=gen, device=cuda_device)
    f = psort.compiled_sort(n)
    t = pops.choose_tile(n, 4)
    ex.clear_caches()
    pk.reset_launch_counts()
    pobs.reset()
    pobs.enable()
    try:
        xt = x.clone().requires_grad_(True)
        (w * f(xt)).sum().backward()
        rt = pobs.counter_total("model.vjp_round_trips")
        fb = pobs.counter_total("dispatch.fused_fallback")
    finally:
        pobs.disable()
        pobs.reset()
    idx = torch.sort(x).indices
    assert torch.equal(xt.grad, torch.zeros_like(w).scatter_(0, idx, w))
    prog = f.clustered_program(n, t)
    clusters = sum(isinstance(s, ex.FusedStage) and bool(s.computes)
                   for s in prog)
    assert rt == f.vjp_round_trips(n, t) == f.cost(n, t, clustered=True)[
        "round_trips"]
    assert fb == 0 and pk.launch_counts()["tile_bwd"] == clusters

    ties = torch.randint(0, 8, (1 << n,), generator=gen,
                         device=cuda_device).float()
    grads = []
    for mega in (True, False):
        ex.BWD_MEGAKERNEL = mega
        try:
            xt = ties.clone().requires_grad_(True)
            (w * f(xt)).sum().backward()
            grads.append(xt.grad)
        finally:
            ex.BWD_MEGAKERNEL = True
    assert torch.equal(grads[0].view(torch.int32), grads[1].view(torch.int32))

    m = 12
    xr = torch.randn(1 << m, 2, generator=gen, device=cuda_device)
    wr = torch.randn(1 << m, 2, generator=gen, device=cuda_device)
    xt = xr.clone().requires_grad_(True)
    (wr * pfft.fft_planar(xt)).sum().backward()
    x64 = xr.double().requires_grad_(True)
    (wr.double() * torch.view_as_real(torch.fft.fft(
        torch.view_as_complex(x64)))).sum().backward()
    err = (torch.linalg.vector_norm(xt.grad.double() - x64.grad)
           / torch.linalg.vector_norm(x64.grad))
    assert float(err) < 1e-5


def _map_expr(n, name, fn):
    """perm, compare, map, perm, compare, map, perm: a map between two
    compares and one at the end of a cluster."""
    from repro_torch.combinators import vocab as V
    rng = random.Random(8)
    return V.seq(V.perm(Bmmc.random_bpc(n, rng)), V.cmp_halves(),
                 V.emap(name, fn), V.perm(Bmmc.random_bpc(n, rng)),
                 V.cmp_halves(), V.emap(name, fn), V.perm(Bmmc.random(n, rng)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,name,fn,tail,batch", [
    (torch.int32, "wrap", lambda v: v * 1000003 + 7, (), None),
    (torch.int32, "not", torch.bitwise_not, (), 3),
    (torch.float32, "v/v", lambda v: v / v, (), None),
    (torch.float32, "silu", lambda v: v * torch.sigmoid(v), (3,), None),
    (torch.float32, "tanh", torch.tanh, (), None),
    (torch.bfloat16, "affine3", lambda v: (v * 3 + 1) * 0.5, (), None),
    (torch.bfloat16, "tanh", torch.tanh, (), None),
    (torch.bfloat16, "exp", torch.exp, (), 3),
    (torch.bfloat16, "sigmoid", torch.sigmoid, (), None),
    (torch.bfloat16, "div7", lambda v: v / 7, (3,), None)])
def test_cuda_map_epilogues_match_plain(cuda_device, dtype, name, fn, tail,
                                        batch):
    """K4b and K5 with map epilogues bit for bit against their plain
    versions on continuous inputs (maps that make NaNs mid-phase
    included; K5's tanh and sigmoid derivatives round as PyTorch's CUDA
    kernels do), each cluster a launch of the map variant."""
    n = 12
    d = tail[0] if tail else 1
    t = pops.choose_tile(n, torch.tensor([], dtype=dtype).element_size(), d)
    shape = ((batch,) if batch else ()) + (1 << n,) + tail
    if dtype == torch.int32:
        v = torch.randint(-4, 5, shape, device=cuda_device)
        x = (v * 65537 + 3).to(torch.int32)
    else:   # continuous values in [-4, 4), with zeros planted (v / v)
        u = torch.rand(shape, device=cuda_device)
        x = torch.where(u < 0.05, torch.zeros_like(u),
                        (torch.rand(shape, device=cuda_device) - 0.5) * 8)
        x = x.to(dtype)
    ct = torch.randn(shape, device=cuda_device).to(
        torch.float32 if dtype == torch.int32 else dtype)
    clusters = [fs for fs in _fused_clusters(_map_expr(n, name, fn), n, t)
                if any(type(c).__name__ == "Map" for c, _ in fs.computes)]
    assert clusters
    before = pk.launch_counts()
    for fs in clusters:
        got = _fused(fs, t, x, bool(batch), plain=False)
        want = _fused(fs, t, x, bool(batch), plain=True)
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
        if dtype != torch.int32:
            got = _bwd(fs, t, x, ct, bool(batch), plain=False)
            want = _bwd(fs, t, x, ct, bool(batch), plain=True)
            assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    after = pk.launch_counts()
    assert after["tile_fused"] == before["tile_fused"] + len(clusters)
    assert after["tile_bwd"] == before["tile_bwd"] + (
        0 if dtype == torch.int32 else len(clusters))


_DAG_MAPS = [   # dtype, name, function: DAG tapes and the ops past a chain
    (torch.float32, "leaky", lambda v: torch.where(v > 0, v, 0.01 * v)),
    (torch.float32, "gelu_dag", lambda v: 0.5 * v * (1 + torch.tanh(
        0.7978845608028654 * (v + 0.044715 * v * v * v)))),
    (torch.float32, "band", lambda v: torch.where(
        torch.logical_and(v > -1, v < 1), torch.maximum(v * 2, -v), v)),
    (torch.float32, "pow_rem", lambda v: v ** 2 % 0.75 + torch.floor(v)),
    (torch.float32, "hardtanh", lambda v: torch.nn.functional.hardtanh(
        v, -0.5, 0.5) + torch.sign(v)),
    (torch.bfloat16, "leaky", lambda v: torch.where(v > 0, v, 0.01 * v)),
    (torch.bfloat16, "round_min", lambda v: torch.minimum(
        torch.round(v * 2), v ** -1)),
    (torch.float16, "trunc_div", lambda v: torch.div(
        v, 0.75, rounding_mode="trunc") + torch.fmod(v, 0.75)),
    (torch.float64, "fan_out", lambda v: v * v + torch.exp(v) * v
     - torch.sin(v)),
    (torch.int32, "int_ops", lambda v: torch.where(
        v % -7 > 2, v // 3, torch.maximum(v ** 2, -v))),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,name,fn", _DAG_MAPS,
                         ids=[f"{str(d)[6:]}-{m}" for d, m, _ in _DAG_MAPS])
def test_cuda_dag_maps_match_plain(cuda_device, dtype, name, fn):
    """DAG tapes, comparisons, ``where`` and the new exact ops in K4b and
    K5, bit for bit against their plain versions (eager torch and autograd
    on the card), each cluster a launch of the map variant."""
    n = 12
    t = pops.choose_tile(n, torch.tensor([], dtype=dtype).element_size())
    gen = torch.Generator(device=cuda_device).manual_seed(29)
    if dtype == torch.int32:
        x = torch.randint(-1000, 1001, (1 << n,), generator=gen,
                          device=cuda_device, dtype=torch.int32)
    else:   # half continuous, half multiples of 1/4 in [-4, 4)
        cont = (torch.rand(1 << n, generator=gen, device=cuda_device) - 0.5) * 8
        grid = torch.randint(-16, 16, (1 << n,), generator=gen,
                             device=cuda_device).float() / 4
        x = torch.where(torch.rand(1 << n, generator=gen,
                                   device=cuda_device) < 0.5, cont,
                        grid).to(dtype)
    ct = torch.randn(1 << n, generator=gen, device=cuda_device).to(
        torch.float32 if dtype == torch.int32 else dtype)
    clusters = [fs for fs in _fused_clusters(_map_expr(n, "dag_" + name, fn),
                                             n, t)
                if any(type(c).__name__ == "Map" for c, _ in fs.computes)]
    assert clusters
    before = pk.launch_counts()
    for fs in clusters:
        got = _fused(fs, t, x, False, plain=False)
        want = _fused(fs, t, x, False, plain=True)
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
        if dtype != torch.int32:
            got = _bwd(fs, t, x, ct, False, plain=False)
            want = _bwd(fs, t, x, ct, False, plain=True)
            assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    after = pk.launch_counts()
    assert after["tile_fused"] == before["tile_fused"] + len(clusters)
    assert after["tile_bwd"] == before["tile_bwd"] + (
        0 if dtype == torch.int32 else len(clusters))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_twelve_maps_in_one_k5_launch(cuda_device, dtype):
    """A sort with a map after each of its last 12 compares: its gradient
    runs with no fused fallback, each map cluster one K5 launch (the
    inputs of the maps that do not fit K5's shared memory recomputed),
    bit-equal to the collapsed route."""
    from repro_torch import obs as pobs
    from repro_torch.combinators import compile_expr
    from repro_torch.combinators import execute as ex
    from repro_torch.combinators import vocab as V
    from repro_torch.combinators.sort import compiled_sort
    n = 16
    maps = [lambda v: torch.where(v > 0, v, v * 0.25),
            lambda v: torch.tanh(v) * v * 0.5,
            lambda v: v * 0.5 + torch.tanh(v)]
    stages = list(compiled_sort(n).program(n))
    at = [i for i, s in enumerate(stages) if type(s).__name__ == "CmpHalves"]
    for j, i in enumerate(reversed(at[-12:])):
        stages.insert(i + 1, V.emap(f"twelve{j}", maps[j % 3]))
    f = compile_expr(V.seq(*stages))
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    x = torch.randn(1 << n, generator=gen, device=cuda_device).to(dtype)
    w = torch.randn(1 << n, generator=gen, device=cuda_device).to(dtype)

    def grad():
        v = x.clone().requires_grad_(True)
        (w * f(v)).sum().backward()
        return v.grad
    pobs.reset()
    pobs.enable()
    try:
        got = grad()
        fb = pobs.counter_total("dispatch.fused_fallback")
    finally:
        pobs.disable()
        pobs.reset()
    assert fb == 0
    ex.BWD_MEGAKERNEL = False
    try:
        want = grad()
    finally:
        ex.BWD_MEGAKERNEL = True
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.cuda
def test_cuda_map_programs_fuse_in_both_directions(cuda_device):
    """``not >> sort >> not`` sorts in descending order and ``tanh >>
    sort`` differentiates, each with its maps inside K4b / K5: no fused
    fallback, counted round trips equal to the model in each
    direction."""
    from repro_torch import obs as pobs
    from repro_torch.combinators import compile_expr
    from repro_torch.combinators import execute as ex
    from repro_torch.combinators import vocab as V
    from repro_torch.combinators.sort import sort_expr
    n = 14
    t = pops.choose_tile(n, 4)
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    x = torch.randint(-2**31, 2**31 - 1, (1 << n,), generator=gen,
                      device=cuda_device, dtype=torch.int64).to(torch.int32)
    f = compile_expr(V.emap("not", torch.bitwise_not) >> sort_expr(n)
                     >> V.emap("not", torch.bitwise_not))
    g = compile_expr(V.emap("tanh", torch.tanh) >> sort_expr(n))
    xf = (torch.randperm(1 << n, generator=gen, device=cuda_device).float()
          - (1 << (n - 1))) / (1 << n)
    w = torch.randn(1 << n, generator=gen, device=cuda_device)
    ex.clear_caches()
    pk.reset_launch_counts()
    pobs.reset()
    pobs.enable()
    try:
        y = f(x)
        rt_sort = pobs.counter_total("model.round_trips")
        pobs.reset()
        xt = xf.clone().requires_grad_(True)
        out = g(xt)
        rt_fwd = pobs.counter_total("model.round_trips")
        (w * out).sum().backward()
        rt_bwd = pobs.counter_total("model.vjp_round_trips")
        fb = pobs.counter_total("dispatch.fused_fallback")
    finally:
        pobs.disable()
        pobs.reset()
    assert torch.equal(y, torch.sort(x, descending=True).values)
    assert rt_sort == f.cost(n, t, clustered=True)["round_trips"]
    assert rt_fwd == rt_bwd == g.vjp_round_trips(n, t) == g.cost(
        n, t, clustered=True)["round_trips"]
    assert fb == 0
    counts = pk.launch_counts()
    assert counts["tile_fused"] > 0 and counts["tile_bwd"] > 0
    xl = xf.clone().requires_grad_(True)
    (w * torch.sort(torch.tanh(xl)).values).sum().backward()
    assert torch.allclose(xt.grad, xl.grad, rtol=1e-5, atol=1e-6)


_TYPED = _TM.cases()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,name,fn", _TYPED,
                         ids=[_TM.case_id(c) for c in _TYPED])
def test_cuda_typed_maps_match_eager(cuda_device, dtype, name, fn):
    """Casts inside a map (typed tapes) and the ops past the DAG tapes'
    list in K4b and K5, bit for bit against their plain versions, which
    call the map's function eagerly on the card and differentiate it with
    autograd; each cluster one launch of the map variant, and the map
    lowered (no fallback hides it)."""
    from repro_torch.kernels import map_lower as ML
    n = 12
    assert ML.lower_map("typed_" + name, fn, dtype).lowered
    t = pops.choose_tile(n, torch.tensor([], dtype=dtype).element_size())
    gen = torch.Generator(device=cuda_device).manual_seed(30)
    if dtype.is_floating_point:   # half continuous, half multiples of 1/4
        cont = (torch.rand(1 << n, generator=gen, device=cuda_device) - 0.5) * 8
        grid = torch.randint(-16, 16, (1 << n,), generator=gen,
                             device=cuda_device).float() / 4
        x = torch.where(torch.rand(1 << n, generator=gen,
                                   device=cuda_device) < 0.5, cont,
                        grid).to(dtype)
    else:
        x = torch.randint(-100, 100, (1 << n,), generator=gen,
                          device=cuda_device).to(dtype)
    ct = torch.randn(1 << n, generator=gen, device=cuda_device).to(
        dtype if dtype.is_floating_point else torch.float32)
    clusters = [fs for fs in _fused_clusters(_map_expr(n, "typed_" + name,
                                                       fn), n, t)
                if any(type(c).__name__ == "Map" for c, _ in fs.computes)]
    assert clusters
    before = pk.launch_counts()
    for fs in clusters:
        got = _fused(fs, t, x, False, plain=False)
        want = _fused(fs, t, x, False, plain=True)
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
        if dtype.is_floating_point:
            got = _bwd(fs, t, x, ct, False, plain=False)
            want = _bwd(fs, t, x, ct, False, plain=True)
            assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    after = pk.launch_counts()
    assert after["tile_fused"] == before["tile_fused"] + len(clusters)
    assert after["tile_bwd"] == before["tile_bwd"] + (
        len(clusters) if dtype.is_floating_point else 0)


@pytest.mark.cuda
def test_cuda_cast_tanh_sort_fuses_in_both_directions(cuda_device):
    """``emap(torch.tanh(v.float()).to(v.dtype)) >> sort`` on bfloat16 and
    its gradient: no fused fallback, the maps inside K4b and K5, equal to
    the library composite (sort of the eager map) and to autograd
    through it."""
    from repro_torch import obs as pobs
    from repro_torch.combinators import compile_expr
    from repro_torch.combinators import vocab as V
    from repro_torch.combinators.sort import sort_expr
    n = 16
    g = compile_expr(V.emap("cast_tanh", lambda v: torch.tanh(v.float()).to(
        v.dtype)) >> sort_expr(n))
    gen = torch.Generator(device=cuda_device).manual_seed(31)
    x = torch.randn(1 << n, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    w = torch.randn(1 << n, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    pk.reset_launch_counts()
    pobs.reset()
    pobs.enable()
    try:
        xt = x.clone().requires_grad_(True)
        out = g(xt)
        (w * out).sum().backward()
        fb = pobs.counter_total("dispatch.fused_fallback")
    finally:
        pobs.disable()
        pobs.reset()
    assert fb == 0
    counts = pk.launch_counts()
    assert counts["tile_fused"] > 0 and counts["tile_bwd"] > 0
    xl = x.clone().requires_grad_(True)
    want = torch.sort(torch.tanh(xl.float()).to(xl.dtype)).values
    assert torch.equal(out.detach().view(torch.int16), want.detach().view(
        torch.int16))
    # the gradient against autograd through torch.sort, on 2^12 keys
    # whose mapped values are distinct (no ties for the sorts to order
    # differently)
    nd = 12
    cand = torch.arange(-(1 << 15), 1 << 15, device=cuda_device,
                        dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    cand = cand[(cand.float().abs() > 1e-6) & (cand.float().abs() < 3)]
    _, inv, cnt = torch.unique(torch.tanh(cand.float()).to(
        torch.bfloat16).float(), return_inverse=True, return_counts=True)
    cand = cand[cnt[inv] == 1]
    xd = cand[torch.randperm(cand.numel(), generator=gen,
                             device=cuda_device)[:1 << nd]]
    wd = torch.randn(1 << nd, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    gd = compile_expr(V.emap("cast_tanh", lambda v: torch.tanh(
        v.float()).to(v.dtype)) >> sort_expr(nd))
    pk.reset_launch_counts()
    xt = xd.clone().requires_grad_(True)
    (wd * gd(xt)).sum().backward()
    assert pk.launch_counts()["tile_bwd"] > 0
    xl = xd.clone().requires_grad_(True)
    (wd * torch.sort(torch.tanh(xl.float()).to(xl.dtype)).values).sum(
        ).backward()
    assert torch.equal(xt.grad.view(torch.int16), xl.grad.view(torch.int16))


_PLANAR_TYPED = [c for c in _TM.CASTS if c[0] in (
    "cast_tanh", "cast_affine", "cast_int_floor", "cast_half", "cast_bool")]


@pytest.mark.cuda
@pytest.mark.parametrize("name,fn", [c[:2] for c in _PLANAR_TYPED],
                         ids=[c[0] for c in _PLANAR_TYPED])
@pytest.mark.parametrize("dtype", _TM.FLOATS, ids=str)
def test_cuda_typed_maps_beside_butterflies(cuda_device, dtype, name, fn):
    """``emap(m) >> fft`` on planar input: the map cluster's K4b and K5
    (the planar ext map kernels for a typed tape) bit for bit against
    their plain versions; the whole program with no fused fallback in
    either direction, the counted K5 passes equal to the model for this
    element type, bit-equal to the same program stage by stage on the
    ``ref`` engine (eager torch) and its gradient to autograd through
    it."""
    from repro_torch import obs as pobs
    from repro_torch.combinators import compile_expr
    from repro_torch.combinators import fft as F
    from repro_torch.combinators import vocab as V
    from repro_torch.kernels import map_lower as ML
    n = 12
    tape = ML.lower_map("planar_" + name, fn, dtype)
    assert tape.lowered
    expr = V.seq(V.emap("planar_" + name, fn), F.fft_expr(n))
    gen = torch.Generator(device=cuda_device).manual_seed(31)
    x, w, ct = (torch.randn(1 << n, 2, generator=gen, device=cuda_device,
                            dtype=torch.float64).to(dtype) for _ in range(3))
    t = pops.choose_tile(n, x.element_size(), 2)
    clusters = [fs for fs in _fused_clusters(expr, n, t)
                if {"Map", "Bfly"} <= {type(c).__name__
                                       for c, _ in fs.computes}]
    assert len(clusters) == 1
    fs = clusters[0]
    before = pk.launch_counts()
    got = _fused(fs, t, x, False, plain=False)
    want = _fused(fs, t, x, False, plain=True)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    got = _bwd(fs, t, x, ct, False, plain=False)
    want = _bwd(fs, t, x, ct, False, plain=True)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    after = pk.launch_counts()
    for k in ("tile_fused", "tile_bwd"):
        assert after[k] == before[k] + 1
        assert after[f"{k}_ext"] == before[f"{k}_ext"] + int(tape.typed)
    f = compile_expr(expr)
    pobs.reset()
    pobs.enable()
    try:
        xt = x.clone().requires_grad_(True)
        y = f(xt)
        fb = pobs.counter_total("dispatch.fused_fallback")
        (w * y).sum().backward()
        fbg = pobs.counter_total("dispatch.fused_fallback") - fb
        rt = pobs.counter_total("model.vjp_round_trips")
    finally:
        pobs.disable()
        pobs.reset()
    assert fb == fbg == 0
    assert rt == f.vjp_round_trips(n, t, dtype) is not None
    xr = x.clone().requires_grad_(True)
    yr = compile_expr(expr, engine="ref")(xr)
    (w * yr).sum().backward()
    assert torch.equal(y.detach().view(torch.uint8),
                       yr.detach().view(torch.uint8))
    assert torch.equal(xt.grad.view(torch.uint8), xr.grad.view(torch.uint8))


# ---------------------------------------------------------------------------
# ring 2: the guarded variants of K2, K3, K4a and K4b
# ---------------------------------------------------------------------------

def _guarded_pair(kind, x, payload, flags, tabs=None):
    """(guarded kernel, guarded plain version) of one kernel on ``x``,
    with its plan's device tables or ``tabs``."""
    if kind == "block":
        tab = pk.device_tables(payload, x.device)[0] if tabs is None else tabs
        geo = pk.block_geometry(payload)
        got = pk.block_permute_tables(x, tab, geometry=geo, flags=flags)
        fp = torch.zeros_like(flags)
        return got, pk.block_permute_plain(x, payload, src_rows=tab,
                                           flags=fp), fp
    if kind == "lane":
        tab = pk.device_tables(payload, x.device)[0] if tabs is None else tabs
        geo = pk.lane_geometry(payload)
        got = pk.lane_permute_tables(x, tab, geometry=geo, flags=flags)
        fp = torch.zeros_like(flags)
        return got, pk.lane_permute_plain(x, payload, src_lane=tab,
                                          flags=fp), fp
    tabs = pk.device_tables(payload, x.device) if tabs is None else tabs
    got = pk.tiled_permute_tables(x, *tabs, geometry=pk.plan_geometry(
        payload), flags=flags)
    fp = torch.zeros_like(flags)
    return got, pk.tiled_permute_plain(x, payload, tables=tabs,
                                       flags=fp), fp


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["block", "lane", "bitrev", "bmmc"])
def test_cuda_guarded_kernels_match_unguarded_and_plain(cuda_device, kind):
    n = 14
    b = _bmmc(kind, n, random.Random(3))
    kernel, payload = pops.class_plan(b, 4)
    plan = payload if kernel in ("block", "lane") else payload[0]
    name = {"block": "block", "lane": "lane"}.get(kernel, "tile")
    x = torch.randint(-2**31, 2**31 - 1, (1 << n,), device=cuda_device,
                      dtype=torch.int64).to(torch.int32)
    flags = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    before = pk.launch_counts()
    got, plain, pflags = _guarded_pair(kernel, x, plan, flags)
    torch.cuda.synchronize()
    after = pk.launch_counts()
    assert after[name + "_guarded"] == before[name + "_guarded"] + 1
    assert after[name] == before[name]
    unguarded = {"block": pk.block_permute, "lane": pk.lane_permute}.get(
        kernel, pk.tiled_permute)(x, plan)
    assert int(flags) == 0 and int(pflags) == 0
    assert torch.equal(got, plain) and torch.equal(got, unguarded)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,table", [
    ("block", 0), ("lane", 0), ("bitrev", 0), ("bitrev", 1),
    ("bitrev", 2), ("bitrev", 3)])
def test_cuda_poisoned_table_traps_without_a_sticky_error(cuda_device, kind,
                                                          table):
    """An entry out of range in the table a guarded kernel reads sets bit 1
    (as its guarded plain version does) and the access is skipped: the
    next unguarded launch in the process still succeeds."""
    n = 14
    b = _bmmc(kind, n, random.Random(3))
    kernel, payload = pops.class_plan(b, 4)
    plan = payload if kernel in ("block", "lane") else payload[0]
    tabs = tuple(t.clone() for t in pk.device_tables(plan, cuda_device))
    tabs[table].view(-1)[1] = 1 << 30
    x = torch.randint(0, 1 << 30, (1 << n,), device=cuda_device,
                      dtype=torch.int32)
    flags = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    got, plain, pflags = _guarded_pair(
        kernel, x, plan, flags, tabs if kernel not in ("block", "lane")
        else tabs[0])
    torch.cuda.synchronize()
    assert int(flags) == 1 and int(pflags) == 1
    if not (kernel not in ("block", "lane") and table == 1):
        # a bad output row leaves its row unwritten; else all is defined
        assert torch.equal(got, plain)
    y = pops.bmmc_permute(x, b)
    torch.cuda.synchronize()
    assert torch.equal(y, pref.bmmc_ref(x, b))


@pytest.mark.cuda
@pytest.mark.parametrize("table,value", [(None, 0)] + [
    (k, v) for k in range(4) for v in (-1, 1 << 30)])
@pytest.mark.parametrize("path", ["16-byte", "word"])
@pytest.mark.parametrize("cluster", ["sort int32", "sort float32",
                                     "sort bfloat16", "fft float32"])
def test_cuda_guarded_fused_kernel_matches_and_traps(cuda_device, cluster,
                                                     path, table, value):
    """The guarded K4b on the largest cluster of the 2^14 sort or FFT, on
    its 16-byte path and (data one element off 16-byte alignment) its word
    path: on clean tables bit-equal to the unguarded K4b and its guarded
    plain version with no flag; with entry 1 of in_rows, out_rows, xor_low
    or src0 set to -1 or 2^30 on the card, bit 1 set as the guarded plain
    version sets it and outputs bit-equal where defined (all but the row a
    bad output id names); the next unguarded launch succeeds."""
    from repro_torch.combinators import execute as pex
    from repro_torch.combinators import compile_expr
    from repro_torch.combinators.fft import fft_expr
    from repro_torch.combinators.sort import sort_expr
    name, dt = cluster.split()
    dtype = getattr(torch, dt)
    n = 14
    t = pops.choose_tile(n, 4)
    prog = compile_expr({"sort": sort_expr, "fft": fft_expr}[name](n)) \
        .clustered_program(n, t)
    fs = max((s for s in prog if getattr(s, "computes", ())),
             key=lambda s: len(s.computes))
    plans, entries = pex._fused_plan_cached(fs, t)
    d = 2 if name == "fft" else 1
    gen = torch.Generator(device=cuda_device).manual_seed(25)
    raw = torch.randint(-2**31, 2**31 - 1, ((1 << n) * d + 1,),
                        device=cuda_device, generator=gen,
                        dtype=torch.int64)
    buf = (raw.to(torch.int32) if dtype == torch.int32
           else (raw % 65536).to(dtype))
    x = buf[1:] if path == "word" else buf[:-1]
    if d == 2:
        x = x.view(1 << n, 2)
    tabs, epi = pex._pass_tables(plans[0], entries, x)
    geo = pk.plan_geometry(plans[0])
    flags = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    pflags = torch.zeros_like(flags)
    iv = torch.int16 if x.element_size() == 2 else torch.int32
    before = pk.launch_counts()["tile_fused_guarded"]
    want = pk.tiled_permute_tables(x, *tabs, geometry=geo, **epi)
    got = pk.tiled_permute_tables(x, *tabs, geometry=geo, flags=flags, **epi)
    plain = pk.tiled_permute_tables_plain(x, *tabs, geometry=geo,
                                          flags=pflags, **epi)
    torch.cuda.synchronize()
    assert pk.launch_counts()["tile_fused_guarded"] == before + 1
    assert int(flags) == 0 and int(pflags) == 0
    assert torch.equal(got.view(iv), want.view(iv))
    assert torch.equal(got.view(iv), plain.view(iv))
    if table is None:
        return
    bad = [a.clone() for a in tabs]
    bad[table].view(-1)[1] = value
    got = pk.tiled_permute_tables(x, *bad, geometry=geo, flags=flags, **epi)
    plain = pk.tiled_permute_tables_plain(x, *bad, geometry=geo,
                                          flags=pflags, **epi)
    torch.cuda.synchronize()
    assert int(flags) == 1 and int(pflags) == 1
    keep = torch.ones(1 << n, dtype=torch.bool, device=cuda_device)
    if table == 1:   # a bad output row id leaves that row unwritten
        r0 = int(tabs[1].view(-1)[1])
        keep[r0 << geo[1]:(r0 + 1) << geo[1]] = False
    assert torch.equal(got.view(iv)[keep], plain.view(iv)[keep])
    again = pk.tiled_permute_tables(x, *tabs, geometry=geo, **epi)
    torch.cuda.synchronize()
    assert torch.equal(again.view(iv), want.view(iv))


@pytest.mark.cuda
def test_cuda_guarded_entry_points_fall_back_and_recover(cuda_device):
    """Ring 2 through the entry points on the card: clean guarded calls
    are bit-equal with no trap; a poisoned plan traps on the card, falls
    back to ref and recovers; a poisoned ref table raises GuardTrap; the
    process keeps launching."""
    from repro_torch import guard, resilience
    from repro_torch.combinators import compile_expr, execute as pex
    from repro_torch.combinators.sort import sort_expr
    from repro_torch.guard import inject
    pex.clear_caches()
    n = 14
    b = Bmmc.bit_reverse(n)
    x = torch.randint(0, 1 << 30, (1 << n,), device=cuda_device,
                      dtype=torch.int32)
    s = compile_expr(sort_expr(n))
    want_sort = torch.sort(x).values
    try:
        with guard.guarded():
            assert torch.equal(pops.bmmc_permute(x, b), pref.bmmc_ref(x, b))
            for _ in range(2):        # eager first call, then the graph
                assert torch.equal(s(x), want_sort)
            assert guard.stats()["traps"] == {}
            assert not resilience.board().engaged("cuda")
            t = pops.choose_tile(n, 4)
            with inject.poison_plan(b, t):
                assert torch.equal(pops.bmmc_permute(x, b),
                                   pref.bmmc_ref(x, b))
            st = guard.stats()
            # a skipped access may also show in the parity sample
            assert st["traps"][("oob", "cuda")] == 1
            assert {k for k, _ in st["traps"]} <= {"oob", "parity"}
            assert st["fallbacks"] == {"ref": 1} and st["recovered"] == 1
            with inject.poison_ref_table(b):
                with pytest.raises((guard.GuardTrap, guard.CachePoisoned)):
                    pops.bmmc_permute(x, b, engine="ref")
        torch.cuda.synchronize()
        assert torch.equal(pops.bmmc_permute(x, b), pref.bmmc_ref(x, b))
        rep = inject.run_fault_matrix("cuda", n=10, device="cuda")
        assert rep["caught"] == rep["injected"] == len(inject.FAULT_KINDS)
    finally:
        pex.clear_caches()


# ---------------------------------------------------------------------------
# the serving path: the kv-head shuffle through K4a
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128),
                                     (torch.bfloat16, 512),
                                     (torch.float32, 512)])
def test_cuda_k4a_at_the_head_shuffle_shapes(cuda_device, dtype, d):
    """The shapes the 8-kv-head shuffle gives K4a in a prefill layer (k and
    v, the q groups, the float32 output): one tiled pass at t = 1 on K4a's
    wide schedule, bit for bit against its plain version and the plain
    gather, through ``bmmc_permute`` and through ``permute_axis``."""
    from repro_torch.models.attention import default_head_perm
    hp = default_head_perm(8)
    x = torch.randn((256, 8, d), device=cuda_device).to(dtype)
    t = pops.choose_tile(hp.n, x.element_size(), d)
    kernel, plans = pops.class_plan(hp, t)
    assert (t, kernel, len(plans)) == (1, "tiled", 1)
    before = pk.launch_counts()
    got = pops.bmmc_permute(x, hp, batched=True)
    after = pk.launch_counts()
    assert after["tile"] == before["tile"] + 1
    assert after["tile_wide"] == before["tile_wide"] + 1   # K4a's schedule
    want = pk.tiled_permute_plain(x, plans[0], batched=True)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert torch.equal(got.view(torch.uint8),
                       pref.bmmc_ref(x, hp, batched=True).view(torch.uint8))
    # what the prefill calls: the shuffle of axis 2 of (b, s, heads, d)
    from repro_torch.models.permute import permute_axis
    x4 = x.reshape(2, 128, 8, d)
    got4 = permute_axis(x4, hp, axis=2, engine="cuda")
    assert torch.equal(got4.reshape(got.shape).view(torch.uint8),
                       want.view(torch.uint8))
    assert pk.launch_counts()["tile"] == before["tile"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_small_model_serves_with_equal_engines(cuda_device, dtype):
    """A smoke-sized model with 8 kv heads served on the card: the shuffle
    on cuda (K4a, 4 launches a prefill layer), on ref and off give
    bit-equal prefill logits and equal greedy tokens."""
    import dataclasses
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.launch import serve as S
    from repro_torch.models import model as M
    base = dataclasses.replace(
        reduce_for_smoke(get_config("mistral-nemo-12b")), n_kv_heads=8,
        n_heads=8, dtype=dtype)
    params = M.init(base, torch.Generator(device=cuda_device).manual_seed(0))
    args = S.parse_args(["--batch", "2", "--prompt-len", "16",
                         "--tokens", "4"])
    prompts = S.make_prompts(base, args, cuda_device)
    got = {}
    for engine in ("cuda", "ref", None):
        pk.reset_launch_counts()
        got[engine] = S.serve(dataclasses.replace(base, head_shuffle=engine),
                              params, args, prompts)
        launches = pk.launch_counts()["tile"]
        assert launches == (4 * base.n_layers if engine == "cuda" else 0)
    for engine in ("ref", None):
        assert torch.equal(got[engine].prefill_logits,
                           got["cuda"].prefill_logits), engine
        assert (got[engine].gen == got["cuda"].gen).all(), engine


# ---------------------------------------------------------------------------
# K4a's two schedules and its launch record
# ---------------------------------------------------------------------------

def _k4a_forced(x, plan, batched, **over):
    """One K4a launch on the schedule ``k4a_schedule`` gives with ``over``
    (the wrapper's record path picks its own)."""
    import ctypes
    from repro_torch.kernels import build as pbuild
    xc = pk._canonical(x, batched)
    tabs = pk.device_tables(plan, x.device)
    geometry = pk.plan_geometry(plan)
    out = torch.empty_like(x)
    s = pk.k4a_schedule(geometry, xc.shape[0], xc.shape[2], x.element_size(),
                        x.data_ptr() | out.data_ptr() | tabs[3].data_ptr(),
                        **over)
    args = pk._k4a_args(s, tabs, geometry, xc.shape[0])
    rc = pbuild.load("tile")(x.data_ptr(), out.data_ptr(),
                             ctypes.addressof(args), pk._stream(x))
    assert rc == 0, (rc, s)
    return out, s


# (dtype, tail, byte offset of the view): word widths 16, 8, 4, 2, 1 on
# aligned tensors, and 4, 2, 1 on misaligned views (one word at a time)
_K4A_WIDTHS = [(torch.float32, (4,), 0), (torch.complex64, (), 0),
               (torch.int32, (), 0), (torch.bfloat16, (), 0),
               (torch.bool, (), 0), (torch.int32, (), 4),
               (torch.bfloat16, (3,), 2), (torch.uint8, (5,), 1),
               (torch.float32, (32,), 4), (torch.bfloat16, (128,), 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tail,off", _K4A_WIDTHS)
def test_cuda_k4a_schedules_match_plain(cuda_device, dtype, tail, off):
    """Both schedules (the narrow one in each tile layout) bit for bit
    against K4a's plain version and the plain gather, for every word
    width, on aligned tensors and misaligned views; the wrapper's own
    choice too, counted under its schedule."""
    n, batch = 10, 3
    rng = random.Random(53)
    numel = batch * (1 << n) * (tail[0] if tail else 1)
    isz = torch.tensor([], dtype=dtype).element_size()
    raw = torch.randint(0, 256, (numel * isz + 64,), device=cuda_device,
                        dtype=torch.uint8)
    x = raw[off:off + numel * isz].view(dtype).reshape((batch, 1 << n)
                                                       + tail)
    if dtype == torch.bool:
        x = raw[:numel].bool().reshape(batch, 1 << n)
    for kind in ("bitrev", "bmmc", "mixed"):
        b = _bmmc(kind, n, rng)
        t = pops.choose_tile(n, isz, tail[0] if tail else 1)
        kernel, plans = pops.class_plan(b, t)
        plan = plans[0]
        want = pk.tiled_permute_plain(x, plan, batched=True)
        if len(plans) == 1:
            assert torch.equal(want.view(torch.uint8), pref.bmmc_ref(
                x, b, batched=True).contiguous().view(torch.uint8))
        for over in ({"schedule": "narrow", "layout": "unpadded"},
                     {"schedule": "narrow", "layout": "padded",
                      "groups": 3},
                     {"schedule": "narrow", "layout": "swizzled"},
                     {"schedule": "wide"}):
            got, s = _k4a_forced(x, plan, True, **over)
            assert torch.equal(got.view(torch.uint8),
                               want.view(torch.uint8)), (kind, s)
        before = pk.launch_counts()
        got = pk.tiled_permute(x, plan, batched=True)
        rec = pk.k4a_record(x, plan, batched=True)
        after = pk.launch_counts()
        assert after["tile"] == before["tile"] + 1
        assert after[rec.path] == before[rec.path] + 1
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((70000, 16), torch.int32),
                                         ((70000, 8, 64), torch.float32)])
def test_cuda_k4a_batch_beyond_the_grid_y_limit(cuda_device, shape, dtype):
    """More batch rows than a grid's y dimension holds (65535), on the
    narrow (int32) and the wide (256-byte elements) schedule."""
    n = 4 if len(shape) == 2 else 3
    b = Bmmc.bit_reverse(n)
    x = torch.randint(0, 1 << 20, shape, device=cuda_device).to(dtype)
    t = pops.choose_tile(n, x.element_size(), shape[2] if len(shape) == 3
                         else 1)
    (plan,) = pops.class_plan(b, t)[1]
    got = pk.tiled_permute(x, plan, batched=True)
    assert pk.k4a_record(x, plan, batched=True).schedule.schedule == (
        "narrow" if len(shape) == 2 else "wide")
    assert torch.equal(got, pk.tiled_permute_plain(x, plan, batched=True))
    assert torch.equal(got, pref.bmmc_ref(x, b, batched=True))


@pytest.mark.cuda
def test_cuda_k4a_record_on_a_card_that_is_not_current(cuda_device):
    """K4a's record path on the second card while the first is current:
    both schedules launch on the tensor's device and stream."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA device")
    dev = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    hp = Bmmc.bit_reverse(3)
    for shape, dtype in (((64, 8, 128), torch.bfloat16),
                         ((64, 8), torch.int32)):
        x = torch.randint(0, 1 << 14, shape, device=dev).to(dtype)
        d = shape[2] if len(shape) == 3 else 1
        (plan,) = pops.class_plan(hp, pops.choose_tile(
            3, x.element_size(), d))[1]
        got = pk.tiled_permute(x, plan, batched=True)
        torch.cuda.synchronize(dev)
        assert torch.equal(got, pk.tiled_permute_plain(x, plan,
                                                       batched=True))
    assert torch.cuda.current_device() == 0


@pytest.mark.cuda
def test_cuda_k4a_refuses_a_tensor_that_requires_grad(cuda_device):
    plan = pops.class_plan(Bmmc.bit_reverse(8), 3)[1][0]
    x = torch.zeros(256, device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError):
        pk.tiled_permute(x, plan)
    with pytest.raises(NotImplementedError):
        pops.bmmc_permute(x, Bmmc.bit_reverse(8))


@pytest.mark.cuda
def test_cuda_k4a_record_replays_in_a_graph(cuda_device):
    """K4a launched from its record inside a CUDA-graph capture (the
    tables pinned, nothing counted while capturing) replays bit-equal to
    the eager call, on both schedules."""
    hp = Bmmc.bit_reverse(3)
    for shape, dtype in (((512, 8, 128), torch.bfloat16),
                         ((64, 1 << 12), torch.int32)):
        b = hp if len(shape) == 3 else Bmmc.random(12, random.Random(5))
        x = torch.randint(0, 1 << 14, shape, device=cuda_device).to(dtype)
        d = shape[2] if len(shape) == 3 else 1
        t = pops.choose_tile(b.n, x.element_size(), d)
        plan = pops.class_plan(b, t)[1][0]
        want = pk.tiled_permute(x, plan, batched=True)
        torch.cuda.synchronize()
        counts = pk.launch_counts()
        g = torch.cuda.CUDAGraph()
        with pk.pin_device_tables():
            with torch.cuda.graph(g):
                got = pk.tiled_permute(x, plan, batched=True)
        assert pk.launch_counts() == counts
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("remat", [True, False])
def test_cuda_small_model_trains_with_equal_engines(cuda_device, remat):
    """A smoke-sized bfloat16 model with 8 kv heads takes one AdamW step
    on the card: the shuffle on cuda (K4a, 12 launches a layer with remat,
    8 without) and on ref give bit-equal losses, gradient norms and
    updated parameters; off gives the same loss."""
    import dataclasses
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import model as M
    from repro_torch.train.step import init_opt, make_train_step
    from repro_torch.tree import tree_leaves
    base = dataclasses.replace(
        reduce_for_smoke(get_config("mistral-nemo-12b")), n_kv_heads=8,
        n_heads=8, dtype=torch.bfloat16, remat=remat)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    batch = {k: torch.randint(0, base.vocab_size, (2, 32), generator=g,
                              device=cuda_device)
             for k in ("tokens", "labels")}
    got = {}
    for engine in ("cuda", "ref", None):
        cfg = dataclasses.replace(base, head_shuffle=engine)
        params = M.init(cfg, torch.Generator(device=cuda_device)
                        .manual_seed(0))
        step, _ = make_train_step(cfg)
        pk.reset_launch_counts()
        params, st, m = step(params, init_opt(cfg, params), batch)
        launches = pk.launch_counts()["tile"]
        per_layer = 12 if remat else 8
        assert launches == (per_layer * cfg.n_layers if engine == "cuda"
                            else 0)
        assert int(st.step) == 1 and torch.isfinite(m["loss"])
        got[engine] = (m, tree_leaves(params))
    assert torch.equal(got["ref"][0]["loss"], got["cuda"][0]["loss"])
    assert torch.equal(got["ref"][0]["grad_norm"],
                       got["cuda"][0]["grad_norm"])
    for a, b in zip(got["ref"][1], got["cuda"][1]):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert torch.equal(got[None][0]["loss"], got["cuda"][0]["loss"])


@pytest.mark.cuda
def test_cuda_sort_layer_step_runs_k4b_and_k5(cuda_device):
    """A ``PermuteLayer(sort_expr(12))`` in a loss override: the step
    launches K4b forward and K5 backward and equals the step on ref bit
    for bit."""
    from repro_torch.combinators.sort import sort_expr
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models.permute import PermuteLayer
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import make_train_step
    n = 12
    g = torch.Generator(device=cuda_device).manual_seed(2)
    w0 = torch.randn(1 << n, generator=g, device=cuda_device)
    batch = {k: torch.randn((4, 1 << n), generator=g, device=cuda_device)
             for k in ("x", "y")}
    cfg = reduce_for_smoke(get_config("mistral-nemo-12b"))
    got = {}
    for engine in ("cuda", "ref"):
        layer = PermuteLayer(sort_expr(n), axis=1, engine=engine)

        def loss_fn(params, b, layer=layer):
            l = torch.mean((layer(b["x"] * params["w"]) - b["y"]) ** 2)
            return l, {"mse": l}
        step, oc = make_train_step(cfg, opt_cfg=AdamWConfig(),
                                   loss_fn=loss_fn)
        p = {"w": w0.clone()}
        pk.reset_launch_counts()
        p, _, m = step(p, adamw_init(p, oc), batch)
        counts = pk.launch_counts()
        if engine == "cuda":
            assert counts["tile_fused"] > 0 and counts["tile_bwd"] > 0
        got[engine] = (m, p["w"])
    for k in ("loss", "grad_norm"):
        assert torch.equal(got["cuda"][0][k], got["ref"][0][k])
    assert torch.equal(got["cuda"][1], got["ref"][1])


# ---------------------------------------------------------------------------
# the non-dense block kinds
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("deterministic", [False, True])
def test_cuda_moe_combine_is_bit_equal_across_runs(cuda_device,
                                                   deterministic):
    """The MoE layer on the card, top 8 of 32 experts with drops (each
    token's copies added in ascending expert id, the dispatch's backward
    likewise): two runs of the output and of every gradient are bit-equal,
    with ``torch.use_deterministic_algorithms`` off and on, and equal
    across the two modes."""
    from repro_torch.models.moe import _dispatch_group, moe_capacity, moe_ffn
    g = torch.Generator(device=cuda_device).manual_seed(3)
    t, e, f, xn, k = 512, 64, 96, 32, 8

    def make(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=cuda_device)
                * scale).to(torch.bfloat16)
    x = make(2, t, e)
    rw = torch.randn((e, xn), generator=g, device=cuda_device)
    ws = (make(xn, e, f, scale=0.2), make(xn, e, f, scale=0.2),
          make(xn, f, e, scale=0.2))
    w = make(2, t, e)

    def run():
        leaves = [v.clone().requires_grad_() for v in (x, rw) + ws]
        out, aux = moe_ffn(leaves[0], leaves[1], *leaves[2:], top_k=k,
                           capacity_factor=1.0)
        ((out.float() * w.float()).sum() + aux).backward()
        return [out.detach()] + [v.grad for v in leaves]

    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    # warn_only: cuBLAS asks for CUBLAS_WORKSPACE_CONFIG before its first
    # handle, which a test cannot set; the scatters and gathers still take
    # their deterministic paths
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    try:
        a, b = run(), run()
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
    other = run()
    for u, v, o in zip(a, b, other):
        assert torch.equal(u, v)
        assert torch.equal(u, o)
    cap = moe_capacity(t, xn, k, 1.0)
    slot = _dispatch_group(x, rw, top_k=k, cap=cap, xn=xn)[1]
    assert (slot == xn * cap).any()                     # drops happened


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kind", [("mamba2-130m", "mamba"),
                                       ("recurrentgemma-2b", "rec")])
def test_cuda_stateful_decode_advances_caches_in_place(cuda_device, arch,
                                                       kind):
    """Decode on the card writes the conv tails and the SSD / RG-LRU states
    into the stacked caches' layer slices (the same storage), and a
    decode after a prefill of t tokens equals a prefill of t + 1."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import model as M
    cfg = reduce_for_smoke(get_config(arch))
    params = M.init(cfg, torch.Generator(device=cuda_device).manual_seed(4))
    toks = torch.randint(0, cfg.vocab_size, (2, 16), device=cuda_device,
                         generator=torch.Generator(
                             device=cuda_device).manual_seed(5))
    with torch.no_grad():
        full, _ = M.prefill(cfg, params, {"tokens": toks})
        _, caches = M.prefill(cfg, params, {"tokens": toks[:, :15]})
        caches = M.grow_caches(caches, 15, 16)
        stacked = caches["scan"]
        names = [n for n in stacked if n.endswith("_" + kind)]
        old = {(n, k): (t.data_ptr(), t.clone())
               for n in names for k, t in stacked[n].items()}
        dec, new = M.decode_step(cfg, params, caches, toks[:, 15:], 15)
    assert new["scan"] is stacked
    for (n, k), (ptr, before) in old.items():
        t = new["scan"][n][k]
        assert t.data_ptr() == ptr and not torch.equal(t, before), (n, k)
    torch.testing.assert_close(dec, full, rtol=5e-3, atol=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["seamless-m4t-medium",
                                  "phi3.5-moe-42b-a6.6b"])
def test_cuda_k4a_runs_in_enc_dec_and_moe_layers(cuda_device, arch):
    """With 4 kv heads and the shuffle on ``cuda``, K4a launches 4 times in
    every self-attention layer of a prefill (the encoder's ``enc`` and the
    decoder's ``dec`` layers; the ``moe`` layers) and none in
    cross-attention; the prefill logits are bit-equal to the shuffle's
    ``ref`` engine and to no shuffle."""
    import dataclasses
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.launch import serve as S
    from repro_torch.models import model as M
    base = dataclasses.replace(reduce_for_smoke(get_config(arch)),
                               n_kv_heads=4, n_heads=4, dtype=torch.bfloat16)
    params = M.init(base, torch.Generator(device=cuda_device).manual_seed(6))
    args = S.parse_args(["--arch", arch, "--batch", "2", "--prompt-len",
                         "16", "--tokens", "3"])
    prompts = S.make_prompts(base, args, cuda_device)
    src = S.make_src(base, args, cuda_device)
    self_attn = sum(k in ("moe", "enc", "dec") for k in
                    base.layer_kinds + base.enc_pattern * base.n_enc_periods)
    got = {}
    for engine in ("cuda", "ref", None):
        pk.reset_launch_counts()
        got[engine] = S.serve(dataclasses.replace(base, head_shuffle=engine),
                              params, args, prompts, src)
        counts = pk.launch_counts()
        assert counts["tile"] == (4 * self_attn if engine == "cuda" else 0)
    assert self_attn == (2 * base.n_periods if base.is_encdec
                         else base.n_layers)
    for engine in ("ref", None):
        assert torch.equal(got[engine].prefill_logits,
                           got["cuda"].prefill_logits), engine
        assert (got[engine].gen == got["cuda"].gen).all(), engine


@pytest.fixture
def nccl_mesh(cuda_device):
    """A (1, 1) mesh on a single-rank NCCL group (destroyed afterwards)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_dev_mesh
    if dist.is_initialized():
        pytest.skip("a process group is already initialized here")
    mesh = make_dev_mesh(1, 1, device="cuda")
    yield mesh
    mesh.close()


@pytest.mark.cuda
def test_cuda_mesh_is_single_rank_nccl(nccl_mesh):
    import torch.distributed as dist
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    assert nccl_mesh.shape == {"data": 1, "model": 1}
    assert nccl_mesh.coords == {"data": 0, "model": 0}


@pytest.mark.cuda
def test_cuda_moe_a2a_dispatch_shuffle_is_neutral_on_k4a(nccl_mesh):
    """On a single-rank NCCL mesh ``moe_ffn_a2a`` with the slot shuffle on
    ``cuda`` (K4a), on ``ref`` and off gives bit-equal outputs and aux;
    on ``cuda`` K4a is launched 2 times a forward, 2 more a backward, and
    no other kernel; its gradients equal ``ref``'s bit for bit."""
    from repro_torch.models.moe_a2a import moe_ffn_a2a
    g = torch.Generator(device="cuda").manual_seed(3)
    e, f, xn, k = 256, 384, 8, 2

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).to(torch.bfloat16)
    inputs = [rnd(4, 64, e), rnd(e, xn, scale=0.1), rnd(xn, e, f, scale=0.05),
              rnd(xn, e, f, scale=0.05), rnd(xn, f, e, scale=0.05)]
    ct = torch.randn((4, 64, e), generator=g, device="cuda")
    runs = {}
    # capacity 1.25: ceil(2 * 256 * 1.25) = 640 slots, rounded to 1024
    # with the shuffle; 4.0 gives 1024 without it
    for eng, cf in (("cuda", 1.25), ("ref", 1.25), (None, 4.0)):
        ts = [t.clone().requires_grad_() for t in inputs]
        pk.reset_launch_counts()
        out, aux = moe_ffn_a2a(*ts, top_k=k, capacity_factor=cf,
                               mesh=nccl_mesh,
                               dispatch_shuffle=eng is not None,
                               shuffle_engine=eng or "cuda")
        torch.cuda.synchronize()
        fwd = pk.launch_counts()
        ((out.float() * ct).sum() + aux).backward()
        torch.cuda.synchronize()
        both = pk.launch_counts()
        runs[eng] = (out.detach(), aux.detach(), [t.grad for t in ts])
        want = 2 if eng == "cuda" else 0
        assert fwd["tile"] == want and both["tile"] == 2 * want
        assert sum(v for key, v in both.items()
                   if not key.startswith("tile")) == 0
    for eng in ("ref", None):
        assert torch.equal(runs[eng][0].view(torch.int16),
                           runs["cuda"][0].view(torch.int16))
        assert torch.equal(runs[eng][1], runs["cuda"][1])
    for a, b in zip(runs["cuda"][2], runs["ref"][2]):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))



# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_cuda_dry_run_counts_equal_the_real_run(cuda_device, kind):
    """Mistral-NeMo at smoke width with 8 kv heads and the kv-head shuffle
    on ``cuda``: the dry run (fake tensors) and the real run on the card
    under an ``OpCounter`` count the same dot FLOPs, collective bytes and
    K4a launches by schedule (4 a prefill layer, 8 a trained layer at
    smoke size, where remat is off), and
    the dry run's peak of live storages is within 64 MiB of the card's
    (allocator rounding, K4a's tables)."""
    import dataclasses
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.op_analysis import COLLECTIVE_KINDS, OpCounter
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.serve import make_prefill_step
    from repro_torch.train.step import make_train_step, opt_state_shapes
    cfg = dataclasses.replace(reduce_for_smoke(get_config("mistral-nemo-12b")),
                              n_heads=8, n_kv_heads=8, head_shuffle="cuda")
    shape = ShapeConfig("smoke", 64, 4, kind)
    batch = D.input_specs(cfg, shape)
    pshapes = M.param_shapes(cfg)
    if kind == "train":
        oc = AdamWConfig(state_bits=cfg.opt_bits)
        fn = make_train_step(cfg, opt_cfg=oc)[0]
        args = (pshapes, opt_state_shapes(cfg, pshapes, oc), batch)
    else:
        fn, args = make_prefill_step(cfg), (pshapes, batch)
    dry = D.trace_step(fn, args, kind).result()
    g = torch.Generator(device=cuda_device).manual_seed(0)
    params = M.init(cfg, g)
    real_batch = {k: torch.randint(0, cfg.vocab_size, v.shape, generator=g,
                                   device=cuda_device, dtype=v.dtype)
                  for k, v in batch.items()}
    inputs = ((params, adamw_init(params, oc), real_batch) if kind == "train"
              else (params, real_batch))
    torch.cuda.synchronize()
    counter = OpCounter()
    counter.hold(inputs)
    other = torch.cuda.memory_allocated() - counter.live_bytes
    torch.cuda.reset_peak_memory_stats()
    pk.reset_launch_counts()
    with counter, torch.set_grad_enabled(kind == "train"):
        fn(*inputs)
        torch.cuda.synchronize()
    real = counter.result()
    for k in COLLECTIVE_KINDS + ("dot_flops", "kernel_launches"):
        assert dry[k] == real[k], k
    # a training step shuffles 12 times a layer under remat, 8 without
    per_layer = (12 if cfg.remat else 8) if kind == "train" else 4
    k4a = sum(v["launches"] for v in real["kernel_launches"].values())
    assert k4a == per_layer * cfg.n_layers == pk.launch_counts()["tile"]
    peak = torch.cuda.max_memory_allocated() - other
    assert abs(peak - dry["peak_bytes"]) <= 64 * 2 ** 20


# ---------------------------------------------------------------------------
# the element types the reference's fused kernel takes: float16, 8- and
# 16-bit integers, uint32, bool; half-float butterflies; maps beside them
# ---------------------------------------------------------------------------

_SIGNED_VIEW = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}


def _typed_keys(dtype, shape, device, seed):
    """Keys of ``dtype``: random bits of integers over their whole range
    (bool 0 and 1), ties, NaNs and signed zeros for float16."""
    if dtype.is_floating_point:
        return _ties(shape, dtype, device, seed)
    g = torch.Generator(device=device).manual_seed(seed)
    if dtype == torch.bool:
        return torch.randint(0, 2, shape, generator=g, device=device) > 0
    size = torch.empty((), dtype=dtype).element_size()
    raw = torch.randint(-2**31, 2**31 - 1, shape, generator=g,
                        device=device, dtype=torch.int64)
    if size == 8:   # all 64 bits random
        low = torch.randint(0, 2**32, shape, generator=g, device=device,
                            dtype=torch.int64)
        return ((raw << 32) | low).view(dtype)
    return raw.to(_SIGNED_VIEW[size]).view(dtype)


def _bits_of(x):
    return x.view(_SIGNED_VIEW.get(x.element_size(), torch.int32))


_NEW_TYPES = [torch.float16, torch.int8, torch.uint8, torch.int16,
              torch.uint16, torch.uint32, torch.bool]
_WIDE_TYPES = [torch.int64, torch.uint64, torch.float64]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [12, 14])
@pytest.mark.parametrize("dtype", _NEW_TYPES + _WIDE_TYPES, ids=str)
def test_cuda_new_types_k4b_and_guarded_match_plain(cuda_device, dtype, n):
    """Every new K4b instantiation (the first three and the largest sort
    clusters: 8 and 16 registers, 2^14-position tiles of 1-byte elements
    at 2^14; the 64-bit types at 8 registers only) and the guarded K4b,
    bit for bit against their plain
    versions, on the 16-byte path and one element off it (the word path).
    The guarded K4b sets no flag on clean tables and bit 1, as its plain
    version does, with entry 1 of each table poisoned."""
    from repro_torch.combinators import execute as pex
    from repro_torch.combinators.sort import sort_expr
    size = torch.empty((), dtype=dtype).element_size()
    t = pops.choose_tile(n, size)
    clusters = _fused_clusters(sort_expr(n), n, t)
    picked = clusters[:3] + [max(clusters, key=lambda s: len(s.computes))]
    before = pk.launch_counts()
    for off in (0, 1):
        x = _offset(_typed_keys(dtype, (1 << n,), cuda_device, n + off), off)
        for fs in picked:
            got = _fused(fs, t, x, False, plain=False)
            want = _fused(fs, t, x, False, plain=True)
            assert torch.equal(_bits_of(got), _bits_of(want)), (off, fs)
        fs = picked[-1]
        plans, entries = pex._fused_plan_cached(fs, t)
        tabs, epi = pex._pass_tables(plans[0], entries, x)
        geo = pk.plan_geometry(plans[0])
        flags = torch.zeros(1, dtype=torch.int32, device=cuda_device)
        pflags = torch.zeros_like(flags)
        want = pk.tiled_permute_tables(x, *tabs, geometry=geo, **epi)
        got = pk.tiled_permute_tables(x, *tabs, geometry=geo, flags=flags,
                                      **epi)
        plain = pk.tiled_permute_tables_plain(x, *tabs, geometry=geo,
                                              flags=pflags, **epi)
        torch.cuda.synchronize()
        assert int(flags) == 0 and int(pflags) == 0
        assert torch.equal(_bits_of(got), _bits_of(want))
        assert torch.equal(_bits_of(got), _bits_of(plain))
        for table in range(4):
            bad = [a.clone() for a in tabs]
            bad[table].view(-1)[1] = 1 << 30
            flags.zero_()
            pflags.zero_()
            got = pk.tiled_permute_tables(x, *bad, geometry=geo, flags=flags,
                                          **epi)
            plain = pk.tiled_permute_tables_plain(x, *bad, geometry=geo,
                                                  flags=pflags, **epi)
            torch.cuda.synchronize()
            assert int(flags) == 1 and int(pflags) == 1, table
            keep = torch.ones(1 << n, dtype=torch.bool, device=cuda_device)
            if table == 1:   # a bad output row id leaves that row unwritten
                r0 = int(tabs[1].view(-1)[1])
                keep[r0 << geo[1]:(r0 + 1) << geo[1]] = False
            assert torch.equal(_bits_of(got)[keep], _bits_of(plain)[keep])
    after = pk.launch_counts()
    assert after["tile_fused"] >= before["tile_fused"] + 2 * len(picked)
    assert after["tile_fused_guarded"] == before["tile_fused_guarded"] + 10


def _fft_map_expr(n, t, name, fn):
    """The 2^n FFT with ``emap(name, fn)`` after the first butterfly stage
    whose cluster at tile ``t`` then holds the map beside butterflies."""
    from repro_torch.combinators import compile_expr
    from repro_torch.combinators import fft as F
    from repro_torch.combinators import vocab as V
    for map_at in range(n):
        stages = [V.bit_reverse(n)]
        for s in range(n):
            e = F._stage_core(s)
            for _ in range(n - s - 1):
                e = V.two(e)
            stages.append(e)
            if s == map_at:
                stages.append(V.emap(name, fn))
        expr = V.seq(*stages)
        for fs in compile_expr(expr).clustered_program(n, t):
            kinds = {type(c).__name__ for c, _ in getattr(fs, "computes", ())}
            if {"Map", "Bfly"} <= kinds:
                return expr
    raise AssertionError("no cluster holds the map beside butterflies")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64], ids=str)
@pytest.mark.parametrize("case", ["fft", "fft + map", "fft + sin",
                                  "fft, 2 bytes off"])
def test_cuda_planar_butterflies_of_every_float_type(cuda_device, dtype,
                                                     case):
    """Butterflies on planar float32, bfloat16, float16 and float64 (each
    product and sum rounded to the type, the twiddles rounded to it;
    float64 in double with float64 twiddles; "2 bytes off" moves a float64
    pair 16 bytes, so it stays on the 16-byte path), alone, beside
    a map (``v * 2 - 1``, ``sin``) and one element off 16-byte alignment:
    K4b, the guarded K4b (no map) and K5 bit for bit against their plain
    versions, K5 on the map variant where the cluster holds a map."""
    from repro_torch.combinators.fft import fft_expr
    n = 12
    t = pops.choose_tile(n, torch.empty((), dtype=dtype).element_size(), 2)
    expr = {"fft": fft_expr(n), "fft, 2 bytes off": fft_expr(n),
            "fft + map": _fft_map_expr(n, t, "twice_less_one",
                                       lambda v: v * 2 - 1),
            "fft + sin": _fft_map_expr(n, t, "sin", torch.sin)}[case]
    clusters = _fused_clusters(expr, n, t)
    if "+" in case:
        clusters = [fs for fs in clusters
                    if any(type(c).__name__ == "Map" for c, _ in fs.computes)]
        assert clusters and any(type(c).__name__ == "Bfly"
                                for c, _ in clusters[0].computes)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    off = 1 if "off" in case else 0
    x = _offset(torch.randn(1 << n, 2, generator=g, device=cuda_device)
                .to(dtype), 2 * off)
    ct = _offset(torch.randn(1 << n, 2, generator=g, device=cuda_device)
                 .to(dtype), 2 * off)
    iv = _SIGNED_VIEW[x.element_size()]
    flags = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    for fs in clusters:
        got = _fused(fs, t, x, False, plain=False)
        want = _fused(fs, t, x, False, plain=True)
        assert torch.equal(got.view(iv), want.view(iv)), case
        if "+" not in case:
            with pk.guard_flags(flags):
                guarded = _fused(fs, t, x, False, plain=False)
            torch.cuda.synchronize()
            assert int(flags) == 0
            assert torch.equal(guarded.view(iv), want.view(iv))
        got = _bwd(fs, t, x, ct, False, plain=False)
        want = _bwd(fs, t, x, ct, False, plain=True)
        assert torch.equal(got.view(iv), want.view(iv)), case


@pytest.mark.cuda
@pytest.mark.parametrize("label,tail,batch,off", [
    ("float64", (), None, 0), ("float64 d=3", (3,), None, 0),
    ("float64 B=3", (), 3, 0), ("float64 8 bytes off", (), None, 1)])
def test_cuda_k5_float64_matches_plain(cuda_device, label, tail, batch, off):
    """K5 on float64 compare clusters (ties, NaNs, signed zeros; the
    compare bits from 64-bit keys, products and sums in double) bit for bit
    against its plain version, on the 16-byte path and off it."""
    from repro_torch.combinators.sort import sort_expr
    n = 12
    d = tail[0] if tail else 1
    t = pops.choose_tile(n, 8, d)
    shape = ((batch,) if batch else ()) + (1 << n,) + tail
    x = _offset(_ties(shape, torch.float64, cuda_device, 6), off)
    ct = _offset(torch.randn(shape, device=cuda_device,
                             dtype=torch.float64), off)
    clusters = _fused_clusters(sort_expr(n), n, t)
    picked = clusters[:2] + [max(clusters, key=lambda s: len(s.computes))]
    for fs in picked:
        got = _bwd(fs, t, x, ct, bool(batch), plain=False)
        want = _bwd(fs, t, x, ct, bool(batch), plain=True)
        assert torch.equal(got.view(torch.int64), want.view(torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("label,tail,batch", [("float16", (), None),
                                              ("float16 d=3", (3,), None),
                                              ("float16 B=3", (), 3)])
def test_cuda_k5_float16_matches_plain(cuda_device, label, tail, batch):
    """K5 on float16 compare clusters (ties, NaNs, signed zeros; the 0.5
    tie masks and the products and sums in half arithmetic) bit for bit
    against its plain version."""
    from repro_torch.combinators.sort import sort_expr
    n = 12
    d = tail[0] if tail else 1
    t = pops.choose_tile(n, 2, d)
    shape = ((batch,) if batch else ()) + (1 << n,) + tail
    x = _ties(shape, torch.float16, cuda_device, 5)
    ct = torch.randn(shape, device=cuda_device).to(torch.float16)
    clusters = _fused_clusters(sort_expr(n), n, t)
    picked = clusters[:2] + [max(clusters, key=lambda s: len(s.computes))]
    for fs in picked:
        got = _bwd(fs, t, x, ct, bool(batch), plain=False)
        want = _bwd(fs, t, x, ct, bool(batch), plain=True)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


_TYPED_MAPS = [
    (torch.float16, "tanh", torch.tanh),
    (torch.float16, "sigmoid", torch.sigmoid),
    (torch.float16, "affine3", lambda v: (v * 3 + 1) * 0.5),
    (torch.float16, "div7", lambda v: v / 7),
    (torch.float32, "sin", torch.sin), (torch.float32, "cos", torch.cos),
    (torch.bfloat16, "sin", torch.sin), (torch.bfloat16, "cos", torch.cos),
    (torch.float16, "sin", torch.sin), (torch.float16, "cos", torch.cos),
    (torch.float32, "sin of large", lambda v: torch.sin(v * 1000)),
    (torch.int8, "wrap", lambda v: v * 7 + 3),
    (torch.uint8, "shr", lambda v: v >> 1),
    (torch.int16, "not", torch.bitwise_not),
    (torch.uint8, "x3", lambda v: v * 3),
    (torch.int16, "clamp", lambda v: torch.clamp(v, -1000, 1000)),
    (torch.bool, "not", torch.bitwise_not),
    (torch.float64, "tanh", torch.tanh),
    (torch.float64, "sigmoid", torch.sigmoid),
    (torch.float64, "affine3", lambda v: (v * 3 + 1) * 0.5),
    (torch.float64, "div7", lambda v: v / 7),
    (torch.float64, "sin", torch.sin), (torch.float64, "cos", torch.cos),
    (torch.float64, "exp, log1p", lambda v: torch.log1p(torch.exp(v))),
    (torch.float64, "sqrt, rsqrt", lambda v: torch.rsqrt(torch.sqrt(
        torch.abs(v) + 1))),
    (torch.float64, "wide constant", lambda v: v * 0.1 + 1e300),
    (torch.int64, "wrap", lambda v: v * 1000003 + (1 << 40)),
    (torch.int64, "shr 40", lambda v: (v >> 40) ^ -(1 << 50)),
    (torch.int64, "clamp", lambda v: torch.clamp(v, -(1 << 45), 1 << 33)),
    (torch.uint64, "xor wide", lambda v: v ^ ((1 << 63) + 5)),
    (torch.uint64, "x3", lambda v: v * 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,name,fn", _TYPED_MAPS,
                         ids=[f"{d}-{n}" for d, n, _ in _TYPED_MAPS])
def test_cuda_maps_of_every_type_match_plain(cuda_device, dtype, name, fn):
    """Map epilogues of each new type in K4b (and K5 for the float types),
    bit for bit against their plain versions, which run the map's torch
    function eagerly on the card: float16 computes in float and rounds
    after each op, the integers wrap at their width, bool's NOT is an XOR
    with 1; sin and cos (float32, bfloat16, float16, float64; large
    arguments included) equal eager torch, their derivatives autograd's;
    the 64-bit types keep every bit of their constants (uint64 against
    its plain version on the CPU)."""
    n = 12
    t = pops.choose_tile(n, torch.empty((), dtype=dtype).element_size())
    x = _typed_keys(dtype, (1 << n,), cuda_device, 9)
    if dtype.is_floating_point:
        u = torch.rand(1 << n, device=cuda_device,
                       dtype=torch.float64 if dtype == torch.float64
                       else torch.float32)
        x = ((u - 0.5) * 8).to(dtype)
    clusters = [fs for fs in _fused_clusters(_map_expr(n, name, fn), n, t)
                if any(type(c).__name__ == "Map" for c, _ in fs.computes)]
    assert clusters
    # torch on the card has no uint64 mul or xor: its plain version runs
    # on the CPU
    plain_x = x.cpu() if dtype == torch.uint64 else x
    for fs in clusters:
        got = _fused(fs, t, x, False, plain=False)
        want = _fused(fs, t, plain_x, False, plain=True)
        assert torch.equal(_bits_of(got).cpu(), _bits_of(want).cpu()), name
        if dtype.is_floating_point:
            ct = torch.randn(1 << n, device=cuda_device).to(dtype)
            got = _bwd(fs, t, x, ct, False, plain=False)
            want = _bwd(fs, t, x, ct, False, plain=True)
            assert torch.equal(_bits_of(got), _bits_of(want)), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", _NEW_TYPES + _WIDE_TYPES, ids=str)
def test_cuda_sort_of_every_type_fuses(cuda_device, dtype):
    """``sort.sort`` of 2^16 keys of each new type on the card: no fused
    fallback, every compute cluster one K4b launch, bit-equal to the same
    program's plain run on the CPU (float16: NaNs by position) and, where
    torch sorts the type, to ``torch.sort``; the float16 and float64
    gradients through K5 bit-equal to the CPU's."""
    from repro_torch import obs
    from repro_torch.combinators import FusedStage
    from repro_torch.combinators.sort import compiled_sort
    n = 16
    x = _typed_keys(dtype, (1 << n,), cuda_device, 17)
    f = compiled_sort(n)
    pk.reset_launch_counts()
    obs.reset()
    obs.enable()
    try:
        got = f(x)
        torch.cuda.synchronize()
        assert obs.counter_total("dispatch.fused_fallback") == 0
    finally:
        obs.disable()
        obs.reset()
    t = pops.choose_tile(n, x.element_size())
    fused = sum(1 for s in f.clustered_program(n, t)
                if isinstance(s, FusedStage) and s.computes)
    assert pk.launch_counts()["tile_fused"] == fused > 0
    want = f(x.cpu())
    assert torch.equal(_bits_of(got).cpu(), _bits_of(want))
    if dtype in (torch.int8, torch.uint8, torch.int16, torch.int64):
        assert torch.equal(got, torch.sort(x).values)
    if dtype in (torch.float16, torch.float64):
        xg = x.clone().requires_grad_(True)
        w = torch.randn(1 << n, device=cuda_device).to(dtype)
        (w * f(xg)).sum().backward()
        xc = x.cpu().requires_grad_(True)
        (w.cpu() * f(xc)).sum().backward()
        iv = _SIGNED_VIEW[x.element_size()]
        assert torch.equal(xg.grad.cpu().view(iv), xc.grad.view(iv))
