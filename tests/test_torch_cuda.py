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
def test_cuda_guarded_fused_kernel_matches_and_traps(cuda_device):
    from repro_torch.combinators import execute as pex
    from repro_torch.combinators import compile_expr
    from repro_torch.combinators.sort import sort_expr
    n = 14
    f = compile_expr(sort_expr(n))
    t = pops.choose_tile(n, 4)
    fs = next(s for s in f.clustered_program(n, t)
              if getattr(s, "computes", ()))
    plans, entries = pex._fused_plan_cached(fs, t)
    x = torch.randint(-2**31, 2**31 - 1, (1 << n,), device=cuda_device,
                      dtype=torch.int64).to(torch.int32)
    tabs, epi = pex._pass_tables(plans[0], entries, x)
    geo = pk.plan_geometry(plans[0])
    flags = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    before = pk.launch_counts()["tile_fused_guarded"]
    got = pk.tiled_permute_tables(x, *tabs, geometry=geo, flags=flags, **epi)
    want = pk.tiled_permute_tables(x, *tabs, geometry=geo, **epi)
    plain = pk.tiled_permute_tables_plain(x, *tabs, geometry=geo, **epi)
    torch.cuda.synchronize()
    assert pk.launch_counts()["tile_fused_guarded"] == before + 1
    assert int(flags) == 0 and torch.equal(got, want)
    assert torch.equal(got, plain)
    bad = tabs[3].clone()
    bad.view(-1)[0] = -1
    pflags = torch.zeros_like(flags)
    got = pk.tiled_permute_tables(x, tabs[0], tabs[1], tabs[2], bad,
                                  geometry=geo, flags=flags, **epi)
    plain = pk.tiled_permute_tables_plain(x, tabs[0], tabs[1], tabs[2], bad,
                                          geometry=geo, flags=pflags, **epi)
    torch.cuda.synchronize()
    assert int(flags) == 1 and int(pflags) == 1 and torch.equal(got, plain)


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
