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
