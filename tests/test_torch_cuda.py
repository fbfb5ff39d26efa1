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
    assert all(after[k] > counts[k] for k in after), (counts, after)



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
