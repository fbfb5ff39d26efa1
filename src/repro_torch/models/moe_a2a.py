"""Expert-parallel MoE with explicit all-to-all dispatch over a mesh.

The counterpart of :mod:`repro.models.moe_a2a`. Tokens *travel*: each
rank routes its own token slice, packs per-peer send buffers,
``all_to_all``s them to the experts' owners along the ``model`` axis,
computes locally, and ``all_to_all``s the results back, where the
capacity formulation (:mod:`.moe`) ends an MoE layer with a reduction of
the whole activation.

``dispatch_shuffle=True`` adds a *static* BMMC permutation of the send
slots inside each peer's capacity block (routing metadata rides along,
so expert compute is unaffected; the return trip is inverse-permuted).
Enabling it also rounds the per-peer capacity up to a power of two (the
shuffle's block size); at equal effective capacity the outputs are
bit-identical. The float payload goes through ``perm_apply`` on
``shuffle_engine`` (``"cuda"`` by default: K4a on a card tensor, its
plain version on a CPU tensor; the reference hard-codes ``"ref"``):
two launches a forward (send, and the inverse on the return trip) and
two a backward (the VJP is the inverse through the same engine).

**Layout.** :func:`moe_ffn_a2a` takes the global ``(B, S, E)`` tensors,
replicated on every rank as the port keeps them outside this body
(:mod:`repro_torch.parallel.sharding`), and returns the global output
and ``aux`` on every rank, as the reference's ``out_specs`` do. Inside,
each rank cuts the slice the reference's ``shard_map`` gives it: batch
over the dp axes and **sequence over** ``model`` for ``x``, experts over
``model`` and the embed dim over dp for the expert weights.

**Gradients at the replicated boundary.** Every rank computes the same
loss from the same replicated output, so the boundary is written out
(:class:`_Scatter`, :class:`_Gather`, :class:`_Replicated`,
:class:`_PMean`): gathering the output takes this rank's slice of the
cotangent back, cutting a slice gathers every rank's gradient slice, a
replicated input (the router) sums every rank's cotangent, and the
``pmean`` of ``aux`` scales its cotangent. The reductions inside stay
reductions: the dp ``all_gather`` of the expert weights sums over dp in
its backward, and ``all_to_all``'s backward is the reverse
``all_to_all``. Every sum across ranks gathers the terms and adds them in
rank order from zero, so every rank holds the same bits.

**Determinism.** A token's routed copies are added by gathers in
ascending sorted position (by peer, then by top-k rank within a token),
from zero, in ``x``'s dtype, as the reference's ``.at[tok_s].add`` adds
them; so is the backward of the token gather. Every other scatter on
the path writes each row once.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..combinators.execute import perm_apply
from ..core.bmmc import Bmmc
from ..kernels.ref import bmmc_ref
from ..launch.mesh import all_gather, all_sum, all_to_all, ordered_sum
from ..parallel.sharding import dp_axes as _dp_axes
from .moe import _TakeTokens, _token_sum, router_topk


def _slot_shuffle(buf, bmmc, *, inverse: bool = False,
                  engine="cuda"):
    """Permute the slot axis (axis 1) of a (peers, cap[, e]) buffer by a
    static BMMC; every peer block shares the one offline plan. Integer
    metadata takes the plain gather (no VJP machinery on int dtypes)."""
    b = bmmc.inverse() if inverse else bmmc
    if not buf.is_floating_point():
        return bmmc_ref(buf, b, batched=True)
    return perm_apply(buf, b, engine, True)


# ---------------------------------------------------------------------------
# Collectives and the replicated boundary
# ---------------------------------------------------------------------------

class _AllToAll(torch.autograd.Function):
    """Differentiable :func:`all_to_all`: its transpose is itself."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    """``all_gather(axis=dim, tiled=True)``; the backward sums each
    slice's cotangent over the group (a reduce-scatter: ``all_to_all``,
    then the received terms added in rank order)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        parts = all_gather(x, group)
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        if n == 1:
            return g, None, None
        recv = all_to_all(torch.stack(g.chunk(n, ctx.dim)), ctx.group)
        return ordered_sum(recv.unbind(0)), None, None


class _Blocks:
    """A tensor of ``shape`` cut into blocks by ``spec`` (one entry a dim:
    None, an axis, or a tuple of axes) over every axis of ``mesh``: each
    rank holds one block, and the blocks tile the tensor."""

    def __init__(self, mesh, shape, spec):
        named = [a for e in spec if e is not None
                 for a in ((e,) if isinstance(e, str) else e)]
        if sorted(named) != sorted(mesh.axis_names):
            raise ValueError(f"spec {spec} must name each mesh axis "
                             f"{mesh.axis_names} once")
        for dim, e in zip(shape, spec):
            if e is not None and dim % mesh.size(e):
                raise ValueError(f"a dim of {dim} does not split over "
                                 f"{e} ({mesh.size(e)} ranks)")
        self.mesh, self.shape, self.spec = mesh, tuple(shape), tuple(spec)
        self.group = mesh.group(mesh.axis_names)

    def slices(self, coords=None):
        out = []
        for dim, e in zip(self.shape, self.spec):
            if e is None:
                out.append(slice(None))
                continue
            blk = dim // self.mesh.size(e)
            i = self.mesh.index(e, coords)
            out.append(slice(i * blk, (i + 1) * blk))
        return tuple(out)

    def assemble(self, block):
        """Every rank's block gathered into the whole tensor."""
        out = block.new_empty(self.shape)
        ranks = dist.get_process_group_ranks(self.group)
        for r, part in zip(ranks, all_gather(block, self.group)):
            out[self.slices(self.mesh.coords_of(r))] = part
        return out


class _Scatter(torch.autograd.Function):
    """This rank's block of a replicated tensor; the backward gathers every
    rank's gradient block into the replicated gradient."""

    @staticmethod
    def forward(ctx, x, blocks):
        ctx.blocks = blocks
        return x[blocks.slices()].contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.blocks.assemble(g), None


class _Gather(torch.autograd.Function):
    """Every rank's block gathered into the replicated tensor; the backward
    takes this rank's block of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, blocks):
        ctx.blocks = blocks
        return blocks.assemble(x)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.blocks.slices()].contiguous(), None


class _Replicated(torch.autograd.Function):
    """A replicated input of the body, used by every rank on its own
    tokens: the backward sums every rank's cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_sum(g, ctx.group), None


class _PMean(torch.autograd.Function):
    """``pmean`` over ``group`` to a replicated value: the cotangent every
    rank holds is the whole one, so each term's is that over the size."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        return all_sum(x, group) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


# ---------------------------------------------------------------------------
# The per-rank body
# ---------------------------------------------------------------------------

def _sorted_positions(order, t: int, k: int):
    """Each token's sorted positions, ascending: (t, k) from ``order``
    (sorted position -> flat (token, rank) index)."""
    inv = torch.argsort(order)
    return torch.sort(inv.reshape(t, k), dim=-1).values


def _device_moe(x, router_w, w_gate, w_up, w_down, *, mesh, top_k: int,
                n_experts: int, capacity_factor: float,
                model_axis: str, dp_axes: Tuple[str, ...],
                dispatch_shuffle: bool = False, shuffle_engine="cuda"):
    """Per-rank body. x: (T_local, E). Expert weights arrive model-sharded
    on dim 0 and FSDP-sharded over dp on the embed dim; gathered here."""
    t, e = x.shape
    dev = x.device
    n_peers = mesh.shape[model_axis]
    xpp = n_experts // n_peers                     # experts per peer

    def gather_dp(w, axis):
        # the minor dp axis first, so the embed dim comes back in the
        # in_specs' row-major (pod, data) block order (the reference
        # gathers pod first, which misorders it when both exceed 1)
        for ax in reversed(dp_axes):
            w = _AllGather.apply(w, mesh.group(ax), axis)
        return w
    wg = gather_dp(w_gate, 1)                      # (xpp, E, F)
    wu = gather_dp(w_up, 1)
    wd = gather_dp(w_down, 2)                      # (xpp, F, E)

    # -- route ----------------------------------------------------------------
    logits = x.float() @ router_w.float()
    weights, ids, aux = router_topk(logits, top_k)  # (T, k)
    aux = _PMean.apply(aux, mesh.group(mesh.axis_names))

    # -- pack per-peer send buffers --------------------------------------------
    cap = int(np.ceil(top_k * t * capacity_factor / n_peers))
    cap = max(8, int(np.ceil(cap / 8)) * 8)
    if dispatch_shuffle:  # slot shuffle needs a power-of-two block
        cap = 1 << (cap - 1).bit_length()
        slot_bmmc = Bmmc.bit_reverse(cap.bit_length() - 1)
    flat_ids = ids.reshape(-1)
    peer = flat_ids // xpp
    order = torch.argsort(peer, stable=True)
    peer_s = peer[order]
    eid_s = flat_ids[order] % xpp
    tok_s = order // top_k
    w_s = weights.reshape(-1)[order]
    pos_tok = _sorted_positions(order, t, top_k)

    starts = torch.searchsorted(peer_s, torch.arange(n_peers, device=dev),
                                right=False)
    pos = torch.arange(t * top_k, device=dev) - starts[peer_s]
    keep = pos < cap
    slot = torch.where(keep, peer_s * cap + pos, n_peers * cap)  # -> drop

    # one spare row takes the dropped slots and is cut off
    rows = _TakeTokens.apply(x[None], tok_s[None], pos_tok[None])[0]
    send = torch.zeros((n_peers * cap + 1, e), dtype=x.dtype, device=dev)
    send = send.scatter(0, slot[:, None].expand(-1, e), rows)[:-1]
    send_eid = torch.full((n_peers * cap + 1,), xpp, dtype=torch.int64,
                          device=dev)                           # pad sentinel
    send_eid = send_eid.scatter(0, slot, eid_s)[:-1]

    # -- exchange: tokens travel to their experts' owners ----------------------
    group = mesh.group(model_axis)
    send3 = send.reshape(n_peers, cap, e)
    send_eid2 = send_eid.reshape(n_peers, cap)
    if dispatch_shuffle:  # static slot relayout; eids ride along
        send3 = _slot_shuffle(send3, slot_bmmc, engine=shuffle_engine)
        send_eid2 = _slot_shuffle(send_eid2, slot_bmmc)
    recv = _AllToAll.apply(send3, group)
    recv_eid = all_to_all(send_eid2, group)
    rt = recv.reshape(n_peers * cap, e)
    re_ = recv_eid.reshape(n_peers * cap)

    # -- local expert compute: pack by local expert id --------------------------
    r = rt.shape[0]
    order2 = torch.argsort(re_, stable=True)
    eid2 = re_[order2]
    # rt.shape[0] = n_peers*cap already carries the capacity_factor slack;
    # dividing by xpp keeps the same per-expert overprovisioning.
    cap2 = max(8, int(np.ceil(r / xpp / 8)) * 8)
    cap2 = min(cap2, r)
    starts2 = torch.searchsorted(eid2, torch.arange(xpp + 1, device=dev),
                                 right=False)   # [xpp]: the sentinels' start
    pos2 = torch.arange(r, device=dev) - starts2[eid2]
    keep2 = (pos2 < cap2) & (eid2 < xpp)           # drop pad sentinels
    slot2 = torch.where(keep2, eid2 * cap2 + pos2, xpp * cap2)
    buf = torch.zeros((xpp * cap2 + 1, e), dtype=x.dtype, device=dev)
    buf = buf.scatter(0, slot2[:, None].expand(-1, e), rt[order2])[:-1]
    buf = buf.reshape(xpp, cap2, e)

    g = buf @ wg
    u = buf @ wu
    h = F.silu(g.float()).to(x.dtype) * u
    yb = (h @ wd).reshape(xpp * cap2, e)

    # un-permute local results back to recv-slot order; a zero row for the
    # dropped slots (the reference's keep mask)
    y_sorted = F.pad(yb, (0, 0, 0, 1))[slot2]
    # ``order2`` is a permutation: each row is added once, to zero
    y_recv = torch.zeros((r, e), dtype=x.dtype, device=dev).index_add(
        0, order2, y_sorted)

    # -- return trip + weighted combine ----------------------------------------
    back = _AllToAll.apply(y_recv.reshape(n_peers, cap, e), group)
    if dispatch_shuffle:  # undo the slot relayout: back to packing order
        back = _slot_shuffle(back, slot_bmmc, inverse=True,
                             engine=shuffle_engine)
    back = back.reshape(n_peers * cap, e)
    y_slot = F.pad(back, (0, 0, 0, 1))[slot]
    y_slot = y_slot * w_s[:, None].to(x.dtype)
    out = _token_sum(y_slot[None], pos_tok[None])[0]
    return out, aux


def moe_ffn_a2a(x, router_w, w_gate, w_up, w_down, *, top_k: int,
                capacity_factor: float, mesh, dispatch_shuffle: bool = False,
                shuffle_engine="cuda"):
    """x: (B, S, E), replicated on every rank of ``mesh``. Returns (out
    (B, S, E), aux), both replicated. Each rank runs the reference's
    ``shard_map`` body on its slice: batch -> dp axes, sequence -> model
    axis (the sequence-parallel layout). ``dispatch_shuffle``
    BMMC-permutes send slots within each peer block on ``shuffle_engine``
    (neutral at equal capacity; rounds capacity to a power of two — see
    the module docstring)."""
    dp = _dp_axes(mesh)
    dp_entry = dp if len(dp) > 1 else dp[0]
    n_experts = router_w.shape[1]
    if n_experts % mesh.shape["model"]:
        raise ValueError(f"{n_experts} experts do not split over a "
                         f"{mesh.shape['model']}-wide model axis")
    b, s, e = x.shape
    # the reference's in_specs and out_specs
    x_blocks = _Blocks(mesh, x.shape, (dp_entry, "model", None))
    wg_blocks = _Blocks(mesh, w_gate.shape, ("model", dp_entry, None))
    wu_blocks = _Blocks(mesh, w_up.shape, ("model", dp_entry, None))
    wd_blocks = _Blocks(mesh, w_down.shape, ("model", None, dp_entry))
    xg = _Scatter.apply(x, x_blocks)
    bl, sl = xg.shape[:2]
    out, aux = _device_moe(
        xg.reshape(bl * sl, e),
        _Replicated.apply(router_w, mesh.group(mesh.axis_names)),
        _Scatter.apply(w_gate, wg_blocks), _Scatter.apply(w_up, wu_blocks),
        _Scatter.apply(w_down, wd_blocks), mesh=mesh, top_k=top_k,
        n_experts=n_experts, capacity_factor=capacity_factor,
        model_axis="model", dp_axes=dp, dispatch_shuffle=dispatch_shuffle,
        shuffle_engine=shuffle_engine)
    return _Gather.apply(out.reshape(bl, sl, e), x_blocks), aux
