"""Host plan of the fused epilogues that K4b and K5 run in registers.

A block of K4b (``tile_fused.cu``) or K5 (``tile_bwd.cu``) runs the
epilogues on one work item at a time, ``Q = 2^B`` tile positions: the
column bits of its rows (``0 .. t-1``), the row bits of a tile (``t ..
t + log2(rows_per_tile) - 1``) and, when a work item holds several
tiles, the tile-in-item bits above. Its 256 threads
hold the positions in registers under a *layout*: a basis of the
positions over GF(2) split into 4 register slots (16 positions a
thread), 5 lane slots and 3 warp slots, plus *outer* slots when ``B >
12`` (the block then runs the epilogues on its tile in chunks). Position
``q`` of register ``i`` in thread ``tid`` (chunk ``c``) is the XOR of
the slot images of the set bits of ``(i, tid, c)``.

An epilogue with partner XOR ``v`` runs in registers when ``v`` lies in
the span of the register and lane slots: its register coordinates
``vreg`` pick the partner register (an index the kernel fixes at compile
time, one case per value), its lane coordinates ``vlane`` a
``__shfl_xor_sync``. :func:`plan_epilogues` splits a cluster's epilogues
into *phases*, each the longest run whose XORs span at most the 9
register and lane slots, and gives each phase a layout; between phases
the block passes its values through the shared-memory tile once (one
barrier). Among the layouts of a phase it takes the one whose loads from
the tile hit the fewest shared-memory wavefronts, then the one with the
fewest shuffled epilogues.

The tables of an epilogue become algebra: ``hi_row`` and ``hi_lane``
(and ``tw_row``, ``tw_lane``) are linear over GF(2) in the bits of their
index (:func:`repro_torch.core.tiling.compute_tables` builds them with no
constant), and ``hi_base`` / ``tw_base`` are affine over the tiles of a
block. So ``hi(q)`` is the parity of ``q & hmask`` XOR ``hi_base[g0]``
(``g0`` the first tile of the block's positions: of a work item, where a
K4b or K5 block takes several, each with its own entries), and the
twiddle index is a GF(2) matrix-vector product over the position bits
XOR ``tw_base[g0]``. A
table that is not of this form raises :class:`ValueError`; there is no
fallback to tables.

A ``map`` epilogue (kind 2, an element-wise function lowered to a tape
by :mod:`.map_lower`) has no partner (XOR 0): it runs in the thread on
each register, in any phase, and its record points to its tape. K5 keeps
each map's input values in shared memory for its transposed sweep, one
*slot* a map, as many as fit (``map_slots``); past that, a map keeps no
slot and K5 recomputes its input from the nearest map before it in the
same phase that keeps one, replaying the epilogues in between into one
spare slot (:func:`map_checkpoints`). The first map of each phase always
keeps a slot.

The plan is a flat int64 array (:data:`HDR_WORDS` header words, then
:data:`PHASE_WORDS` per phase, :data:`EPI_WORDS` per epilogue, then the
maps' tapes, :func:`.map_lower.tape_words` each, a tape shared by the
maps that hold the same words) whose offsets ``tile_epilogue.cuh``
mirrors; the device pointers of ``hi_base``, ``tw_base`` and the twiddle
values are filled in by the launcher.
"""
from __future__ import annotations

import functools
import itertools
from typing import Optional

import numpy as np

from ..core.f2 import in_span, parity
from ..core.tiling import _affine_table, _coords
from .map_lower import tape_words

REGS = 16            # most positions a thread holds (register slots: 4 bits)
LANE_BITS = 5
WARP_BITS = 3
THREADS = 256
MAX_OUTER = 8
CMP_GROUP = 16       # compares whose K5 bits share one register

HDR_WORDS = 4        # n_phases, n_epi, outer bits, register bits
PHASE_WORDS = 32
EPI_WORDS = 32
# phase record
PH_E0, PH_E1, PH_REG_VALID, PH_TID_INVALID, PH_GROUP, PH_FIRST, PH_MAPS = \
    range(7)
PH_IMG_REG, PH_IMG_THR, PH_IMG_OUT = 8, 12, 20
# epilogue record
KIND_CMP, KIND_BFLY, KIND_MAP = 0, 1, 2
(EP_KIND, EP_VREG, EP_VLANE, EP_HREG, EP_HMASK, EP_HI_BASE, EP_TW_BASE,
 EP_W, EP_SHIFT) = range(9)
EP_TW_REG, EP_TW_THR, EP_TW_OUT = 12, 16, 24
# a map's record: the tape's length, the slot where K5 keeps the map's
# input values, the epilogue whose kept input K5 recomputes this one's
# from (-1: the map keeps its own; its slot is then the spare one), and
# the plan word where its tape starts (map_lower.tape_words), past
# EP_HI_BASE and EP_TW_BASE, which the kernels read as pointers, and 1
# for a typed tape (map_lower.Tape.typed: its type words follow its ops),
# 2 for a typed tape of the float family (Tape.mixed)
EP_MAP_LEN, EP_MAP_SLOT, EP_MAP_FROM, EP_MAP_TAPE, EP_MAP_TYPED = \
    1, 2, 3, 8, 9


def _log2(v: int) -> int:
    return v.bit_length() - 1


def linear_images(tab, bits: int, what: str) -> list:
    """The images of the ``bits`` index bits of a table that is linear
    over GF(2) (``tab[i]`` the XOR of the images of the set bits of
    ``i``, ``tab[0] == 0``); raises when it is not."""
    a = np.asarray(tab).astype(np.int64).reshape(-1)
    if a.size != 1 << bits:
        raise ValueError(f"{what}: {a.size} entries, expected {1 << bits}")
    imgs = [int(a[1 << k]) for k in range(bits)]
    if not np.array_equal(a, _affine_table(imgs)):
        raise ValueError(f"{what} is not linear over GF(2) in the bits of "
                         f"its index: the register epilogues cannot run it")
    return imgs


def block_images(base, per_cta: int, what: str) -> list:
    """The images of the tile-in-block bits of a per-tile table that is
    affine over the ``per_cta`` tiles of every block (``base[g0 ^ j] ==
    base[g0] ^ lin(j)``); raises when it is not."""
    a = np.asarray(base).astype(np.int64).reshape(-1)
    if a.size % per_cta:
        raise ValueError(f"{what}: {a.size} tiles, not whole blocks of "
                         f"{per_cta}")
    blk = a.reshape(-1, per_cta)
    imgs = [int(blk[0, 1 << k] ^ blk[0, 0]) for k in range(_log2(per_cta))]
    if not np.array_equal(blk ^ blk[:, :1],
                          np.broadcast_to(_affine_table(imgs), blk.shape)):
        raise ValueError(f"{what} is not affine over the tiles of a block "
                         f"of {per_cta}: the register epilogues cannot run it")
    return imgs


def position_images(row, lane, base, t: int, rpt: int, per_cta: int,
                    what: str) -> list:
    """Images of the B block-position bits (columns, rows, tile in block)
    under a table split into row, lane and per-tile parts."""
    return (linear_images(lane, t, what + " lane table")
            + linear_images(row, _log2(rpt), what + " row table")
            + block_images(base, per_cta, what + " tile table"))


def _lin(q: int, imgs: list) -> int:
    out = 0
    for b, im in enumerate(imgs):
        if (q >> b) & 1:
            out ^= im
    return out


@functools.lru_cache(maxsize=4096)
def _wavefronts(lanes: tuple, t: int, stride_bytes: int, elem_bytes: int,
                access: int) -> int:
    """Shared-memory wavefronts of one warp-wide load: lane l reads
    ``access`` bytes of tile position XOR(lanes[k] for the bits k of l)
    (row stride and element size in bytes); the most distinct 4-byte words
    any bank serves."""
    q = _affine_table(list(lanes))
    a = (q >> t) * stride_bytes + (q & ((1 << t) - 1)) * elem_bytes
    words = np.unique((a[:, None] // 4 + np.arange(-(-access // 4)))
                      .reshape(-1))
    return int(np.bincount(words % 32).max())


def regs_for(B: int, dv: int, bwd: bool, maps: bool = False) -> int:
    """Register bits of a block of 2^B positions: 4 (16 positions a
    thread), or 3 where 16 would leave threads idle (B <= 11) or hold too
    many registers (the planar pairs of a butterfly cluster, and K5's
    compare bits beside its values: K5 is compiled for 8 only; the
    kernels with map epilogues are compiled for 8 only, too)."""
    return 3 if B <= 11 or dv == 2 or bwd or maps else 4


def _split_phases(vs: list, is_cmp: list, cap: int) -> list:
    """(first, end, independent XORs) of each phase: the longest runs whose
    XORs span at most ``cap`` dimensions, broken before every
    CMP_GROUP-th compare (K5 keeps one group's bits per register)."""
    phases, e, ci = [], 0, 0
    while e < len(vs):
        span, e2, cmps = [], e, 0
        while e2 < len(vs):
            if is_cmp[e2] and cmps and (ci + cmps) % CMP_GROUP == 0:
                break
            new = not in_span(vs[e2], span)
            if new and len(span) == cap:
                break
            if new:
                span.append(vs[e2])
            cmps += is_cmp[e2]
            e2 += 1
        phases.append((e, e2, span))
        ci += cmps
        e = e2
    return phases


@functools.lru_cache(maxsize=4096)
def _layout(span: tuple, vs: tuple, B: int, reg_bits: int, smem: tuple):
    """(reg, lane, warp, outer) slot images of one phase; ``smem`` the
    (t, stride_bytes, elem_bytes, access) of :func:`_wavefronts`. Kept:
    the clusters of one program repeat their phases."""
    cap = min(B, reg_bits + LANE_BITS)
    inside = list(span)
    for b in range(B):
        if len(inside) == cap:
            break
        if not in_span(1 << b, inside):
            inside.append(1 << b)
    excluded = [1 << b for b in range(B)
                if not in_span(1 << b, inside)]
    rest = []
    for u in excluded:                      # complete to a basis
        if not in_span(u, inside + rest):
            rest.append(u)
    n_lane = min(LANE_BITS, cap)
    best = None
    for lane_idx in itertools.combinations(range(cap), n_lane):
        lanes = [inside[k] for k in lane_idx]
        regs = [inside[k] for k in range(cap) if k not in lane_idx]
        coord = _coords(regs + lanes)
        shuffled = sum(1 for v in vs
                       if coord(v) >> len(regs))
        key = (_wavefronts(tuple(lanes), *smem), shuffled)
        if best is None or key < best[0]:
            best = (key, regs, lanes)
    _, regs, lanes = best
    return tuple(regs), tuple(lanes), tuple(rest[:WARP_BITS]), tuple(
        rest[WARP_BITS:])


def map_checkpoints(phase_of: list, map_slots: Optional[int]) -> tuple:
    """(slot, from) of each map, its phase ``phase_of[i]`` (maps in
    order), when K5 may keep ``map_slots`` sets of map inputs (None: as
    many as there are maps). Each map keeps a slot while they last;
    otherwise the first map of each phase keeps one, then the maps
    after them in order, and each other map takes the spare slot (the
    last) and ``from`` the nearest map before it in its phase that keeps
    one (-1 for a map that keeps its own). Raises when the phases that
    hold maps outnumber the slots but the spare."""
    n = len(phase_of)
    if map_slots is None or n <= map_slots:
        return list(range(n)), [-1] * n
    keep = map_slots - 1
    firsts = [i for i in range(n) if i == 0 or phase_of[i] != phase_of[i - 1]]
    if keep < len(firsts):
        raise ValueError(f"K5 keeps the inputs of {map_slots} maps in shared "
                         f"memory; {len(firsts)} phases hold maps and each "
                         f"needs one, besides the spare")
    saved = set(firsts)
    for i in range(n):
        if len(saved) == keep:
            break
        saved.add(i)
    slot, frm, last, k = [], [], -1, 0
    for i in range(n):
        if i in saved:
            slot.append(k)
            frm.append(-1)
            k += 1
            last = i
        else:
            slot.append(keep)
            frm.append(last)
    return slot, frm


def plan_epilogues(entries, geometry: tuple, per_cta: int, *,
                   elem_bytes: int, stride_bytes: int, access: int,
                   dv: int, reg_bits: int = 4,
                   map_slots: Optional[int] = None) -> tuple:
    """(plan, info) of a cluster's epilogues on blocks of ``per_cta``
    tiles: ``plan`` the int64 words of :mod:`tile_epilogue.cuh` (device
    pointer words 0), ``info`` a dict with ``n_phases``, ``outer_bits``,
    ``groups`` (of CMP_GROUP compares), ``maps``, ``map_slots`` (the sets
    of map inputs K5 keeps, :func:`map_checkpoints`), ``B``, ``reg_bits``
    and per-epilogue ``hmask`` and
    ``tw_pos`` (the twiddle image of each position bit, bfly only).

    ``entries`` are the wrappers' epilogue entries (kind, vr, vc, hi_row,
    hi_lane, hi_base, tw_row, tw_lane, tw_base, w), a map's (2, 0, 0,
    six None, its :class:`.map_lower.Tape`); ``elem_bytes`` and
    ``stride_bytes`` the tile's element and padded row sizes in shared
    memory, ``access`` the bytes one register load reads, ``dv`` the tail
    values a register slot holds (2 for planar butterflies, else 1),
    ``reg_bits`` the register slots (a thread holds 2^reg_bits
    positions)."""
    n, t, rpt, _, _, n_tiles, _ = geometry
    if n_tiles % per_cta:
        raise ValueError(f"{n_tiles} tiles do not split into blocks of "
                         f"{per_cta}")
    B = t + _log2(rpt) + _log2(per_cta)
    outer_bits = max(0, B - reg_bits - LANE_BITS - WARP_BITS)
    if outer_bits > MAX_OUTER:
        raise ValueError(f"a block of 2^{B} positions exceeds the "
                         f"register epilogues' 2^{12 + MAX_OUTER}")

    vs, is_cmp, hmasks, tw_pos = [], [], [], []
    for e in entries:
        kind, vr, vc = e[0], int(e[1]), int(e[2])
        vs.append((vr << t) | vc)
        is_cmp.append(kind == KIND_CMP)
        if kind == KIND_MAP:
            if not e[9].lowered:
                raise ValueError(f"map {e[9].name!r} is not lowered: the "
                                 f"register epilogues cannot run it")
            hmasks.append(0)
            tw_pos.append(None)
            continue
        for name, tab in (("hi_row", e[3]), ("hi_lane", e[4]),
                          ("hi_base", e[5])):
            a = np.asarray(tab)
            if a.size and (a.min() < 0 or a.max() > 1):
                raise ValueError(f"{name} holds values other than 0 and 1")
        himg = position_images(e[3], e[4], e[5], t, rpt, per_cta, "hi")
        hmasks.append(sum(1 << b for b, im in enumerate(himg) if im))
        tw_pos.append(position_images(e[6], e[7], e[8], t, rpt, per_cta,
                                      "twiddle") if kind == 1 else None)
    cap = min(B, reg_bits + LANE_BITS)
    phases = _split_phases(vs, is_cmp, cap)
    n_cmp = sum(is_cmp)
    maps = [e for e in range(len(entries)) if entries[e][0] == KIND_MAP]
    phase_at = {e: p for p, (e0, e1, _) in enumerate(phases)
                for e in range(e0, e1)}
    slot, frm = map_checkpoints([phase_at[e] for e in maps], map_slots)
    tapes, tape_at = [], {}
    epi_end = HDR_WORDS + PHASE_WORDS * len(phases) + EPI_WORDS * len(
        entries)
    for e in maps:
        tw = tuple(tape_words(entries[e][9]))
        if tw not in tape_at:
            tape_at[tw] = epi_end + sum(map(len, tapes))
            tapes.append(tw)
    words = np.zeros(epi_end + sum(map(len, tapes)), dtype=np.int64)
    words[:HDR_WORDS] = (len(phases), len(entries), outer_bits, reg_bits)
    words[epi_end:] = [w for tw in tapes for w in tw]
    ci = n_maps = 0
    for p, (e0, e1, span) in enumerate(phases):
        regs, lanes, warps, outer = map(list, _layout(
            tuple(span), tuple(vs[e0:e1]), B, reg_bits,
            (t, stride_bytes, elem_bytes, access * dv)))
        thr = lanes + [0] * (LANE_BITS - len(lanes)) + warps
        ph = words[HDR_WORDS + p * PHASE_WORDS:][:PHASE_WORDS]
        ph[PH_E0], ph[PH_E1] = e0, e1
        ph[PH_REG_VALID] = (1 << (1 << len(regs))) - 1
        invalid = ((1 << LANE_BITS) - 1) & ~((1 << len(lanes)) - 1)
        invalid |= (((1 << WARP_BITS) - 1) & ~((1 << len(warps)) - 1)) \
            << LANE_BITS
        ph[PH_TID_INVALID] = invalid
        ph[PH_IMG_REG:PH_IMG_REG + len(regs)] = regs
        ph[PH_IMG_THR:PH_IMG_THR + len(thr)] = thr
        ph[PH_IMG_OUT:PH_IMG_OUT + len(outer)] = outer
        cmps = [ci + k for k in range(sum(is_cmp[e0:e1]))]
        ph[PH_GROUP] = cmps[0] // CMP_GROUP if cmps else -1
        ph[PH_FIRST] = int(any(c % CMP_GROUP == 0 for c in cmps))
        ph[PH_MAPS] = sum(entries[e][0] == KIND_MAP for e in range(e0, e1))
        coord = _coords(regs + lanes + warps + outer)
        for e in range(e0, e1):
            ep = words[HDR_WORDS + PHASE_WORDS * len(phases)
                       + e * EPI_WORDS:][:EPI_WORDS]
            if entries[e][0] == KIND_MAP:
                ep[EP_KIND] = KIND_MAP
                ep[EP_MAP_LEN] = len(entries[e][9].ops)
                ep[EP_MAP_SLOT] = slot[n_maps]
                ep[EP_MAP_FROM] = (-1 if frm[n_maps] < 0
                                   else maps[frm[n_maps]])
                ep[EP_MAP_TAPE] = tape_at[tuple(tape_words(entries[e][9]))]
                tape = entries[e][9]
                ep[EP_MAP_TYPED] = 2 if tape.mixed else int(tape.typed)
                n_maps += 1
                continue
            c = coord(vs[e])
            if c is None or c >> (len(regs) + len(lanes)):
                raise AssertionError("phase layout misses a partner XOR")
            m = hmasks[e]
            ep[EP_KIND] = KIND_CMP if is_cmp[e] else KIND_BFLY
            ep[EP_VREG] = c & ((1 << len(regs)) - 1)
            ep[EP_VLANE] = c >> len(regs)
            ep[EP_HREG] = sum(parity(_lin(i, regs) & m) << i
                              for i in range(1 << reg_bits))
            ep[EP_HMASK] = m
            if is_cmp[e]:
                ep[EP_SHIFT] = 2 * (ci % CMP_GROUP)
                ci += 1
            else:
                tp = tw_pos[e]
                ep[EP_TW_REG:EP_TW_REG + len(regs)] = [_lin(q, tp)
                                                       for q in regs]
                ep[EP_TW_THR:EP_TW_THR + len(thr)] = [_lin(q, tp)
                                                      for q in thr]
                ep[EP_TW_OUT:EP_TW_OUT + len(outer)] = [_lin(q, tp)
                                                        for q in outer]
    info = {"n_phases": len(phases), "outer_bits": outer_bits,
            "groups": -(-n_cmp // CMP_GROUP), "maps": n_maps,
            "map_slots": max(slot, default=-1) + 1,
            "hmask": hmasks,
            "tw_pos": tw_pos, "B": B, "reg_bits": reg_bits}
    return words, info


def phase_slice(words: np.ndarray, p: int) -> np.ndarray:
    return words[HDR_WORDS + p * PHASE_WORDS:][:PHASE_WORDS]


def epi_slice(words: np.ndarray, e: int) -> np.ndarray:
    n_phases = int(words[0])
    return words[HDR_WORDS + PHASE_WORDS * n_phases + e * EPI_WORDS:][
        :EPI_WORDS]


def spill_sids(info: dict) -> Optional[int]:
    """Mask-register sets K5 keeps in shared memory: one per compare group
    and chunk when there are more than two, else 0 (one set, or two, the
    second waiting in registers)."""
    n = info["groups"] * (1 << info["outer_bits"])
    return n if n > 2 else 0
