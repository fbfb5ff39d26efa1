#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # the full run, one card
    python3 chip_smoke.py --n 22 --n-sort 20 --n-fft 18   # a quick check

Phases (each fails loudly; a failure exits non-zero and prints no result):

1. environment: Python, torch and CUDA versions, ``nvcc --version`` and
   the card's name and power limit from ``nvidia-smi``;
2. build: every CUDA kernel compiled from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once), with seconds and ptxas usage,
   and beside them K4a as it was before its redesign
   (``tools/k4a_sweep.cu``), the A/B reference of phases 4 and 15, and
   K4b, K5 and the guarded K4b before their work-item schedules
   (``tools/fused_ab.cu``), that of phases 6, 9 and 11;
3. kernel vs plain: each permutation kernel (copy, block, lane, tile)
   held bit for bit against its plain PyTorch version on the card, at a
   small size (int32, bfloat16, float32 with a d = 8 tail, a batch of 3,
   a ragged copy, uint8 views at byte offsets 0-15) and at 2^n int32;
   K4a's two schedules forced on each small case (the narrow one in each
   tile layout of the paper's §4.2 study, and the wide one), and the wide
   schedule where the wrapper takes it (bfloat16 elements of 256 bytes),
   each bit for bit against the plain version;
   the 2^n case is timed with CUDA events in turns with one PyTorch
   library call, and beside the plain version; the copy also at 2^n - 1
   int32 and on a view at a 4-byte offset, each in turns with
   ``x.clone()``, and through its bulk-copy ring (on request; ragged and
   at 2^n, bit for bit); every copy prints the path its launch counted
   (words or bulk);
4. main path: ``repro_torch.kernels.ops.bmmc_permute`` on 2^n int32 for
   one BMMC of each dispatch case (bit-reverse, random BPC, random BMMC,
   block class, lane class, mixed complement), each bit-equal to the
   device-side plain gather, with host planning seconds, the median
   CUDA-event time (in turns with the copy kernel and, for a one-pass
   tiled case, with the K4a its redesign replaced, also bit-equal),
   effective GB/s, the ratio to the copy kernel (and the old K4a's), the
   byte bound and ``torch.index_select`` on a precomputed index;
5. tile-size sweep: the tiled cases at t = 5, 6 and 7, each beside the
   copy kernel (the record behind ``ops.choose_tile``'s t = 6 for int32),
   and at t = 6 K4a's narrow schedule in each tile layout of the paper's
   §4.2 study (unpadded, padded, swizzled), in turns with the copy;
6. K4b vs plain: the fused tiled pass (``tile_fused``) bit for bit
   against its plain version on sort clusters of 1, 2 and 3
   compare-exchange epilogues (int32, float32 and bfloat16 with NaNs and
   signed zeros, a d = 3 tail, a batch of 3) and on an FFT cluster of
   butterflies (planar float32) at a small size and at the FFT's 2^22
   points; hand-built clusters with map epilogues (a map between two
   compares, at a phase boundary, one that makes NaNs mid-phase, a
   bfloat16 chain of three ops, bfloat16 tanh, exp, sigmoid and a division
   by a number, an int32 wrap, B = 3 with d = 3, float32 tanh and log, on
   continuous inputs: bit for bit), each timed (one call, device);
   then the largest cluster of the 2^24 sort, bit for bit, timed
   beside its plain version, the same pass without epilogues, the copy
   kernel and the torch composite of the cluster;
7. combinator path: ``repro_torch.combinators.sort`` of 2^24 int32 keys
   (bit-equal to ``torch.sort``, its CUDA graph too) and ``fft_planar``
   of 2^22 points
   (within ``FFT_REL_TOL`` of ``torch.fft.fft`` in float64), each with
   its cold host planning seconds, ``program_cost`` round trips equal to
   the cold call's counted ``model.round_trips``, no fused fallback, and
   the CUDA-graph call, the eager per-stage call and the library call
   timed; the descending sort ``emap(not) >> sort >> emap(not)`` of the
   same keys (its maps inside K4b; bit-equal to ``torch.sort(...,
   descending=True)``, round trips equal to ``program_cost``, no fused
   fallback), timed beside the Map-free sort and the library;
   ``fft`` of the same points as complex64, bit-equal to the
   planar FFT through the same kernels;
8. launch counts: every permutation kernel launched on the main path
   (phase 4) and ``tile_fused`` on the combinator path (phase 7);
9. K5 vs plain: the gradient kernel (``tile_bwd``) bit for bit against
   its plain version on sort clusters of 1, 2 and 3 compare epilogues
   (float32 with ties, NaNs and signed zeros, bfloat16 with canonical
   NaNs, a d = 3 tail, a batch of 3), on the FFT's butterfly cluster at
   2^n_fft points and on the largest cluster of the 2^n_sort float32 sort
   with keys drawn from 2^16 values (ties); phase 6's map clusters
   (gradients bit for bit); the last
   timed beside its byte bound, its plain version and the torch composite
   (autograd's backward through the cluster's stages as torch ops);
10. gradients on the main path, ``loss = (w * f(x)).sum()``: the sort of
   2^n_sort distinct float32 keys (equal to scattering ``w`` to the
   sorting permutation, bit for bit), the gradient kernel route against
   the collapsed route at 2^n_ties keys with ties (bit for bit), the FFT
   of 2^n_fft planar points (within ``FFT_REL_TOL`` of float64
   ``torch.fft.fft`` under autograd) and a permutation chain at 2^n_perm
   float32 (equal to the inverse program applied to ``w``, bit for bit);
   ``emap(tanh) >> sort`` of 2^n_sort float32 keys (its map inside K4b
   and K5; within MAP_GRAD_TOL of ``torch.sort(torch.tanh(x))`` under
   autograd, tied keys by their sums); each cold backward counts
   ``model.vjp_round_trips`` equal to
   ``vjp_round_trips(n, t)``, K5 launches equal to the compute clusters
   and no fused fallback; forward and forward + backward timed beside the
   library call under autograd, and the peak device memory; then
   ``tile_bwd``'s launches on this path, and one JSON line describing
   every kernel (``ms`` the median time of one call, CUDA events around
   the Python call; ``device_ms`` for K4b and K5 the device time of one
   call, 10 calls captured in one CUDA graph and replayed, null for the
   others);
11. guarded main path: phase 4's six BMMCs and the 2^n_sort int32 sort
   with ``guard.enable()``, each bit-equal to its unguarded call, with no
   trap, no fallback and the breaker board closed, counting the launches
   of the guarded variants (``block_guarded``, ``lane_guarded``,
   ``tile_guarded``, ``tile_fused_guarded``; no unguarded kernel runs
   under the guard); ring 1's host seconds (validation with
   fingerprints) per 2^n plan; each call guarded and unguarded in turns;
   each guarded variant bit for bit against its unguarded kernel and its
   guarded plain version, timed in turns with the unguarded kernel (one
   call and device time), the guarded K4b (largest 2^n_sort sort
   cluster) also with the guarded K4b before its work-item schedule
   (``tools/fused_ab.cu``);
12. traps on the card at 2^24: each table of each guarded variant (K4b:
   of a sort cluster's pass) poisoned on the card (2^30 and -1) sets bit
   1 as the guarded plain version does, outputs bit-equal where defined,
   and the next unguarded launch succeeds; guarded
   ``bmmc_permute`` with a poisoned plan (host table, then the card's
   copy only) and a guarded sort with a poisoned K4b table fall back to
   ``ref`` and equal the oracle; a poisoned ref table raises
   ``GuardTrap`` and the process keeps launching;
13. store warm start: a fresh process (this script with
   ``--store-child``) populates a plan store in a temporary root with
   four of phase 4's 2^n BMMCs (``STORE_CASES``: one of each class; the
   random BPC and the mixed complement, tiled like the bit reversal, are
   left to phases 4 and 11), the 2^n_sort sort and its float32 gradient;
   a second
   replays them with zero plans built, only hits, and outputs equal to
   the first's (64-bit checksums on the card); first-call latency cold,
   disk-warm and warm, and the store's bytes; then the disk-fault
   matrix (every case caught);
14. ring 3 and the soak: ``guard.inject.run_fault_matrix("cuda")`` at
   2^14 (every kind caught, none silently wrong) and
   ``resilience.chaos.run_matrix()`` on the card (every SLO met);
15. serving: ``mistral-nemo-12b`` at full width and depth (40 layers,
   bfloat16, weights from a seed, built on the card) through the port's
   serve loop (``repro_torch.launch.serve.serve``), batch 4, prompt 512,
   32 new tokens. First K4a at the three shapes the kv-head shuffle gives
   it (k and v, the q groups, the float32 output; t = 1; its wide
   schedule), each bit for bit against its plain version, the plain
   gather, ``permute_axis`` and the old K4a, timed in turns with
   ``index_select`` and the old K4a (one call through ``tiled_permute``
   and through ``permute_axis``, and device time) beside its byte bound.
   Then the shuffle on ``cuda``
   with the launch counts set to 0 just before: K4a launched 4 times in
   each of the 40 prefill layers and no other kernel; the shuffle on
   ``ref`` and off, in turns: prefill logits bit-equal across the three
   (shuffle off within ``SHUFFLE_OFF_REL_TOL`` if the card's products are
   not) and greedy tokens equal; prefill ms, warm decode ms per token and
   tokens per second of each run; prefills alone with the shuffle on
   ``cuda`` and off, in turns (the shuffle's share of a prefill); one
   decode step against a prefill over
   the extended sequence (within ``DECODE_REL_TOL``); a ``--validate``
   run (guarded K4a launches, zero traps, equal output); the peak device
   memory; the decode step against the prefill again in float32 at full
   width and depth (within ``DECODE_F32_REL_TOL``); the
   port's SIGTERM drain drill on the card
   (``resilience.chaos.sigterm_drill``);
16. training: ``mistral-nemo-12b`` at full width, cut to 4 of its 40
   layers (bf16 weights, float32 AdamW moments, remat ``nothing``; from a
   seed on the card), through the port's training loop
   (``repro_torch.launch.train.train``) for 10 steps of batch 4 x seq 512
   from ``data.pipeline.ShardedLoader`` with the kv-head shuffle on
   ``cuda``: loss, grad_norm, ms and tokens/s a step, peak memory, K4a
   launched 12 times a layer a step (forward, remat recompute, VJPs) and
   no other kernel, every parameter moved, then 5 steps on one batch
   lower its loss. One step from the same start with the shuffle on
   ``cuda`` and ``ref`` (bit-equal loss, grad_norm and parameters) and
   off (loss bit-equal, else within ``SHUFFLE_OFF_REL_TOL``), timed in
   turns; loss and gradients with remat on and off (bit-equal; 12 and 8
   shuffles a layer, by ``obs.kernel_counts`` and by launch); a step with
   8-bit moments; the guarded step (``validate=True``: guarded K4a, no
   trap, the unguarded loss) and ``GuardTrap`` on a nonfinite loss before
   the update; a ``PermuteLayer(sort_expr(20))`` in a loss override (K4b
   forward, K5 backward), bit-equal to the same step on ``ref``, timed;
   the ``100m`` profile checkpointed by ``launch.train.main``, restored bit
   for bit, and resumed in a fresh call whose losses equal an
   uninterrupted run's. The kernels line gains ``train_launches``: K4a on
   the full-width steps under ``tile_serve``, the sort layer's K4a, K4b
   and K5 under ``tile``, ``tile_fused`` and ``tile_bwd``, the guarded
   step's under ``tile_guarded``;
17. the non-dense block kinds (``KINDS_CELLS``), one configuration after
   another at full width, the card freed between them, weights from a
   seed: ``mamba2-130m`` (24 Mamba-2 layers), ``recurrentgemma-2b`` (26
   RG-LRU and local-attention layers), ``phi3.5-moe-42b-a6.6b`` (16 of 32
   MoE layers served, 2 trained), ``kimi-k2-1t-a32b`` (the dense prefix and
   1 MoE layer of 384 experts; served only), ``llama-3.2-vision-90b`` (one
   period: 4 dense + 1 cross-attention layer over 6400 patch embeddings;
   trained with 8-bit moments) and ``seamless-m4t-medium`` (12 encoder +
   12 decoder layers over 4096 frames). Each serves through
   ``launch.serve.serve`` (the serving cell's traffic; source embeddings
   from ``make_src``) with the kv-head shuffle on ``cuda`` where it has
   power-of-two kv heads: K4a launched 4 times in every self-attention
   layer of the prefill and no other kernel, logits and ids bit-equal
   with the shuffle off; an MoE configuration's two prefills bit-equal
   (the deterministic combine); a decode step within ``DECODE_REL_TOL`` of
   a prefill of one more token (MoE configurations with a capacity that
   drops nothing). Then ``KINDS_STEPS`` train steps on one batch of 4 x
   512 through ``train.step.make_train_step``: the loss falls (with 8-bit
   moments only the first update is held: a second moment that
   dequantizes to 0 makes the next update divide the first moment by the
   new, smaller gradient alone, and the later losses are printed), K4a
   launched 12 times a shuffled layer a step (8 outside the remat
   groups), the first step bit-equal with the shuffle on ``ref``.
   Prefill ms, warm decode ms a token, ms a step, tokens/s and peak GiB,
   each beside the card's name and power limit. The kernels line gains
   ``kinds_launches`` (K4a in phase 17's prefills) and
   ``kinds_train_launches`` (in one step of each trained configuration),
   under ``tile_serve``;
18. the mesh: a (1, 1) mesh of one single-rank NCCL group
   (``launch.mesh.make_dev_mesh(1, 1, device="cuda")``, destroyed at the
   end). ``models.moe_a2a.moe_ffn_a2a`` at phi's layer width (E 4096, F
   6400, 16 experts top 2, bf16, T = 4 x 512, weights from a seed) with
   the slot shuffle on ``cuda``, on ``ref`` and off at the same
   power-of-two capacity: outputs and aux bit-equal, K4a launched 2 times
   a forward and 2 more a backward and no other kernel (by launch and by
   ``obs``), forward and backward on ``cuda`` and ``ref`` bit-equal; K4a
   at the shuffle's ``(1, 8192, 4096)`` bf16 bit for bit against its
   plain version and the gather, timed in turns with ``index_select``
   (one call and device time) beside its byte bound.
   ``phi3.5-moe-42b-a6.6b`` at 16 of 32 layers served with ``mesh=``
   through ``model.prefill`` / ``decode_step``: the a2a branch in every
   MoE layer (``obs`` counter ``model.moe_a2a``), K4a 4 times in every
   self-attention layer, two mesh prefills bit-equal, logits within
   ``A2A_REL_TOL`` of the same prefill with no mesh, a mesh decode step
   against a longer mesh prefill (rows routed alike, at a capacity that
   drops nothing); ``kimi-k2-1t-a32b`` (the dense prefix + 1 MoE layer)
   served the same way; phi at 2 layers trained 3 steps on one batch of
   4 x 512 through ``train.step.make_train_step(cfg, mesh)`` (the loss
   falls, the first step bit-equal across two runs, its loss within
   ``A2A_REL_TOL`` of the step with no mesh). Prefill ms, decode ms a
   token and ms a step with the mesh and without, in turns, peak GiB,
   each beside the card's name and power limit. The kernels line gains
   ``mesh_launches``: K4a in phase 18 under ``tile_serve``;
19. the dry run (``repro_torch.launch.dryrun``, ``launch.op_analysis``):
   three cells each traced first on fake tensors (a fake one-rank world
   for the mesh cell) and then run for real on the card under the same
   ``OpCounter``: ``mistral-nemo-12b`` at 40 layers (shuffle on ``cuda``;
   a prefill of 4 x 512 and one decode step), the same cut to 4 layers
   (one training step of 4 x 512), and phi at 16 layers prefilled on a
   (1, 1) mesh (a fake world, then phase 18's single-rank NCCL group
   made anew; the fake and the real group never overlap). Dot FLOPs,
   collective bytes by kind and kernel launches by name and schedule
   equal (K4a 160, 48 and 64, as phases 15, 16 and 18 count; the real
   ones also by ``launch_counts``), the dry run's peak of live storages
   within ``DRY_PEAK_REL`` of the peak plus ``DRY_PEAK_ABS`` of the card's
   ``max_memory_allocated``; then ``mistral-nemo-12b`` ``decode_32k`` on a
   fake 256-rank world (``pod16x16``): seconds, dot FLOPs per rank, held
   bytes against the specs' and ``fits_hbm``. Under 60 s. The kernels
   line gains ``dryrun_launches`` (K4a in phase 19's real runs, under
   ``tile_serve``);
20. element types (``NEW_TYPES``: float16, int8, uint8, int16, uint16,
   uint32, bool; ``WIDE_TYPES``: int64, uint64, float64), each path with
   the launch counts set to 0 just before and read just after: the sort of
   2^n_sort keys of each type through ``compiled_sort`` (no fused
   fallback, round trips equal to ``program_cost``, K4b launched once a
   compute cluster; bit-equal to ``torch.sort`` where torch sorts the
   type, else sorted and the same keys; graph and stage-by-stage one
   call), then the same sort guarded (``guard.guarded()``: the guarded K4b
   once a cluster, the unguarded output); the float16 and float64 sort
   gradients (K5 once a cluster, the gradient ``w`` scattered to the
   sorting permutation where the keys are distinct, the K5 route equal to
   the collapsed route on keys with ties); the FFT of 2^n_fft points on
   float16, bfloat16 and float64 planar input (within ``log2(N)`` unit
   roundoffs of the float64 library FFT, norm-wise; ``torch.fft.fft`` of
   the whole transform timed beside it) and its gradient; the float32 FFT
   with a map (``v * 2 - 1``) beside the butterflies of one cluster,
   forward and gradient. For each, the largest cluster's K4b, guarded K4b
   (the sorts and FFTs) and K5 bit for bit against their plain versions
   (the guarded one with no flag), timed (one call, device time, plain
   version, the torch composite of the cluster: its forward, or for K5 its
   backward under autograd) beside the byte bound, each a row of the
   kernels line (``tile_fused[int8]``, ..., ``tile_bwd[float64]``). Last,
   a ``sin`` map's cluster on keys up to 300 in magnitude against an
   exact map, and the map kernel's stack frame;
21. the example twins (``EXAMPLE_TWINS``): each ``examples/*_torch.py``
   run as a subprocess with ``--device cuda`` and ``PYTHONPATH=src`` at its
   default size, then the sort, the FFT and the gradient twins again at
   the card's sizes (``--n`` of 2^n_sort keys, 2^n_fft points, 2^n_ties
   elements), ``TWIN_WORKERS`` twins at a time, the longest first: the
   user-facing paths of the port (``bmmc_permute`` by
   class, the fused sort and FFT, the compiled backward and
   ``PermuteLayer``, ``distributed_bmmc`` on one NCCL rank, the serving
   launcher's cold and disk-warm boots, the training launcher's stop and
   resume); a twin that exits non-zero fails the run. One line a twin,
   in the order above: exit code, wall seconds (beside the twins that ran
   with it) and the kernel launches it reports (K4b, K5
   and every other kernel it launched); each twin's own output, times in
   ms of CUDA events, follows it. The kernels line gains
   ``examples_launches`` on the rows of phase 3's kernels (summed over
   the twins' runs; for ``tile_serve`` the serving twin's K4a launches);
   the element-type rows of phase 20 have none, since a twin counts its
   launches by kernel and not by element type;
22. maps beyond the chain (``map_dag_cases``): each new aten op of the
   tape, a DAG map (gelu-tanh written out), a ``where`` map (leaky ReLU)
   and a 32-op tape, one map in the largest 2^n_sort sort cluster (the
   2^(n_sort - 2) one past a case's first type; a hand-built pass; exact
   maps mid-cluster, transcendental ones last), on
   float32, bfloat16, float16, float64 and int32 where torch defines the
   op: K4b and K5 held against their plain versions (eager torch and
   autograd on the card) bit for bit, the transcendental ops within
   ``MAP_DAG_ULPS``, each case timed on its first type (one call,
   device); clusters of 6 and 12
   maps on float32 and float64 (K5 one launch, keeping the inputs of the
   maps that fit its shared memory and recomputing the others'); then,
   the launch counts set to 0 just before each: ``emap(leaky) >> sort``
   of 2^n_sort float32 and bfloat16 keys and its gradient (bit-equal to
   ``torch.sort`` and, float32 on distinct keys, to autograd through it;
   the K5 route against the collapsed route at 2^n_ties), a sort with a
   map after each of its last 12 compares (float32; at 2^n_ties bit-equal
   to the same program on the ``ref`` engine), the 2^n_fft FFT with a DAG
   map beside its butterflies; ``dispatch.fused_fallback`` 0 throughout.
   Typed tapes (``map_typed_cases``): each cast inside a map and each op
   the DAG tapes left out (tests of a value, ops between two values, the
   rest of PyTorch's activations and transcendentals) in the same
   cluster, on the types it takes (the four floats, int32, int8, int64,
   int16, uint8), K4b and K5 bit for bit against eager torch and autograd
   on the card; ``emap(torch.tanh(v.float()).to(v.dtype)) >> sort`` of
   2^n_sort bfloat16 keys and its gradient with no fused fallback (the
   gradient at 2^12 keys of distinct mapped values bit-equal to autograd
   through ``torch.sort``, at 2^n_ties keys with ties the K5 route
   bit-equal to the collapsed route). The
   kernels line gains ``tile_fused[dag maps]``, ``tile_bwd[dag maps]``,
   the 12-map clusters' rows and ``tile_fused[typed maps]``,
   ``tile_bwd[typed maps]`` (the cast-tanh sort's map cluster);
   22b. typed maps beside butterflies (``planar_typed_maps``: a cast
   around tanh, a word-path cast through int32, an exact cast around an
   affine map): ``emap(m) >> fft`` on 2^n_fft planar float32, bfloat16,
   float16 and float64 points and its gradient, the launch counts set to
   0 just before each: no fused fallback, the counted K5 passes equal to
   ``vjp_round_trips(n, t, dtype)``, a typed tape's cluster one launch of
   the planar ext map kernels each way, the program bit-equal to the
   same program on the ``ref`` engine (eager torch) and its gradient to
   autograd through it; the map cluster's K4b and K5 bit for bit against
   their plain versions and timed (on the cast-tanh map beside the plain
   versions and the cluster's torch composite); rows ``tile_fused[typed
   maps, planar]``, ``tile_bwd[typed maps, planar]`` (the bfloat16
   cast-tanh cluster);
23. last line: ``{"ok": true, "device": {...}}``.

It imports only torch, numpy and ``repro_torch``; the kernels build into
``build/kernels`` of this checkout.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "src"))
sys.path.insert(0, str(HERE / "tools"))

KERNEL_INFO = {   # name -> (source, the TPU kernel it replaces)
    "copy": ("src/repro_torch/kernels/csrc/copy.cu",
             "src/repro/kernels/bmmc_permute.py:859"),
    "block": ("src/repro_torch/kernels/csrc/block_permute.cu",
              "src/repro/kernels/bmmc_permute.py:724"),
    "lane": ("src/repro_torch/kernels/csrc/lane_permute.cu",
             "src/repro/kernels/bmmc_permute.py:811"),
    "tile": ("src/repro_torch/kernels/csrc/tile_permute.cu",
             "src/repro/kernels/bmmc_permute.py:72"),
    "tile_fused": ("src/repro_torch/kernels/csrc/tile_fused.cu",
                   "src/repro/kernels/bmmc_permute.py:181"),
    "tile_bwd": ("src/repro_torch/kernels/csrc/tile_bwd.cu",
                 "src/repro/kernels/bmmc_permute.py:265"),
    # the guarded variants (ring 2): instantiations of K2, K3, K4a, K4b
    "block_guarded": ("src/repro_torch/kernels/csrc/block_permute.cu",
                      "src/repro/kernels/bmmc_permute.py:724"),
    "lane_guarded": ("src/repro_torch/kernels/csrc/lane_permute.cu",
                     "src/repro/kernels/bmmc_permute.py:811"),
    "tile_guarded": ("src/repro_torch/kernels/csrc/tile_permute.cu",
                     "src/repro/kernels/bmmc_permute.py:72"),
    "tile_fused_guarded": ("src/repro_torch/kernels/csrc/tile_fused.cu",
                           "src/repro/kernels/bmmc_permute.py:181"),
    # K4a on the serving path (phase 15): the four kv-head shuffles of one
    # prefill layer; launches are those of one full-width prefill
    "tile_serve": ("src/repro_torch/kernels/csrc/tile_permute.cu",
                   "src/repro/kernels/bmmc_permute.py:72"),
}
PERM_KERNELS = ("copy", "block", "lane", "tile")   # the bmmc_permute path

N_SMALL = 14              # log2 elements of the small kernel-vs-plain cases
REPS = 10                 # timed runs per measurement (the median is kept)
TILE_SWEEP = (5, 6, 7)    # tile sizes of the sweep phase
N_SORT = 24               # log2 keys of the combinator path's sort (64 MiB)
N_FFT = 22                # log2 points of its FFT (32 MiB planar float32)
N_TIES = 20               # log2 keys of the K5-route vs collapsed-route check
# phase 13's BMMCs (of make_cases): one of each class
STORE_CASES = ("bit-reverse", "random-bmmc", "block-class", "lane-class")
N_PERM = 26               # log2 elements of the gradient's permutation chain
# Norm-wise relative error of the float32 FFT against float64: radix-2
# float32 rounding grows like eps * log2(N) (eps = 6e-8, 22 stages), so
# 1e-5 leaves about an order of magnitude of room.
FFT_REL_TOL = 1e-5

# The example twins of phase 21, run in this order at their default sizes
# (the serving and training twins at the smallest profile their reference
# offers: a smoke-sized model, the ``smoke`` training profile)
EXAMPLE_TWINS = ("quickstart_torch.py", "sorting_network_torch.py",
                 "fft_pipeline_torch.py", "grad_permute_torch.py",
                 "distributed_permute_torch.py", "serve_batch_torch.py",
                 "train_lm_torch.py")
EXAMPLE_TIMEOUT_S = 300   # seconds a twin may take before the run fails
# Twins run at once (each a process that spends most of its wall time
# starting up and planning on the host; 8 cores on the card's machine)
TWIN_WORKERS = 4

# Peak HBM bandwidth by card (NVIDIA data sheets); the byte bound of a
# kernel is the bytes it must move over this rate.
PEAK_BYTES_PER_S = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                    ("H100", 3.35e12), ("H200", 4.8e12))


_T0 = time.perf_counter()


def say(*a):
    """Print a line; a phase's heading with the run's seconds so far."""
    if a and str(a[0]).startswith("== phase"):
        a = (f"[{time.perf_counter() - _T0:.0f} s]",) + a
    print(*a, flush=True)


def check(ok, what="") -> None:
    """Fail the run when a phase does not hold (exit code 1, no result)."""
    if not ok:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def peak_bw(name: str) -> float:
    for key, bw in PEAK_BYTES_PER_S:
        if key in name:
            return bw
    raise SystemExit(f"no peak bandwidth known for {name!r}")


def run_cmd(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def in_turns(fns: dict, timer, rounds: int = 2) -> dict:
    """Each function's readings of ``timer(fn)`` (milliseconds), taken in
    turns: the labels in order, then reversed (A, B, B, A, ...), ``rounds``
    times each way, so that a kernel and its library call see the same
    clocks."""
    got = {k: [] for k in fns}
    order = list(fns)
    for r in range(2 * rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            got[k].append(timer(fns[k]))
    return got


def bits(torch, t):
    """An integer view of ``t`` for bitwise comparison (NaN payloads and
    -0.0 compare by their bits)."""
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.contiguous().view(view[t.element_size()])


def max_abs_err(torch, got, want) -> float:
    """Largest absolute difference of the two tensors' bit patterns as
    integers: 0 exactly when they are bitwise equal."""
    check(got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, want.shape, got.dtype, want.dtype))
    a, b = bits(torch, got), bits(torch, want)
    if torch.equal(a, b):
        return 0.0
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def make_cases(n: int, t: int):
    """One BMMC of each dispatch case at size 2^n and tile t."""
    from repro_torch.core.bmmc import Bmmc
    rng = random.Random(2306)
    ident = tuple(1 << i for i in range(n))
    k = min(11, n - 2)                      # block class: low k bits fixed
    while True:
        sub = Bmmc.random(n - k, rng)
        blk = Bmmc(ident[:k] + tuple(r << k for r in sub.rows), sub.c << k)
        if blk.bmmc_class(t) == "block":
            break
    while True:
        sub = Bmmc.random(t, rng)
        lane = Bmmc(tuple(sub.rows) + ident[t:], sub.c)
        if lane.bmmc_class(t) == "lane":
            break
    mixed = Bmmc.xor_shift(n, (rng.randrange(1, 1 << t))
                           | (rng.randrange(1, 1 << (n - t)) << t))
    return [("bit-reverse", Bmmc.bit_reverse(n), "tiled"),
            ("random-bpc", Bmmc.random_bpc(n, rng), "tiled"),
            ("random-bmmc", Bmmc.random(n, rng), "general"),
            ("block-class", blk, "block"),
            ("lane-class", lane, "lane"),
            ("mixed-complement", mixed, "tiled")]


def clocks() -> str:
    """SM clock, power draw and temperature, to read beside a timing."""
    return run_cmd(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
                    "temperature.gpu", "--format=csv,noheader"])


def phase_env(torch):
    say("== phase 1: environment ==")
    say(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    from repro_torch.kernels import build
    say(run_cmd([build.nvcc(), "--version"]).splitlines()[-1])
    smi = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).splitlines()
    say(f"devices: {torch.cuda.device_count()}  "
        f"torch name: {torch.cuda.get_device_name(0)}")
    return smi[0]


def ptxas_usage(log: str) -> list:
    """(kernel, "N registers, S bytes spill stores, L bytes spill loads")
    of each kernel in an ``nvcc -Xptxas -v`` log, names shortened to the
    template's arguments."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = ln.split("Function properties for")[-1].strip()
            spill = ""
        elif "spill stores" in ln:
            parts = [p.strip() for p in ln.split(",")]
            spill = ", ".join(p for p in parts if "spill" in p)
        elif "Used" in ln and name is not None:
            regs = ln.split("Used")[1].split(",")[0].strip()
            out.append((name[:60], f"{regs}, {spill or 'no spill'}"))
    return out


def phase_build():
    """Build every kernel, and beside them the K4a that the redesign
    replaced (``tools/k4a_sweep.cu``), the A/B reference of phases 4 and
    15, and the K4b, K5 and guarded K4b before their work-item schedules
    (``tools/fused_ab.cu``), the A/B reference of phases 6, 9 and 11.
    Returns the K4a library and (the A/B library, its ptxas log)."""
    say("== phase 2: build ==")
    from repro_torch.kernels import build
    import fused_ab
    import k4a_sweep
    t0 = time.perf_counter()
    old = k4a_sweep.start_build(build.build_dir().parent / "sweep")
    ab = fused_ab.start_build(build.build_dir().parent / "sweep")
    log = build.build_all()
    say(f"built {sorted(log)} in {time.perf_counter() - t0:.2f} s "
        f"(build dir {build.build_dir()})")
    for name, rec in sorted(log.items()):
        say(f"  {name}: {rec['seconds']:.2f} s")
        for kern, used in ptxas_usage(rec["ptxas"]):
            say(f"    {kern}: {used}")
    for name in build.KERNELS:
        build.load(name)
    so = k4a_sweep.finish_build(old)
    say(f"  the K4a before its redesign (tools/k4a_sweep.cu, A/B only): "
        f"built in {time.perf_counter() - t0:.2f} s")
    ab = fused_ab.finish_build(ab)
    say(f"  the K4b and K5 before their schedules (tools/fused_ab.cu, A/B "
        f"only): built in {time.perf_counter() - t0:.2f} s")
    for kern, used in ptxas_usage(ab[1]):
        if "old_kernel" in kern:
            say(f"    {kern}: {used}")
    return so, ab


def regs_of(log: str, fragment: str) -> str:
    """The ptxas usage of the one kernel whose (mangled) name holds
    ``fragment``, from an ``nvcc -Xptxas -v`` log."""
    got = [u for k, u in ptxas_usage(log) if fragment in k]
    check(len(got) == 1, ("ptxas usage", fragment, len(got)))
    return got[0]


# The instantiations the A/B of phases 6 and 9 times, by their mangled
# template arguments: (new, old) name fragments
AB_KERNELS = {
    "K4b int32": ("tile_fused_items_kernelIiLi1ELi16ELb0E",
                  "tile_fused_old_kernelIiLi1ELi16ELb0E"),
    "K4b float32": ("tile_fused_items_kernelIfLi1ELi16ELb0E",
                    "tile_fused_old_kernelIfLi1ELi16ELb0E"),
    "K5 float32": ("tile_bwd_kernelIfLi1ELi8ELb1ELb0E",
                   "tile_bwd_old_kernelIfLi1ELi8ELb1ELb0E"),
    "K5 bfloat16": ("tile_bwd_kernelI4Bf16Li1ELi8ELb1ELb0E",
                    "tile_bwd_old_kernelI4Bf16Li1ELi8ELb1ELb0E"),
}


def fused_ab_turns(torch, ab, fs, t, cases) -> dict:
    """Old and new K4b or K5 (``tools/fused_ab.py``) on one cluster: each
    bit for bit against the plain version, then timed in turns (old, new,
    new, old; one call and device time), printed with each side's
    registers and the new side's schedule. Returns {label: {"ms",
    "device_ms", "old_ms", "old_device_ms"}} (medians)."""
    import fused_ab
    from repro_torch.kernels import build
    so, ab_log = ab
    out = {}
    for label, x, ct in cases:
        old, new, plain, s = fused_ab.cluster_calls(so, fs, t, x, ct)
        want = plain()
        for side, fn in (("old", old), ("new", new)):
            err = max_abs_err(torch, fn(), want)
            check(err == 0.0, ("A/B", label, side, err))
        one = in_turns({"old": old, "new": new},
                       lambda f: cuda_ms(torch, f, REPS))
        dev = in_turns({"old": old, "new": new},
                       lambda f: device_ms(torch, f))
        kern = "tile_bwd" if ct is not None else "tile_fused"
        new_frag, old_frag = AB_KERNELS[label]
        new_regs = (regs_of(build.BUILD_LOG[kern]["ptxas"], new_frag)
                    if kern in build.BUILD_LOG else "not built here")
        med = {k: statistics.median(v) for k, v in (
            ("ms", one["new"]), ("old_ms", one["old"]),
            ("device_ms", dev["new"]), ("old_device_ms", dev["old"]))}
        say(f"  A/B {label}, in turns (old, new, new, old): one call old "
            f"{one['old']} new {one['new']} ms; device old {dev['old']} "
            f"new {dev['new']} ms; medians device old "
            f"{med['old_device_ms']:.4f} new {med['device_ms']:.4f} ms "
            f"({med['old_device_ms'] / med['device_ms']:.2f}x); registers "
            f"old {regs_of(ab_log, old_frag)}, new {new_regs}; schedule: "
            f"{fused_ab.schedule_text(s)}")
        out[label] = med
    return out


def k4a_schedules(torch, K, x, plan, batched, label):
    """K4a's two schedules (the narrow one in each tile layout of the §4.2
    study) forced on ``x``, each held bit for bit against K4a's plain
    version. Direct launches: they count in no launch count."""
    from k4a_sweep import forced
    want = K.tiled_permute_plain(x, plan, batched=batched)
    done = []
    for over in [{"schedule": "narrow", "layout": lay}
                 for lay in K.K4A_LAYOUTS] + [{"schedule": "wide"}]:
        fn, s = forced(torch, K, x, plan, batched=batched, **over)
        err = max_abs_err(torch, fn(), want)
        check(err == 0.0, ("K4a", label, s, err))
        done.append(f"{s.schedule} {s.layout}".strip())
    say(f"    K4a {label}: {', '.join(done)} bit-equal to the plain version")


def phase_kernels(torch, n_small: int, n: int, reps: int, bw: float):
    """Each kernel against its plain version; returns per-kernel records
    of the 2^n int32 case."""
    say("== phase 3: kernel vs plain ==")
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)

    def payload(shape, dtype):
        raw = torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                            device=dev, dtype=torch.int64)
        if dtype == torch.int32:
            return raw.to(torch.int32)
        if dtype == torch.bfloat16:
            return raw.to(torch.int16).view(torch.bfloat16)
        return raw.to(torch.int32).view(torch.float32)

    def plans(nn: int, t: int):
        cases = {name: b for name, b, _ in make_cases(nn, t)}
        got = {"block": ops.class_plan(cases["block-class"], t),
               "lane": ops.class_plan(cases["lane-class"], t),
               "tile": ops.class_plan(cases["bit-reverse"], t)}
        check([got[k][0] for k in ("block", "lane", "tile")] == [
            "block", "lane", "tiled"], {k: v[0] for k, v in got.items()})
        return {"block": got["block"][1], "lane": got["lane"][1],
                "tile": got["tile"][1][0]}

    pairs = {  # kernel -> (wrapper, plain version)
        "copy": (lambda x, plan, batched=False: K.copy_blocks(x),
                 lambda x, plan, batched=False: K.copy_plain(x)),
        "block": (K.block_permute, K.block_permute_plain),
        "lane": (K.lane_permute, K.lane_permute_plain),
        "tile": (K.tiled_permute, K.tiled_permute_plain)}

    def run(name, x, plan, batched=False):
        fn, plain = pairs[name]
        return fn(x, plan, batched=batched), plain(x, plan, batched=batched)

    worst = {k: 0.0 for k in PERM_KERNELS}
    configs = [("int32", torch.int32, (1 << n_small,), False),
               ("bfloat16", torch.bfloat16, (1 << n_small,), False),
               ("float32 d=8", torch.float32, (1 << n_small, 8), False),
               ("int32 B=3", torch.int32, (3, 1 << n_small), True)]
    for label, dtype, shape, batched in configs:
        d = shape[-1] if len(shape) == 2 and not batched else 1
        t = ops.choose_tile(n_small, torch.tensor([], dtype=dtype)
                            .element_size(), d)
        pl = plans(n_small, t)
        x = payload(shape, dtype)
        for name in PERM_KERNELS:
            got, want = run(name, x, pl.get(name), batched)
            err = max_abs_err(torch, got, want)
            check(err == 0.0, (name, label, err))
            worst[name] = max(worst[name], err)
        say(f"  n={n_small} {label} t={t}: copy, block, lane, tile bit-equal")
        k4a_schedules(torch, K, x, pl["tile"], batched, label)
    # K4a's wide schedule where the wrapper takes it: 256-byte elements
    xw = payload((3, 1 << 10, 128), torch.bfloat16)
    tw = ops.choose_tile(10, 2, 128)
    pw = ops.class_plan(make_cases(10, tw)[0][1], tw)[1][0]
    check(K.k4a_record(xw, pw, batched=True).schedule.schedule == "wide",
          "wide schedule")
    check(max_abs_err(torch, K.tiled_permute(xw, pw, batched=True),
                      K.tiled_permute_plain(xw, pw, batched=True)) == 0.0,
          "K4a wide")
    k4a_schedules(torch, K, xw, pw, True, "bfloat16 d=128 B=3")

    def copy_path(v, path=None):
        """K1 on ``v`` (on ``path`` if one is asked for) held bit for bit
        against its plain version; the path it took, read from the path
        counts of its one launch."""
        before = K.launch_counts()
        got = K._copy_cuda(v, path) if path else K.copy_blocks(v)
        want = K.copy_plain(v)
        err = max_abs_err(torch, got, want)
        check(err == 0.0, ("copy", tuple(v.shape), v.dtype, err))
        worst["copy"] = max(worst["copy"], err)
        after = K.launch_counts()
        took = [p for p in ("bulk", "words")
                if after[f"copy_{p}"] > before[f"copy_{p}"]]
        check(len(took) == 1 and after["copy"] == before["copy"] + 1, took)
        return took[0]

    ragged = payload((3 * 2048 + 37,), torch.int32)
    path = copy_path(ragged)
    say(f"  copy of {ragged.numel()} elements (ragged edge of "
        f"{K.copy_pad_elems(ragged.numel())} padding elements) bit-equal, "
        f"{path} path")
    check(copy_path(ragged, path="bulk") == "bulk", "bulk ring")
    base = ragged.view(torch.uint8)
    paths = {copy_path(base[off:off + 4 * 6000]) for off in range(16)}
    check(paths == {"words"}, paths)
    say(f"  copy of uint8 views at byte offsets 0-15 bit-equal, words "
        f"path; the bulk ring on the ragged copy bit-equal")

    t = ops.choose_tile(n, 4)
    pl = plans(n, t)
    x = payload((1 << n,), torch.int32)
    nbytes = x.numel() * 4
    records = {}
    timed = (lambda fn: cuda_ms(torch, fn, reps))
    case_of = {"block": "block-class", "lane": "lane-class",
               "tile": "bit-reverse", "copy": "identity"}
    for name in PERM_KERNELS:
        plan = pl.get(name)
        if name == "copy":
            path = copy_path(x)
        else:
            got, want = run(name, x, plan)
            err = max_abs_err(torch, got, want)
            check(err == 0.0, (name, n, err))
            worst[name] = max(worst[name], err)
            del got, want
        fn, pfn = pairs[name]
        kern, plain = (lambda: fn(x, plan)), (lambda: pfn(x, plan))
        if name == "copy":
            tab_bytes = 0
            lib = lambda: x.clone()
        else:
            tab_bytes = sum(a.numel() * 4 for a in K.device_tables(plan, dev))
            idx = ref.bmmc_src_index(plan.bmmc, dev)
            lib = lambda: torch.index_select(x, 0, idx)
        turns = in_turns({"kernel": kern, "library": lib}, timed)
        ms, lib_ms = (statistics.median(turns[k]) for k in ("kernel",
                                                            "library"))
        plain_ms = cuda_ms(torch, plain, max(3, reps // 3), warmup=1)
        idx = None
        bound_ms = (2 * nbytes + tab_bytes) / bw * 1e3
        records[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": bound_ms, "max_abs_err": worst[name]}
        say(f"  n={n} int32 {name} ({case_of[name]}, t={t}"
            f"{f', {path} path' if name == 'copy' else ''}): bit-equal; "
            f"kernel {ms:.3f} ms ({2 * nbytes / ms / 1e6:.1f} GB/s), "
            f"library {lib_ms:.3f} ms (in turns), plain {plain_ms:.3f} ms, "
            f"bound {bound_ms:.3f} ms")
        torch.cuda.empty_cache()
    for label, v in ((f"2^{n} - 1 int32", x[:-1]),
                     (f"2^{n} - 1 int32 at a 4-byte offset", x[1:])):
        path = copy_path(v)
        turns = in_turns({"kernel": lambda: K.copy_blocks(v),
                          "library": lambda: v.clone()}, timed)
        say(f"  {label} copy ({path} path): bit-equal; kernel "
            f"{statistics.median(turns['kernel']):.3f} ms, x.clone() "
            f"{statistics.median(turns['library']):.3f} ms (in turns), "
            f"bound {2 * v.numel() * 4 / bw * 1e3:.3f} ms")
        torch.cuda.empty_cache()
    # K1's alternative, the bulk-copy ring (bulk_copy.cuh), run on request
    check(copy_path(x, path="bulk") == "bulk", "bulk ring")
    say(f"  n={n} int32 copy through the bulk ring: bit-equal")
    torch.cuda.empty_cache()
    return records


def phase_main(torch, n: int, reps: int, bw: float, old_so):
    """The main path at 2^n int32; returns the launch counts of the run.
    Each case is timed in turns with the copy kernel, whose time its copy
    ratio divides, and a tiled case also with the K4a its redesign
    replaced (``old_so``, tools/k4a_sweep.cu)."""
    say("== phase 4: main path, bmmc_permute on 2^%d int32 ==" % n)
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randint(-2**31, 2**31 - 1, (1 << n,), generator=gen,
                      device=dev, dtype=torch.int64).to(torch.int32)
    nbytes = x.numel() * 4
    t = ops.choose_tile(n, 4)
    ops._class_plan_cached.cache_clear()
    ops._plans_cached.cache_clear()
    K.clear_device_tables()
    cases = make_cases(n, t)
    plan_s = {}
    for name, b, want_kernel in cases:
        t0 = time.perf_counter()
        kernel, _ = ops.class_plan(b, t)
        plan_s[name] = time.perf_counter() - t0
        check(kernel == want_kernel, (name, kernel, want_kernel))

    say(f"  clocks, power, temperature: {clocks()}")
    # the counted run: the copy yardstick once, then every case once,
    # each output checked against the plain gather (which launches no
    # kernel of the port) before the next
    K.reset_launch_counts()
    got = K.copy_blocks(x)
    check(max_abs_err(torch, got, x) == 0.0, "copy")
    for name, b, _ in cases:
        got = ops.bmmc_permute(x, b)
        want = ref.bmmc_ref_device(x, b)
        check(got.shape == x.shape and got.dtype == x.dtype, name)
        err = max_abs_err(torch, got, want)
        check(err == 0.0, (name, err))
        del got, want
    torch.cuda.synchronize()
    counts = K.launch_counts()
    say(f"  launch counts of the main-path run: {counts}")

    import k4a_sweep
    old = k4a_sweep.old_k4a(old_so, K)
    timed = (lambda fn: cuda_ms(torch, fn, reps))
    for name, b, kernel in cases:
        payload = ops.class_plan(b, t)[1]
        pls = payload if isinstance(payload, tuple) else (payload,)
        tab_bytes = sum(a.numel() * 4 for p in pls
                        for a in K.device_tables(p, dev))
        fns = {"copy": lambda: K.copy_blocks(x),
               "kernel": lambda: ops.bmmc_permute(x, b)}
        if kernel in ("tiled", "general") and len(pls) == 1:
            check(max_abs_err(torch, old(x, pls[0]), ops.bmmc_permute(x, b))
                  == 0.0, (name, "old K4a"))
            fns["old K4a"] = lambda: old(x, pls[0])
        turns = in_turns(fns, timed, rounds=1)
        med = {k: statistics.median(v) for k, v in turns.items()}
        copy_ms, ms = med["copy"], med["kernel"]
        idx = ref.bmmc_src_index(b, dev)
        lib_ms = cuda_ms(torch, lambda: torch.index_select(x, 0, idx), reps)
        idx = None
        bound_ms = (2 * nbytes * len(pls) + tab_bytes) / bw * 1e3
        ab = (f"  old K4a {med['old K4a']:.3f} ms (copy/old "
              f"{copy_ms / med['old K4a']:.3f}, in turns)"
              if "old K4a" in med else "")
        say(f"  {name:17s} kernel={kernel:8s} plan {plan_s[name]:.3f} s  "
            f"{ms:.3f} ms  {2 * nbytes / ms / 1e6:.1f} GB/s  copy "
            f"{copy_ms:.3f} ms  copy/this {copy_ms / ms:.3f}  "
            f"bound {bound_ms:.3f} ms  "
            f"index_select {lib_ms:.3f} ms  bit-equal{ab}")
        say(f"  clocks, power, temperature: {clocks()}")
    torch.cuda.empty_cache()
    return counts


def phase_sweep(torch, n: int, reps: int):
    """The tiled cases of the main path at the tile sizes around the one
    ``ops.choose_tile`` picks, each beside the copy kernel: the record
    behind that choice; at that tile size also K4a's narrow schedule in
    each tile layout of the paper's §4.2 study, in turns with the copy."""
    say(f"== phase 5: tile-size sweep on 2^{n} int32 ==")
    from k4a_sweep import forced
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    x = torch.randint(-2**31, 2**31 - 1, (1 << n,), device=dev,
                      dtype=torch.int32)
    for t in TILE_SWEEP:
        copy_ms = cuda_ms(torch, lambda: K.copy_blocks(x), reps)
        say(f"  copy {copy_ms:.3f} ms")
        for name, b, _ in make_cases(n, ops.choose_tile(n, 4)):
            t0 = time.perf_counter()
            kernel, payload = ops.class_plan(b, t)
            plan_s = time.perf_counter() - t0
            if kernel not in ("tiled", "general"):
                continue
            (plan,) = payload
            ms = cuda_ms(torch, lambda: ops.bmmc_permute(x, b, t=t), reps)
            say(f"  t={t} {name:17s} rows/tile {plan.rows_per_tile:3d} "
                f"plan {plan_s:.3f} s  {ms:.3f} ms  "
                f"{2 * x.numel() * 4 / ms / 1e6:.1f} GB/s  "
                f"copy/this {copy_ms / ms:.3f}")
            if t != ops.choose_tile(n, 4):
                continue
            # the paper's §4.2 study: K4a's narrow schedule in each layout
            fns = {lay: forced(torch, K, x, plan, schedule="narrow",
                               layout=lay)[0] for lay in K.K4A_LAYOUTS}
            fns["copy"] = lambda: K.copy_blocks(x)
            turns = in_turns(fns, lambda fn: cuda_ms(torch, fn, reps),
                             rounds=1)
            med = {k: statistics.median(v) for k, v in turns.items()}
            say(f"    layouts (in turns with the copy): " + ", ".join(
                f"{lay} {med[lay]:.3f} ms (copy/this "
                f"{med['copy'] / med[lay]:.3f})" for lay in K.K4A_LAYOUTS)
                + f"; the wrapper's: {K.k4a_record(x, plan).schedule.layout}")
        ops._class_plan_cached.cache_clear()
        ops._plans_cached.cache_clear()
        K.clear_device_tables()


def fused_cases(n: int, t: int, expr_name: str):
    """The fused clusters (FusedStages with computes) of the sort or FFT
    program at 2^n and tile t, as the port's planner clusters them."""
    from repro_torch.combinators import FusedStage, compile_expr
    from repro_torch.combinators.fft import fft_expr
    from repro_torch.combinators.sort import sort_expr
    expr = {"sort": sort_expr, "fft": fft_expr}[expr_name](n)
    prog = compile_expr(expr).clustered_program(n, t)
    return [s for s in prog if isinstance(s, FusedStage) and s.computes]


def fused_call(K, ex, fs, t, x, batched=False, plain=False):
    """One cluster through K4b as the executor runs it (its tables kept on
    the card), or through the plain version of the same passes."""
    if not plain:
        return ex._fused_cuda(x, fs, t, batched=batched)
    plans, entries = ex._fused_plan_cached(fs, t)
    plan = plans[0]
    sig, scal, vmem, fns = ex._fused_kernel_args(entries, x.dtype)
    y = K.tiled_permute_tables_plain(
        x, plan.in_rows, plan.out_rows, plan.xor_low, plan.src0,
        geometry=K.plan_geometry(plan), epilogue=sig, epi_scalar=scal,
        epi_vmem=vmem, map_fns=fns, batched=batched)
    for plan in plans[1:]:
        y = K.tiled_permute_plain(y, plan, batched=batched)
    return y


def hand_cluster(n: int, t: int, n_epi: int, seed: int, bfly_every: int = 0):
    """A hand-built cluster on the bit reversal's tile plan at 2^n, tile t:
    (plan, epilogue signature, per-tile tables, per-row/lane tables). Its
    partner XORs are the tile's single position bits, in order (so later
    ones fall on the warp bits of an earlier layout), then random XORs of
    several bits, every fourth the XOR of the two before it; the tables
    are random linear ones; every ``bfly_every``-th epilogue is a
    butterfly (planar float32) when non-zero."""
    from repro_torch.core.bmmc import Bmmc
    from repro_torch.core.tiling import _affine_table, plan_bmmc
    rng = np.random.default_rng(seed)
    plan = plan_bmmc(Bmmc.bit_reverse(n), t)[0]
    rpt, n_tiles = plan.rows_per_tile, plan.n_tiles
    rb, gb = rpt.bit_length() - 1, n_tiles.bit_length() - 1

    def table(bits, hi, const=False):
        imgs = [int(v) for v in rng.integers(0, hi, bits)]
        c = int(rng.integers(0, hi)) if const else 0
        return _affine_table(imgs, c).astype(np.int32)

    w = rng.normal(size=(1 << (n - 1), 2)).astype(np.float32)
    vs = [1 << b for b in range(t + rb)]
    while len(vs) < n_epi:
        vs.append(vs[-1] ^ vs[-2] if len(vs) % 4 == 3 and vs[-1] != vs[-2]
                  else int(rng.integers(3, rpt << t)))
    sig, scal, vmem = [], [], []
    for k, v in enumerate(vs[:n_epi]):
        hi = (table(rb, 2), table(t, 2), table(gb, 2, True))
        if bfly_every and k % bfly_every == bfly_every - 1:
            tw = (table(rb, 1 << (n - 1)), table(t, 1 << (n - 1)),
                  table(gb, 1 << (n - 1), True))
            sig.append(("bfly", v >> t, v & ((1 << t) - 1), 1 << (n - 1)))
            scal.append((hi[2], tw[2]))
            vmem.append((hi[0], hi[1], tw[0], tw[1], w))
        else:
            sig.append(("cmp", v >> t, v & ((1 << t) - 1)))
            scal.append((hi[2],))
            vmem.append((hi[0], hi[1]))
    return plan, tuple(sig), tuple(scal), tuple(vmem)


HAND_CASES = (  # label, log2 n, t, epilogues, butterfly every, dtype, tail,
                # batch, NaNs
    ("int32", 14, 6, 20, 0, "int32", 1, 1, False),
    ("float32 NaN/-0", 14, 6, 20, 0, "float32", 1, 1, True),
    ("bfloat16 NaN/-0", 14, 6, 20, 0, "bfloat16", 1, 1, True),
    ("float32 -0, no NaN (keys)", 14, 6, 20, 0, "float32", 1, 1, False),
    ("bfloat16 -0, no NaN (keys)", 14, 6, 20, 0, "bfloat16", 1, 1, False),
    ("float32 d=3 NaN/-0", 14, 5, 20, 0, "float32", 3, 1, True),
    ("float32 B=3", 14, 6, 20, 0, "float32", 1, 3, False),
    ("planar float32, butterflies and compares", 14, 5, 12, 3, "float32",
     2, 1, False),
    ("float32 tile of 2^14 positions (chunks)", 16, 7, 14, 0, "float32", 1,
     1, False),
)


def phase_hand(torch, backward: bool) -> float:
    """K4b (or K5, ``backward``) bit for bit against its plain version on
    hand-built clusters whose partner XORs fall in registers, on lanes and
    on the warp bits of an earlier layout, with XORs of several bits and
    more than 16 compares; returns the worst error."""
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.kernels import epilogue_plan as EP
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(71 + backward)
    worst = 0.0
    for (label, n, t, n_epi, bfly, dname, d, batch,
         nan) in HAND_CASES:
        dtype = getattr(torch, dname)
        if backward and dtype == torch.int32:
            continue
        plan, sig, scal, vmem = hand_cluster(n, t, n_epi, seed=n_epi + t,
                                             bfly_every=bfly)
        shape = (batch, 1 << n, d)
        v = torch.randint(-4, 5, shape, generator=gen, device=dev).float()
        u = torch.rand(shape, generator=gen, device=dev)
        if nan:
            v = torch.where(u < 0.05, torch.full_like(v, float("nan")), v)
        v = torch.where((u > 0.5) & (v == 0), torch.full_like(v, -0.0), v)
        x = v.to(dtype) if not bfly else torch.randn(shape, generator=gen,
                                                     device=dev)
        kw = dict(geometry=K.plan_geometry(plan), epilogue=sig,
                  epi_scalar=scal, epi_vmem=vmem, batched=True)
        tabs = (plan.in_rows, plan.out_rows, plan.xor_low)
        entries = K._epi_entries(sig, scal, vmem)
        _, _, pl, _ = K._epi_launch_args(x, kw["geometry"], entries,
                                         n_buf=2 if backward else 1)
        words = pl.cpu().numpy()
        vl = [int(EP.epi_slice(words, e)[EP.EP_VLANE])
              for e in range(len(sig))]
        vr = [int(EP.epi_slice(words, e)[EP.EP_VREG])
              for e in range(len(sig))]
        classes = (f"{pl.info['n_phases']} phases, {vl.count(0)} in-thread "
                   f"and {len(vl) - vl.count(0)} shuffled epilogues, "
                   f"{sum(bin(a | b << 4).count('1') > 1 for a, b in zip(vr, vl))}"
                   f" with several coordinates, {2 ** pl.info['reg_bits']} "
                   f"registers a thread, {2 ** pl.info['outer_bits']} "
                   f"chunk(s)")
        if backward:
            s0 = plan.src0.reshape(-1)
            inv = np.empty_like(s0)
            inv[s0] = np.arange(s0.size, dtype=s0.dtype)
            inv = inv.reshape(plan.src0.shape)
            ct = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                  if not nan else x.flip(1).contiguous())
            got = K.tiled_permute_bwd_tables(x, ct, *tabs, inv, **kw)
            want = K.tiled_permute_bwd_tables_plain(x, ct, *tabs, inv, **kw)
        else:
            got = K.tiled_permute_tables(x, *tabs, plan.src0, **kw)
            want = K.tiled_permute_tables_plain(x, *tabs, plan.src0, **kw)
        err = max_abs_err(torch, got, want)
        check(err == 0.0, ("hand-built", backward, label, err))
        worst = max(worst, err)
        say(f"  hand-built, {n_epi} epilogues ({classes}), {label}: "
            f"bit-equal")
    return worst


# Map epilogues on hand-built clusters: each map is (position in the
# epilogue list, name, torch function or the name of one). Float inputs
# are continuous (uniform in [-4, 4), zeros planted for v / v; the tanh
# and log case in [0.5, 1.5)). Every case is held bit for bit in both
# directions: K4b's tape runs the math functions PyTorch's CUDA kernels
# call (tanhf, expf, logf), rounding as they do, and K5 takes each op's
# derivative as PyTorch's CUDA backward kernels round it (float32 tanh's
# 1 - y * y an FMA; bfloat16 tanh and sigmoid rounded after each op).


def _sq(v):
    return v * v


def _silu(v):
    return v * v.sigmoid()


def _self_ratio(v):
    return v / v          # 1, or NaN where v is zero: NaNs mid-phase


def _chain3(v):
    return (v * 3 + 1) / 7   # bfloat16: each of the three ops rounds


def _chain3_once(v):
    return ((v.float() * 3 + 1) / 7).to(v.dtype)   # rounded once


def _div3(v):
    return v / 3


def _wrap(v):
    return v * 1000003 + 7


MAP_CASES = (  # label, log2 n, t, compares, maps, dtype, tail, batch
    ("float32, maps between compares and at a phase boundary", 14, 6, 20,
     ((3, "sq", _sq), (9, "silu", _silu), (11, "sq", _sq), (23, "silu",
                                                            _silu)),
     "float32", 1, 1),
    ("float32, a map that makes NaNs mid-phase (keys, then floats)", 14, 6,
     12, ((4, "v/v", _self_ratio),), "float32", 1, 1),
    ("bfloat16, a chain of three ops rounded after each", 14, 6, 12,
     ((2, "chain3", _chain3), (9, "chain3", _chain3)), "bfloat16", 1, 1),
    ("bfloat16, tanh, exp, sigmoid and a division by a number", 14, 6, 12,
     ((1, "tanh", "tanh"), (4, "exp", "exp"), (7, "sigmoid", "sigmoid"),
      (10, "div3", _div3)), "bfloat16", 1, 1),
    ("int32, a wrapping map", 14, 6, 12, ((1, "wrap", _wrap),
                                          (7, "not", "bitwise_not")),
     "int32", 1, 1),
    ("float32 B=3, d=3", 14, 5, 12, ((2, "sq", _sq), (8, "silu", _silu)),
     "float32", 3, 3),
    ("float32, tanh and log", 14, 6, 12,
     ((0, "tanh", "tanh"), (6, "log", "log")), "float32", 1, 1),
)
# relative error of phase 10's tanh >> sort gradient against the library
# composite (torch.sort after torch.tanh under autograd)
MAP_GRAD_TOL = 1e-5


def phase_hand_maps(torch, backward: bool) -> float:
    """K4b (or K5, ``backward``) against its plain version on hand-built
    clusters with map epilogues, bit for bit; returns the worst bit
    difference. A compare bit that K5's replay got wrong would send a
    cotangent to the wrong position."""
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.kernels import epilogue_plan as EP
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(81 + backward)
    worst = 0.0
    for (label, n, t, n_cmp, maps, dname, d, batch) in MAP_CASES:
        dtype = getattr(torch, dname)
        if backward and dtype == torch.int32:
            continue
        plan, sig, scal, vmem = hand_cluster(n, t, n_cmp, seed=n_cmp + t)
        sig, scal, vmem, fns = list(sig), list(scal), list(vmem), []
        for pos, name, fn in maps:
            sig.insert(pos, ("map", name))
            scal.insert(pos, ())
            vmem.insert(pos, ())
        for sg in sig:
            if sg[0] == "map":
                fn = next(f for _, nm, f in maps if nm == sg[1])
                fns.append(getattr(torch, fn) if isinstance(fn, str) else fn)
        shape = (batch, 1 << n, d)
        if dtype == torch.int32:
            v = torch.randint(-4, 5, shape, generator=gen, device=dev)
            x = (v * 65537 + 11).to(torch.int32) * 32771
        elif "log" in {nm for _, nm, _ in maps}:
            x = (torch.rand(shape, generator=gen, device=dev) + 0.5).to(
                dtype)
        else:
            u = torch.rand(shape, generator=gen, device=dev)
            x = (torch.rand(shape, generator=gen, device=dev) - 0.5) * 8
            x = torch.where(u < 0.05, torch.zeros_like(x), x).to(dtype)
        if any(f is _chain3 for _, _, f in maps):
            # the inputs tell per-op rounding from rounding once: a kernel
            # that rounded once would differ from the plain version
            once = int((bits(torch, _chain3(x)) != bits(
                torch, _chain3_once(x))).sum())
            check(once > 0, ("chain3 inputs do not discriminate", label))
        kw = dict(geometry=K.plan_geometry(plan), epilogue=tuple(sig),
                  epi_scalar=tuple(scal), epi_vmem=tuple(vmem),
                  map_fns=tuple(fns), batched=True)
        tabs = (plan.in_rows, plan.out_rows, plan.xor_low)
        entries = K._epi_entries(kw["epilogue"], kw["epi_scalar"],
                                 kw["epi_vmem"], kw["map_fns"], dtype)
        _, _, pl, _ = K._epi_launch_args(x, kw["geometry"], entries,
                                         n_buf=2 if backward else 1)
        words = pl.cpu().numpy()
        phases = [[int(EP.epi_slice(words, e)[EP.EP_KIND]) for e in range(
            int(EP.phase_slice(words, p)[EP.PH_E0]),
            int(EP.phase_slice(words, p)[EP.PH_E1]))]
            for p in range(pl.info["n_phases"])]
        at = [[i for i, k in enumerate(ph) if k == EP.KIND_MAP]
              for ph in phases]
        where = (f"{pl.info['n_phases']} phase(s), map positions by phase "
                 f"{at} of {[len(ph) for ph in phases]} epilogues")
        if backward:
            s0 = plan.src0.reshape(-1)
            inv = np.empty_like(s0)
            inv[s0] = np.arange(s0.size, dtype=s0.dtype)
            inv = inv.reshape(plan.src0.shape)
            ct = torch.randn(shape, generator=gen, device=dev).to(dtype)
            got = K.tiled_permute_bwd_tables(x, ct, *tabs, inv, **kw)
            want = K.tiled_permute_bwd_tables_plain(x, ct, *tabs, inv, **kw)
            on_card = [torch.from_numpy(a).to(dev) for a in tabs + (inv,)]

            def call():
                return K.tiled_permute_bwd_tables(x, ct, *on_card, **kw)
        else:
            got = K.tiled_permute_tables(x, *tabs, plan.src0, **kw)
            want = K.tiled_permute_tables_plain(x, *tabs, plan.src0, **kw)
            on_card = [torch.from_numpy(a).to(dev)
                       for a in tabs + (plan.src0,)]

            def call():
                return K.tiled_permute_tables(x, *on_card, **kw)
        ms, dev_ms = cuda_ms(torch, call, REPS), device_ms(torch, call)
        timed = (f"; {ms:.4f} ms a call, {dev_ms:.4f} ms on the device "
                 f"({x.numel()} elements)")
        err = max_abs_err(torch, got, want)
        check(err == 0.0, ("map hand-built", backward, label, err))
        worst = max(worst, err)
        extra = (f"; {once} of {x.numel()} inputs round differently once"
                 if any(f is _chain3 for _, _, f in maps) else "")
        say(f"  maps, hand-built ({where}), {label}: bit-equal{timed}"
            f"{extra}")
    return worst


def device_ms(torch, fn, inner: int = 10) -> float:
    """Device milliseconds of one call of ``fn``: ``inner`` calls captured
    in one CUDA graph, replayed (median of REPS), so the host's launch
    overhead is not in the time."""
    from repro_torch.kernels import bmmc_permute as K
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with K.pin_device_tables():
        with torch.cuda.graph(g):
            for _ in range(inner):
                fn()
    ms = cuda_ms(torch, g.replay, REPS, warmup=1) / inner
    del g
    return ms


def phase_fused(torch, n_small: int, n_sort: int, n_fft: int, reps: int,
                bw: float, ab):
    """K4b against its plain version, bit for bit, at small sizes and on
    every FFT cluster at 2^n_fft; then one 2^n_sort int32 sort cluster,
    also bit for bit, timed beside the plain version and the torch
    composite of the same cluster."""
    say("== phase 6: K4b (tile_fused) vs plain ==")
    from repro_torch.combinators import CmpHalves, Perm
    from repro_torch.combinators import execute as ex
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)

    def ties(shape, dtype):
        """Small integers as ``dtype`` (many ties), with canonical NaNs and
        signed zeros for the float types."""
        v = torch.randint(-4, 5, shape, generator=gen, device=dev)
        if dtype == torch.int32:
            return v.to(torch.int32)
        f = v.to(torch.float32)
        u = torch.rand(shape, generator=gen, device=dev)
        f = torch.where(u < 0.05, torch.full_like(f, float("nan")), f)
        f = torch.where((u > 0.5) & (f == 0), torch.full_like(f, -0.0), f)
        return f.to(dtype)

    worst = 0.0
    by_size = {}
    for fs in fused_cases(n_small, 6, "sort"):
        by_size.setdefault(len(fs.computes), fs)
    check(1 in by_size and 2 in by_size and 3 in by_size, sorted(by_size))
    configs = [("int32", torch.int32, (1 << n_small,), False),
               ("float32 NaN/-0", torch.float32, (1 << n_small,), False),
               ("bfloat16 NaN/-0", torch.bfloat16, (1 << n_small,), False),
               ("int32 B=3", torch.int32, (3, 1 << n_small), True)]
    for label, dtype, shape, batched in configs:
        x = ties(shape, dtype)
        for k in (1, 2, 3):
            got = fused_call(K, ex, by_size[k], 6, x, batched)
            want = fused_call(K, ex, by_size[k], 6, x, batched, plain=True)
            err = max_abs_err(torch, got, want)
            check(err == 0.0, ("cmp", label, k, err))
            worst = max(worst, err)
        say(f"  n={n_small} cmp {label} t=6: clusters of 1, 2 and 3 "
            f"epilogues bit-equal")
    t3 = ops.choose_tile(n_small, 4, 3)
    for fs in fused_cases(n_small, t3, "sort")[:3]:
        x = ties((1 << n_small, 3), torch.float32)
        err = max_abs_err(torch, fused_call(K, ex, fs, t3, x),
                          fused_call(K, ex, fs, t3, x, plain=True))
        check(err == 0.0, ("cmp d=3", err))
        worst = max(worst, err)
    say(f"  n={n_small} cmp float32 d=3 t={t3}: bit-equal")
    # the butterfly arm at a small size and at the combinator path's FFT
    # size, where its twiddle table is 2^(n_fft - 1) entries read through L2
    for nb in (n_small, n_fft):
        t2 = ops.choose_tile(nb, 4, 2)
        for fs in fused_cases(nb, t2, "fft"):
            x = torch.randn((1 << nb, 2), generator=gen, device=dev)
            err = max_abs_err(torch, fused_call(K, ex, fs, t2, x),
                              fused_call(K, ex, fs, t2, x, plain=True))
            check(err == 0.0, ("bfly", nb, len(fs.computes), err))
            worst = max(worst, err)
            say(f"  n={nb} bfly float32 planar t={t2}: "
                f"{len(fs.computes)} epilogues bit-equal")
        del x
    worst = max(worst, phase_hand(torch, backward=False))
    worst = max(worst, phase_hand_maps(torch, backward=False))

    t = ops.choose_tile(n_sort, 4)
    fs = max(fused_cases(n_sort, t, "sort"), key=lambda s: len(s.computes))
    x = torch.randint(-2**31, 2**31 - 1, (1 << n_sort,), generator=gen,
                      device=dev, dtype=torch.int64).to(torch.int32)
    got = fused_call(K, ex, fs, t, x)
    want = fused_call(K, ex, fs, t, x, plain=True)
    err = max_abs_err(torch, got, want)
    check(err == 0.0, ("2^n cluster", err))
    worst = max(worst, err)
    # the torch composite of the same cluster: each Perm an index_select
    # on a precomputed index, each CmpHalves torch.minimum/maximum
    idx = {id(s): ref.bmmc_src_index(s.bmmc, dev) for s in fs.stages
           if isinstance(s, Perm)}

    def composite():
        v = x
        for s in fs.stages:
            if isinstance(s, Perm):
                v = torch.index_select(v, 0, idx[id(s)])
            else:
                check(isinstance(s, CmpHalves), type(s).__name__)
                lo, hi = v.chunk(2)
                v = torch.cat([torch.minimum(lo, hi), torch.maximum(lo, hi)])
        return v
    check(torch.equal(composite(), got), "torch composite of the cluster")
    del got, want
    plans, entries = ex._fused_plan_cached(fs, t)
    check(len(plans) == 1, "one pass")
    tab_bytes = sum(a.numel() * 4 for a in K.device_tables(plans[0], dev))
    tab_bytes += sum(np.asarray(a).nbytes for e in entries
                     for a in (e[2].hi_row, e[2].hi_lane, e[2].hi_base))
    nbytes = x.numel() * 4
    ms = cuda_ms(torch, lambda: fused_call(K, ex, fs, t, x), reps)
    dev_ms = device_ms(torch, lambda: fused_call(K, ex, fs, t, x))
    plain_ms = cuda_ms(torch, lambda: fused_call(K, ex, fs, t, x, plain=True),
                       max(3, reps // 3), warmup=1)
    lib_ms = cuda_ms(torch, composite, reps)
    tile_ms = device_ms(torch, lambda: K.tiled_permute(x, plans[0]))
    copy_ms = device_ms(torch, lambda: K.copy_blocks(x))
    xf = x.float()
    f32_ms = device_ms(torch, lambda: fused_call(K, ex, fs, t, xf))
    bound_ms = (2 * nbytes + tab_bytes) / bw * 1e3
    say(f"  n={n_sort} int32 sort cluster ({len(fs.stages)} stages, "
        f"{len(fs.computes)} cmp epilogues, t={t}): bit-equal; kernel "
        f"{ms:.4f} ms a call (the host's launch path included), "
        f"{dev_ms:.4f} ms on the device ({2 * nbytes / dev_ms / 1e6:.1f} "
        f"GB/s), float32 keys {f32_ms:.4f} ms, same pass without epilogues "
        f"(K4a) {tile_ms:.4f} ms, copy {copy_ms:.4f} ms (device times: 10 "
        f"calls in one CUDA graph), plain {plain_ms:.3f} ms, torch composite "
        f"{lib_ms:.3f} ms, bound {bound_ms:.4f} ms")
    turns = fused_ab_turns(torch, ab, fs, t, (("K4b int32", x, None),
                                              ("K4b float32", xf, None)))
    del xf
    torch.cuda.empty_cache()
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms, "max_abs_err": worst,
            "old_ms": turns["K4b int32"]["old_ms"],
            "old_device_ms": turns["K4b int32"]["old_device_ms"]}


def bwd_call(K, ex, fs, t, x, ct, batched=False, plain=False):
    """One cluster's backward through K5 as the executor runs it (its
    tables kept on the card), or through K5's plain version."""
    if not plain:
        return ex._fused_bwd_cuda(fs, t, batched, x, ct)
    plans, entries, inv, _ = ex._fused_bwd_kernel_plan(fs, t)
    plan = plans[0]
    sig, scal, vmem, fns = ex._fused_kernel_args(entries, x.dtype)
    return K.tiled_permute_bwd_tables_plain(
        x, ct, plan.in_rows, plan.out_rows, plan.xor_low, inv,
        geometry=K.plan_geometry(plan), epilogue=sig, epi_scalar=scal,
        epi_vmem=vmem, map_fns=fns, batched=batched)


def phase_bwd_kernel(torch, n_small: int, n_sort: int, n_fft: int,
                     reps: int, bw: float, ab):
    """K5 against its plain version, bit for bit, at small sizes, on the
    FFT's butterfly clusters at 2^n_fft and on the largest cluster of the
    2^n_sort float32 sort (keys from 2^16 values, so with ties); the last
    timed beside its bound, its plain version and the torch composite."""
    say("== phase 9: K5 (tile_bwd) vs plain ==")
    from repro_torch.combinators import CmpHalves, Perm
    from repro_torch.combinators import execute as ex
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)

    def ties(shape, dtype):
        """Small integers as ``dtype`` (many ties), with canonical NaNs and
        signed zeros."""
        f = torch.randint(-4, 5, shape, generator=gen, device=dev).float()
        u = torch.rand(shape, generator=gen, device=dev)
        f = torch.where(u < 0.05, torch.full_like(f, float("nan")), f)
        f = torch.where((u > 0.5) & (f == 0), torch.full_like(f, -0.0), f)
        return f.to(dtype)

    def compare(fs, t, x, ct, batched=False):
        got = bwd_call(K, ex, fs, t, x, ct, batched)
        want = bwd_call(K, ex, fs, t, x, ct, batched, plain=True)
        return max_abs_err(torch, got, want)

    worst = 0.0
    by_size = {}
    for fs in fused_cases(n_small, 6, "sort"):
        by_size.setdefault(len(fs.computes), fs)
    configs = [("float32 NaN/-0", torch.float32, (1 << n_small,), False),
               ("bfloat16 NaN/-0", torch.bfloat16, (1 << n_small,), False),
               ("float32 B=3", torch.float32, (3, 1 << n_small), True)]
    for label, dtype, shape, batched in configs:
        x = ties(shape, dtype)
        ct = torch.randn(shape, generator=gen, device=dev).to(dtype)
        for k in (1, 2, 3):
            err = compare(by_size[k], 6, x, ct, batched)
            check(err == 0.0, ("K5 cmp", label, k, err))
            worst = max(worst, err)
        say(f"  n={n_small} cmp {label} t=6: clusters of 1, 2 and 3 "
            f"epilogues bit-equal")
    t3 = ops.choose_tile(n_small, 4, 3)
    for fs in fused_cases(n_small, t3, "sort")[:3]:
        x = ties((1 << n_small, 3), torch.float32)
        ct = torch.randn((1 << n_small, 3), generator=gen, device=dev)
        err = compare(fs, t3, x, ct)
        check(err == 0.0, ("K5 cmp d=3", err))
        worst = max(worst, err)
    say(f"  n={n_small} cmp float32 d=3 t={t3}: bit-equal")
    t2 = ops.choose_tile(n_fft, 4, 2)
    for fs in fused_cases(n_fft, t2, "fft"):
        x = torch.randn((1 << n_fft, 2), generator=gen, device=dev)
        ct = torch.randn((1 << n_fft, 2), generator=gen, device=dev)
        err = compare(fs, t2, x, ct)
        check(err == 0.0, ("K5 bfly", n_fft, err))
        worst = max(worst, err)
        say(f"  n={n_fft} bfly float32 planar t={t2}: {len(fs.computes)} "
            f"epilogues bit-equal")
    del x, ct
    worst = max(worst, phase_hand(torch, backward=True))
    worst = max(worst, phase_hand_maps(torch, backward=True))

    t = ops.choose_tile(n_sort, 4)
    fs = max(fused_cases(n_sort, t, "sort"), key=lambda s: len(s.computes))
    x = torch.randint(0, 1 << 16, (1 << n_sort,), generator=gen,
                      device=dev).float()
    ct = torch.randn(1 << n_sort, generator=gen, device=dev)
    err = compare(fs, t, x, ct)
    check(err == 0.0, ("K5 2^n cluster", err))
    worst = max(worst, err)
    # the torch composite: autograd's backward through the cluster's
    # stages run as torch ops (index_select per Perm, minimum/maximum per
    # compare); only the backward is timed
    idx = {id(s): ref.bmmc_src_index(s.bmmc, dev) for s in fs.stages
           if isinstance(s, Perm)}
    xr = x.clone().requires_grad_(True)
    v = xr
    for s in fs.stages:
        if isinstance(s, Perm):
            v = torch.index_select(v, 0, idx[id(s)])
        else:
            check(isinstance(s, CmpHalves), type(s).__name__)
            lo, hi = v.chunk(2)
            v = torch.cat([torch.minimum(lo, hi), torch.maximum(lo, hi)])
    plans, entries = ex._fused_plan_cached(fs, t)
    tab_bytes = sum(a.numel() * 4 for a in K.device_tables(plans[0], dev))
    tab_bytes += plans[0].src0.nbytes   # inv_src0
    tab_bytes += sum(np.asarray(a).nbytes for e in entries
                     for a in (e[2].hi_row, e[2].hi_lane, e[2].hi_base))
    nbytes = x.numel() * 4
    ms = cuda_ms(torch, lambda: bwd_call(K, ex, fs, t, x, ct), reps)
    dev_ms = device_ms(torch, lambda: bwd_call(K, ex, fs, t, x, ct))
    plain_ms = cuda_ms(torch, lambda: bwd_call(K, ex, fs, t, x, ct,
                                                plain=True),
                       max(3, reps // 3), warmup=1)
    lib_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        v, xr, ct, retain_graph=True), reps)
    fwd_ms = device_ms(torch, lambda: ex._fused_cuda(x, fs, t))
    bound_ms = (3 * nbytes + tab_bytes) / bw * 1e3
    say(f"  n={n_sort} float32 sort cluster ({len(fs.stages)} stages, "
        f"{len(fs.computes)} cmp epilogues, t={t}, keys from 2^16 values): "
        f"bit-equal; K5 {ms:.4f} ms a call (the host's launch path "
        f"included), {dev_ms:.4f} ms on the device "
        f"({3 * nbytes / dev_ms / 1e6:.1f} GB/s), the forward pass (K4b) "
        f"{fwd_ms:.4f} ms on the device, plain {plain_ms:.3f} ms, torch "
        f"composite backward {lib_ms:.3f} ms, bound {bound_ms:.4f} ms")
    say(f"  clocks, power, temperature: {clocks()}")
    del v, xr
    turns = fused_ab_turns(torch, ab, fs, t, (
        ("K5 float32", x, ct), ("K5 bfloat16", x.bfloat16(), ct.bfloat16())))
    torch.cuda.empty_cache()
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms, "max_abs_err": worst,
            "old_ms": turns["K5 float32"]["old_ms"],
            "old_device_ms": turns["K5 float32"]["old_device_ms"]}


def phase_gradients(torch, n_sort: int, n_ties: int, n_fft: int,
                    n_perm: int, reps: int):
    """Gradients through the entry points, ``loss = (w * f(x)).sum()``.
    Returns the K5 launches of the main path's cold backwards (the sort,
    tanh >> sort and the FFT)."""
    say("== phase 10: gradients on the main path ==")
    from repro_torch import obs
    from repro_torch.combinators import FusedStage, clear_caches, compile_expr
    from repro_torch.combinators import execute as ex
    from repro_torch.combinators import fft as F
    from repro_torch.combinators import sort as S
    from repro_torch.combinators import vocab as V
    from repro_torch.core.bmmc import Bmmc
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4242)

    def cold_grad(f, x, w):
        """One cold forward + backward with telemetry on: (gradient,
        counted backward round trips, fused fallbacks, K5 launches,
        host seconds)."""
        clear_caches()
        obs.reset()
        obs.enable(sync=True)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            xt = x.clone().requires_grad_(True)
            (w * f(xt)).sum().backward()
            torch.cuda.synchronize()
        finally:
            obs.disable()
        sec = time.perf_counter() - t0
        rt = obs.counter_total("model.vjp_round_trips")
        fb = obs.counter_total("dispatch.fused_fallback")
        obs.reset()
        return xt.grad, rt, fb, K.launch_counts()["tile_bwd"], sec

    def clusters(f, n, t):
        return sum(isinstance(s, FusedStage) and bool(s.computes)
                   for s in f.clustered_program(n, t))

    def times(name, f, x, w, lib, forward="graph"):
        """Forward alone (recording the graph) and forward + backward, the
        forward without grad (the CUDA graph; a Map program's runs
        eagerly), and the library's."""
        xt = x.clone().requires_grad_(True)

        def fwd_bwd(fn):
            xt.grad = None
            (w * fn(xt)).sum().backward()
        fwd = cuda_ms(torch, lambda: f(xt), reps)
        both = cuda_ms(torch, lambda: fwd_bwd(f), reps)
        graph = cuda_ms(torch, lambda: f(x), reps)
        lib_fwd = cuda_ms(torch, lambda: lib(xt), reps)
        lib_both = cuda_ms(torch, lambda: fwd_bwd(lib), reps)
        torch.cuda.reset_peak_memory_stats()
        fwd_bwd(f)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        say(f"  {name}: forward {fwd:.3f} ms, forward + backward "
            f"{both:.3f} ms (peak device memory {peak:.2f} GiB), forward "
            f"without grad ({forward}) {graph:.3f} ms; library under "
            f"autograd: "
            f"forward {lib_fwd:.3f} ms, forward + backward {lib_both:.3f} ms")
        say(f"  clocks, power, temperature: {clocks()}")

    def breakdown(name, f, x, n, t):
        """CUDA-event ms of each stage's backward run alone (on a random
        cotangent, at the stage's own saved input), summed by kind."""
        from repro_torch.combinators import Perm, run_program
        prog = f.clustered_program(n, t)
        res, v = [], x
        for st in prog:
            res.append(v)
            v = run_program((st,), v, "cuda")
        ct = torch.randn(v.shape, generator=gen, device=dev)
        by = {}
        for st, xs in zip(reversed(prog), reversed(res)):
            if isinstance(st, Perm):
                kind = "inverse " + ops.class_plan(st.bmmc.inverse(), t)[0]
                fn = (lambda st=st: ex.perm_apply(ct, st.bmmc.inverse(),
                                                  "cuda"))
            elif isinstance(st, FusedStage) and not st.computes:
                kind = "inverse fused (compute-free)"
                fn = (lambda st=st: ex.fused_apply(
                    ct, ex._fused_inverse_cached(st), "cuda"))
            elif isinstance(st, FusedStage):
                kind = "K5"
                fn = (lambda st=st, xs=xs: ex._fused_bwd_impl(
                    st, "cuda", False, xs, ct))
            else:
                kind = "compute VJP"
                fn = (lambda st=st, xs=xs: ex._compute_bwd(st, xs, ct,
                                                           False))
            by[kind] = by.get(kind, 0.0) + cuda_ms(torch, fn, 3, warmup=1)
        say(f"  {name}: backward ms by kind (each stage timed alone): "
            + ", ".join(f"{k} {v:.3f}" for k, v in sorted(by.items()))
            + f"; sum {sum(by.values()):.3f}")

    k5 = 0
    # the sort of distinct keys: the gradient scatters w to the sorting
    # permutation
    n = n_sort
    x = torch.randperm(1 << n, generator=gen, device=dev).float()
    w = torch.randn(1 << n, generator=gen, device=dev)
    f = S.compiled_sort(n)
    t = ops.choose_tile(n, 4)
    g, rt, fb, launched, sec = cold_grad(f, x, w)
    want = torch.zeros_like(w).scatter_(0, torch.sort(x).indices, w)
    check(max_abs_err(torch, g, want) == 0.0, "sort gradient")
    model = f.vjp_round_trips(n, t)
    fwd_rt = f.cost(n, t, clustered=True)["round_trips"]
    check(rt == model == fwd_rt, ("sort vjp round trips", rt, model, fwd_rt))
    check(fb == 0, ("sort backward fused fallbacks", fb))
    check(launched == clusters(f, n, t), ("K5 launches", launched))
    k5 += launched
    say(f"  sort of 2^{n} float32 (distinct keys): gradient equal to the "
        f"scatter of w bit for bit; cold forward + backward {sec:.2f} s "
        f"(host clock, planning included); backward round trips {int(rt)} "
        f"(counted) = {model} (vjp_round_trips) = {fwd_rt} (forward); "
        f"K5 launches {launched}; fused fallbacks 0")
    times(f"sort 2^{n} float32", f, x, w, lambda v: torch.sort(v).values)
    breakdown(f"sort 2^{n} float32", f, x, n, t)
    del g, want
    torch.cuda.empty_cache()

    # tanh >> sort: the map fused into the first cluster, K5 its gradient
    from repro_torch.combinators.sort import sort_expr
    ft = compile_expr(V.emap("tanh", torch.tanh) >> sort_expr(n))
    # distinct keys in [-1/2, 1/2), where tanh ties few of them
    x = (torch.randperm(1 << n, generator=gen, device=dev).float()
         - (1 << (n - 1))) / (1 << n)
    g, rt, fb, launched, sec = cold_grad(ft, x, w)
    model = ft.vjp_round_trips(n, t)
    fwd_rt = ft.cost(n, t, clustered=True)["round_trips"]
    check(rt == model == fwd_rt, ("tanh sort vjp round trips", rt, model,
                                   fwd_rt))
    check(fb == 0, ("tanh sort fused fallbacks", fb))
    check(launched == clusters(ft, n, t), ("K5 launches", launched))
    k5 += launched
    # the library composite under autograd; where tanh ties keys, the two
    # split the tied cotangents differently, so a tied group is held by
    # its sum
    xl = x.clone().requires_grad_(True)
    (w * torch.sort(torch.tanh(xl)).values).sum().backward()
    want = xl.grad
    keys, order = torch.sort(torch.tanh(x))
    first = torch.ones_like(keys, dtype=torch.bool)   # a group's first key
    first[1:] = keys[1:] != keys[:-1]
    last = torch.ones_like(first)
    last[:-1] = first[1:]
    group = torch.cumsum(first.long(), 0) - 1
    tied = torch.empty_like(first)
    tied[order] = ~(first & last)
    rel_one = float(((g - want).abs() / want.abs().clamp_min(1e-30))[
        ~tied & (want != 0)].max())
    sums = [torch.zeros(int(group[-1]) + 1, device=dev).index_add_(
        0, group, v[order]) for v in (g, want)]
    rel_sum = float((sums[0] - sums[1]).abs().max()
                    / sums[1].abs().max())
    check(bool(torch.isfinite(g).all()), "tanh sort gradient finite")
    check(rel_one <= MAP_GRAD_TOL and rel_sum <= MAP_GRAD_TOL,
          ("tanh sort gradient", rel_one, rel_sum))
    say(f"  tanh >> sort of 2^{n} float32: gradient within {rel_one:.3e} "
        f"(elementwise, {int((~tied).sum())} untied keys) and {rel_sum:.3e} "
        f"(sums over {int(group[-1]) + 1 - int((~tied).sum())} groups of "
        f"tied keys) of torch.sort(torch.tanh(x)) under autograd (limit "
        f"{MAP_GRAD_TOL:g}); cold forward + backward {sec:.2f} s; round "
        f"trips {int(rt)} (counted backward) = {model} (vjp_round_trips) = "
        f"{fwd_rt} (forward); K5 launches {launched}; fused fallbacks 0")
    times(f"tanh >> sort 2^{n} float32", ft, x, w,
          lambda v: torch.sort(torch.tanh(v)).values, forward="eager")
    del g, want, xl, keys, order, group, tied, sums
    torch.cuda.empty_cache()

    # the gradient kernel route against the collapsed route, with ties
    n = n_ties
    x = torch.randint(0, 1 << 12, (1 << n,), generator=gen, device=dev).float()
    w = torch.randn(1 << n, generator=gen, device=dev)
    f = S.compiled_sort(n)
    grads = []
    for mega in (True, False):
        ex.BWD_MEGAKERNEL = mega
        try:
            grads.append(cold_grad(f, x, w)[0])
        finally:
            ex.BWD_MEGAKERNEL = True
    clear_caches()
    check(max_abs_err(torch, grads[0], grads[1]) == 0.0,
          "K5 route vs collapsed route")
    say(f"  sort of 2^{n} float32 with ties (keys from 2^12 values): the "
        f"gradient kernel route equals the collapsed route bit for bit")
    del grads
    torch.cuda.empty_cache()

    # the FFT against float64 torch.fft.fft under autograd
    n = n_fft
    xr = torch.randn((1 << n, 2), generator=gen, device=dev)
    w = torch.randn((1 << n, 2), generator=gen, device=dev)
    f = F.compiled_fft(n)
    t = ops.choose_tile(n, 4, 2)
    g, rt, fb, launched, sec = cold_grad(f, xr, w)
    x64 = xr.double().requires_grad_(True)
    (w.double() * torch.view_as_real(torch.fft.fft(
        torch.view_as_complex(x64)))).sum().backward()
    rel = float(torch.linalg.vector_norm(g.double() - x64.grad)
                / torch.linalg.vector_norm(x64.grad))
    check(bool(torch.isfinite(g).all()) and g.shape == xr.shape, "fft grad")
    check(rel <= FFT_REL_TOL, ("fft gradient relative error", rel))
    model = f.vjp_round_trips(n, t)
    fwd_rt = f.cost(n, t, clustered=True)["round_trips"]
    check(rt == model == fwd_rt, ("fft vjp round trips", rt, model, fwd_rt))
    check(fb == 0, ("fft backward fused fallbacks", fb))
    check(launched == clusters(f, n, t), ("K5 launches", launched))
    k5 += launched
    say(f"  FFT of 2^{n} planar float32: gradient within {rel:.3e} "
        f"(norm-wise) of float64 torch.fft.fft under autograd (limit "
        f"{FFT_REL_TOL:g}); cold forward + backward {sec:.2f} s; backward "
        f"round trips {int(rt)} = {model} = {fwd_rt} (forward); K5 launches "
        f"{launched}; fused fallbacks 0")
    times(f"FFT 2^{n} planar float32", f, xr, w,
          lambda v: torch.view_as_real(torch.fft.fft(torch.view_as_complex(v))))
    breakdown(f"FFT 2^{n} planar float32", f, xr, n, t)
    del g, x64
    torch.cuda.empty_cache()

    # a permutation-only chain: its gradient is the inverse program
    n = n_perm
    rng = random.Random(2306)
    expr = (V.bit_reverse(n) >> V.perm(Bmmc.matrix_transpose(n // 2, n - n // 2))
            >> V.perm(Bmmc.random_bpc(n, rng)))
    f = compile_expr(expr)
    (stage,) = f.program(n)   # the optimizer fuses the chain into one BMMC
    idx = ref.bmmc_src_index(stage.bmmc, dev)
    t = ops.choose_tile(n, 4)
    x = torch.randn(1 << n, generator=gen, device=dev)
    w = torch.randn(1 << n, generator=gen, device=dev)
    g, rt, fb, _, sec = cold_grad(f, x, w)
    want = w
    for s in f.vjp_program(n):
        want = ref.bmmc_ref_device(want, s.bmmc)
    check(max_abs_err(torch, g, want) == 0.0, "perm chain gradient")
    model = f.vjp_round_trips(n, t)
    check(rt == model, ("perm chain vjp round trips", rt, model))
    say(f"  permutation chain (bit-reverse, transpose, random BPC) on 2^{n} "
        f"float32: gradient equal to the inverse program applied to w bit "
        f"for bit; backward round trips {int(rt)} = {model}; cold forward + "
        f"backward {sec:.2f} s")
    times(f"permutation chain 2^{n} float32", f, x, w,
          lambda v: torch.index_select(v, 0, idx))
    del g, want, idx
    torch.cuda.empty_cache()
    return k5


def plan_program(f, x, batched=False):
    """Resolve a compiled program and build every plan it runs (the
    host planning of a cold call): (program, t, seconds)."""
    from repro_torch.combinators import FusedStage, Perm
    from repro_torch.combinators import execute as ex
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    prog, t = f._resolve(x, batched)
    for s in prog:
        if isinstance(s, FusedStage):
            check(ex._fused_plan_cached(s, t) is not None, "cluster plan")
        elif isinstance(s, Perm):
            ops.class_plan(s.bmmc, t)
    return prog, t, time.perf_counter() - t0


def phase_combinators(torch, n_sort: int, n_fft: int, reps: int):
    """The combinator path through its entry points: the sort of 2^n_sort
    int32 keys and the FFT of 2^n_fft planar float32 points. Returns the
    launch counts of the two cold calls."""
    say("== phase 7: combinator path (sort, FFT) ==")
    from repro_torch import obs
    from repro_torch.combinators import program_cost
    from repro_torch.combinators import clear_caches
    from repro_torch.combinators import fft as F
    from repro_torch.combinators import sort as S
    from repro_torch.kernels import bmmc_permute as K
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2306)
    counts = {k: 0 for k in K.LAUNCHES}
    clear_caches()   # the planning seconds below are a cold call's

    def cold(fn, x):
        """The entry point's first call with telemetry on: (result, modeled
        round trips counted, fused fallbacks, launch counts)."""
        obs.reset()
        obs.enable(sync=True)
        K.reset_launch_counts()
        try:
            y = fn(x)
            torch.cuda.synchronize()
        finally:
            obs.disable()
        c = K.launch_counts()
        for k, v in c.items():
            counts[k] += v
        rt = obs.counter_total("model.round_trips")
        fb = obs.counter_total("dispatch.fused_fallback")
        obs.reset()
        return y, rt, fb, c

    def breakdown(f, x, prog):
        """CUDA-event ms of each stage of the program run on its own, summed
        by the kind ``program_cost`` counts it as."""
        from repro_torch.combinators import FusedStage, Perm, run_program
        from repro_torch.kernels import ops
        t = f._resolve(x, False)[1]
        by = {}
        v = x
        for s in prog:
            if isinstance(s, FusedStage):
                kind = "fused"
            elif isinstance(s, Perm):
                kind = ops.class_plan(s.bmmc, t)[0]
            else:
                kind = "sweep"
            ms = cuda_ms(torch, lambda: run_program((s,), v, "cuda"), 3,
                         warmup=1)
            by[kind] = by.get(kind, 0.0) + ms
            v = run_program((s,), v, "cuda")
        return by

    def report(name, f, x, nbytes, prog, t, plan_s, rt, lib, lib_name):
        cost = program_cost(prog, t, x.element_size() * (
            x.shape[-1] if x.dim() == 2 else 1))
        check(rt == cost["round_trips"], (name, rt, cost["round_trips"]))
        ms = cuda_ms(torch, lambda: f(x), reps)
        stage_ms = cuda_ms(torch, lambda: f.call_per_stage(x),
                           max(3, reps // 3), warmup=1)
        lib_ms = cuda_ms(torch, lib, reps)
        gbs = cost["round_trips"] * 2 * nbytes / ms / 1e6
        say(f"  {name}: plan {plan_s:.3f} s (cold); round trips "
            f"{cost['round_trips']} (program_cost) = {int(rt)} (counted); "
            f"kernels {cost['kernels']}; graph {ms:.3f} ms "
            f"({gbs:.1f} GB/s effective), per stage {stage_ms:.3f} ms, "
            f"{lib_name} {lib_ms:.3f} ms")
        by = breakdown(f, x, prog)
        say(f"  {name}: stage ms by kind (each stage timed alone): " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(by.items())) +
            f"; sum {sum(by.values()):.3f}")
        say(f"  clocks, power, temperature: {clocks()}")

    x = torch.randint(-2**31, 2**31 - 1, (1 << n_sort,), generator=gen,
                      device=dev, dtype=torch.int64).to(torch.int32)
    f = S.compiled_sort(n_sort)
    prog, t, plan_s = plan_program(f, x)
    y, rt, fb, c = cold(S.sort, x)
    check(fb == 0, f"sort: {fb} fused clusters fell back")
    check(max_abs_err(torch, y, torch.sort(x).values) == 0.0, "sort")
    say(f"  sort of 2^{n_sort} int32: bit-equal to torch.sort; cold-call "
        f"launches {c}")
    check(max_abs_err(torch, f(x), torch.sort(x).values) == 0.0,
          "sort graph")
    say(f"  the sort's CUDA graph (its {c['tile']} K4a passes on the "
        f"{'narrow' if c['tile_narrow'] == c['tile'] else 'mixed'} "
        f"schedule): bit-equal to torch.sort")
    report(f"sort 2^{n_sort} int32", f, x, x.numel() * 4, prog, t, plan_s,
           rt, lambda: torch.sort(x), "torch.sort")
    del y
    torch.cuda.empty_cache()

    # the descending sort: not >> sort >> not, the maps fused into the
    # first and last clusters (a Map program runs eagerly, stage by stage)
    from repro_torch.combinators import compile_expr
    from repro_torch.combinators import vocab as V
    from repro_torch.combinators.sort import sort_expr
    fd = compile_expr(V.emap("not", torch.bitwise_not) >> sort_expr(n_sort)
                      >> V.emap("not", torch.bitwise_not))
    prog_d, t, _ = plan_program(fd, x)
    y, rt, fb, c = cold(fd, x)
    cost = program_cost(prog_d, t)["round_trips"]
    check(fb == 0, f"descending sort: {fb} fused clusters fell back")
    check(rt == cost, ("descending sort round trips", rt, cost))
    check(max_abs_err(torch, y, torch.sort(x, descending=True).values)
          == 0.0, "descending sort")
    check(c["tile_fused"] > 0, ("descending sort launches", c))
    ms_d = cuda_ms(torch, lambda: fd(x), reps)
    ms_graph = cuda_ms(torch, lambda: f(x), reps)
    ms_stage = cuda_ms(torch, lambda: f.call_per_stage(x), max(3, reps // 3),
                       warmup=1)
    lib_d = cuda_ms(torch, lambda: torch.sort(x, descending=True), reps)
    say(f"  descending sort of 2^{n_sort} int32 (not >> sort >> not): "
        f"bit-equal to torch.sort(descending=True); round trips {int(rt)} "
        f"(counted) = {cost} (program_cost); fused fallbacks 0; cold-call "
        f"launches {c}; {ms_d:.3f} ms (eager, stage by stage), the Map-free "
        f"sort {ms_graph:.3f} ms (graph) and {ms_stage:.3f} ms (stage by "
        f"stage), torch.sort(descending=True) {lib_d:.3f} ms")
    say(f"  clocks, power, temperature: {clocks()}")
    del y
    torch.cuda.empty_cache()

    z = torch.complex(torch.randn(1 << n_fft, generator=gen, device=dev),
                      torch.randn(1 << n_fft, generator=gen, device=dev))
    xr = F.to_planar(z)
    g = F.compiled_fft(n_fft)
    prog, t, plan_s = plan_program(g, xr)
    y, rt, fb, c = cold(F.fft_planar, xr)
    check(fb == 0, f"fft: {fb} fused clusters fell back")
    want = torch.fft.fft(z.to(torch.complex128))
    got = F.from_planar(y).to(torch.complex128)
    rel = float(torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want))
    check(y.shape == xr.shape and bool(torch.isfinite(y).all()), "fft shape")
    check(rel <= FFT_REL_TOL, ("fft relative error", rel))
    say(f"  FFT of 2^{n_fft} planar float32: norm-wise relative error "
        f"{rel:.3e} against torch.fft.fft in float64 (limit "
        f"{FFT_REL_TOL:g}); cold-call launches {c}")
    report(f"FFT 2^{n_fft} planar float32", g, xr, xr.numel() * 4, prog, t,
           plan_s, rt, lambda: torch.fft.fft(z), "torch.fft.fft")
    # the complex64 entry point runs the same kernels on the planar view
    y, rt_c, fb, c = cold(F.fft, z)
    check(fb == 0, f"complex fft: {fb} fused clusters fell back")
    check(rt_c == rt and c["tile_fused"] > 0, ("complex fft", rt_c, c))
    check(torch.equal(torch.view_as_real(y), F.fft_planar(xr)),
          "complex fft equals the planar one")
    say(f"  FFT of 2^{n_fft} complex64: equal to the planar FFT bit for "
        f"bit; cold-call launches {c}")
    return counts


# ---------------------------------------------------------------------------
# phases 11-14: validated, durable and resilient execution
# ---------------------------------------------------------------------------

GUARDED = {"block": "block_guarded", "lane": "lane_guarded",
           "tile": "tile_guarded", "tile_fused": "tile_fused_guarded"}
N_FAULT = 24              # log2 elements of phase 12's poisoned tables
N_MATRIX = 14             # log2 elements of phase 14's fault matrix


def dev_hash(torch, t) -> int:
    """A position-sensitive 64-bit checksum of ``t``'s bits, computed on
    its device in chunks: equal across processes exactly when the bits
    are (up to a 2^-64 chance)."""
    v = bits(torch, t).reshape(-1)
    h = 0
    for s in range(0, v.numel(), 1 << 26):
        c = v[s:s + (1 << 26)].to(torch.int64)
        idx = torch.arange(s, s + c.numel(), device=c.device,
                           dtype=torch.int64)
        h += int(((c + 0x2545F491) * (2 * idx + 1)).sum())
    return h & ((1 << 64) - 1)


class GuardedCase:
    """K2, K3 or K4a on ``x`` with one plan of phase 4's dispatch cases:
    the guarded launch (into its own flag word), the unguarded launch and
    the guarded plain version, all on the plan's device tables."""

    def __init__(self, torch, name, plan, x):
        from repro_torch.kernels import bmmc_permute as K
        self.name, self.plan, self.x, self.K = name, plan, x, K
        self.flags = torch.zeros(1, dtype=torch.int32, device=x.device)
        self.tabs = K.device_tables(plan, x.device)

    def guarded(self, flags=None):
        K, fl = self.K, self.flags if flags is None else flags
        if self.name == "block":
            return K.block_permute_tables(self.x, self.tabs[0], flags=fl,
                                          geometry=K.block_geometry(self.plan))
        if self.name == "lane":
            return K.lane_permute_tables(self.x, self.tabs[0], flags=fl,
                                         geometry=K.lane_geometry(self.plan))
        return K.tiled_permute_tables(self.x, *self.tabs, flags=fl,
                                      geometry=K.plan_geometry(self.plan))

    def unguarded(self):
        K = self.K
        return {"block": K.block_permute, "lane": K.lane_permute,
                "tile": K.tiled_permute}[self.name](self.x, self.plan)

    def plain(self, flags):
        K = self.K
        if self.name == "block":
            return K.block_permute_plain(self.x, self.plan, flags=flags,
                                         src_rows=self.tabs[0])
        if self.name == "lane":
            return K.lane_permute_plain(self.x, self.plan, flags=flags,
                                        src_lane=self.tabs[0])
        return K.tiled_permute_plain(self.x, self.plan, tables=self.tabs,
                                     flags=flags)


TABLE_NAMES = {"block": ("src_rows",), "lane": ("src_lane",),
               "tile": ("in_rows", "out_rows", "xor_low", "src0")}


def guarded_kernel_cases(torch, n: int, x) -> list:
    """A :class:`GuardedCase` of K2, K3 and K4a at 2^n (the block-class,
    lane-class and bit-reverse BMMCs of phase 4)."""
    from repro_torch.kernels import ops
    t = ops.choose_tile(n, 4)
    cases = {name: b for name, b, _ in make_cases(n, t)}
    out = []
    for name, case in (("block", "block-class"), ("lane", "lane-class"),
                       ("tile", "bit-reverse")):
        payload = ops.class_plan(cases[case], t)[1]
        out.append(GuardedCase(torch, name, payload if name != "tile"
                               else payload[0], x))
    return out


def phase_guarded(torch, n: int, n_sort: int, reps: int, bw: float,
                  records: dict, ab):
    """Phase 11: the main path with guards on (``ab``: phase 2's A/B
    library, for the guarded K4b before its schedule). Returns (launch
    counts of the guarded run, records of the guarded kernels, hashes of
    the unguarded outputs for phase 13)."""
    say(f"== phase 11: guarded main path (bmmc_permute on 2^{n} int32, "
        f"sort of 2^{n_sort} int32) ==")
    from repro_torch import guard, resilience
    from repro_torch.combinators import sort as S
    from repro_torch.combinators import execute as ex
    from repro_torch.guard import validate as gv
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randint(-2**31, 2**31 - 1, (1 << n,), generator=gen,
                      device=dev, dtype=torch.int64).to(torch.int32)
    t = ops.choose_tile(n, 4)
    cases = make_cases(n, t)
    # ring 1 at the paper's size: dispatch proof, table audits and the
    # fingerprint of every table, per case (plans already built)
    for name, b, _ in cases:
        kernel, payload = ops.class_plan(b, t)
        gv.validate_dispatch.cache_clear()
        t0 = time.perf_counter()
        gv.validate_dispatch(b.rows, b.c, t)
        v_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        gv.plan_fingerprint(kernel, payload)
        fp_s = time.perf_counter() - t0
        say(f"  ring 1 on {name} ({kernel}): validation with fingerprints "
            f"{v_s:.3f} s host, of which the fingerprint {fp_s:.3f} s")
    # the unguarded outputs, kept on the card to hold the guarded ones
    want = {name: ops.bmmc_permute(x, b) for name, b, _ in cases}
    hashes = {name: dev_hash(torch, y) for name, y in want.items()}
    xs = torch.randint(-2**31, 2**31 - 1, (1 << n_sort,), generator=gen,
                       device=dev, dtype=torch.int64).to(torch.int32)
    f = S.compiled_sort(n_sort)
    want_sort = f(xs)
    check(torch.equal(want_sort, torch.sort(xs).values), "unguarded sort")
    hashes["sort"] = dev_hash(torch, want_sort)
    torch.cuda.synchronize()

    # the counted run: every case once, then the sort twice (its first
    # call runs eagerly and captures the guarded graph, the second
    # replays it), each output held against its unguarded call
    guard.reset_stats()
    resilience.reset()
    K.reset_launch_counts()
    with guard.guarded():
        for name, b, _ in cases:
            got = ops.bmmc_permute(x, b)
            check(torch.equal(got, want[name]), ("guarded", name))
            del got
        for _ in range(2):
            check(torch.equal(f(xs), want_sort), "guarded sort")
    torch.cuda.synchronize()
    counts = K.launch_counts()
    st = guard.stats()
    say(f"  launch counts of the guarded run: {counts}")
    check(st["traps"] == {} and st["fallbacks"] == {} and not st["raised"],
          ("guarded run trapped", st))
    check(not resilience.board().engaged("cuda")
          and resilience.stats()["breaker"]["open"] == 0, "breaker")
    check(all(counts[k] == 0 for k in GUARDED), ("unguarded launches "
          "in the guarded run", counts))
    check(all(counts[g] > 0 for g in GUARDED.values()),
          ("guarded kernels not launched", counts))
    say("  six BMMCs and the sort bit-equal to their unguarded calls; "
        "traps 0, fallbacks 0, breaker closed")

    # guarded and unguarded calls in turns: one call and device time
    timed = (lambda fn: cuda_ms(torch, fn, reps))
    for name, b, _ in cases:
        def gcall(b=b):
            with guard.guarded():
                return ops.bmmc_permute(x, b)
        turns = in_turns({"guarded": gcall,
                          "unguarded": lambda b=b: ops.bmmc_permute(x, b)},
                         timed)
        gm, um = (statistics.median(turns[k]) for k in ("guarded",
                                                        "unguarded"))
        say(f"  {name:17s} one call: guarded {gm:.3f} ms, unguarded "
            f"{um:.3f} ms (in turns; the guarded call reads its flag "
            f"word back), overhead {100 * (gm / um - 1):+.2f} %")

    def gsort():
        with guard.guarded():
            return f(xs)
    turns = in_turns({"guarded": gsort, "unguarded": lambda: f(xs)}, timed)
    gm, um = (statistics.median(turns[k]) for k in ("guarded", "unguarded"))
    say(f"  sort 2^{n_sort} int32 one call (CUDA graphs): guarded {gm:.3f} "
        f"ms, unguarded {um:.3f} ms (in turns), overhead "
        f"{100 * (gm / um - 1):+.2f} %")
    del want
    torch.cuda.empty_cache()

    # each guarded kernel against its unguarded kernel and its plain
    # version, bit for bit, timed in turns (one call, device time)
    out = {}
    nbytes = x.numel() * 4
    for c in guarded_kernel_cases(torch, n, x):
        pflags = torch.zeros_like(c.flags)
        c.flags.zero_()
        got, ung = c.guarded(), c.unguarded()
        err = max(max_abs_err(torch, got, ung),
                  max_abs_err(torch, got, c.plain(pflags)))
        check(err == 0.0 and int(c.flags.item()) == 0
              and int(pflags.item()) == 0, (c.name, err))
        del got, ung
        turns = in_turns({"guarded": c.guarded, "unguarded": c.unguarded},
                         timed)
        gm, um = (statistics.median(turns[k]) for k in ("guarded",
                                                        "unguarded"))
        dturns = in_turns({"guarded": c.guarded, "unguarded": c.unguarded},
                          lambda fn: device_ms(torch, fn), rounds=1)
        gd, ud = (statistics.median(dturns[k]) for k in ("guarded",
                                                         "unguarded"))
        plain_ms = cuda_ms(torch, lambda: c.plain(pflags),
                           max(3, reps // 3), warmup=1)
        tab_bytes = sum(a.numel() * 4 for a in c.tabs)
        g = GUARDED[c.name]
        out[g] = {"ms": gm, "device_ms": gd, "plain_ms": plain_ms,
                  "bound_ms": (2 * nbytes + tab_bytes) / bw * 1e3,
                  "library_ms": records[c.name]["library_ms"],
                  "max_abs_err": err}
        say(f"  {g}: bit-equal to {c.name} and to its guarded plain "
            f"version; one call {gm:.3f} ms vs unguarded {um:.3f} ms, "
            f"device {gd:.4f} ms vs {ud:.4f} ms (in turns), guarded plain "
            f"{plain_ms:.3f} ms")
        torch.cuda.empty_cache()

    # K4b at the largest 2^n_sort sort cluster (phase 6's): guarded and
    # unguarded through the wrapper, and the guarded K4b before its
    # work-item schedule (tools/fused_ab.cu, a direct launch), in turns
    import fused_ab
    tf = ops.choose_tile(n_sort, 4)
    fs = max(fused_cases(n_sort, tf, "sort"), key=lambda s: len(s.computes))
    plans, entries = ex._fused_plan_cached(fs, tf)
    tabs, epi = ex._pass_tables(plans[0], entries, xs)
    geo = K.plan_geometry(plans[0])
    flags = torch.zeros(1, dtype=torch.int32, device=dev)
    oflags = torch.zeros_like(flags)
    g = (lambda: K.tiled_permute_tables(xs, *tabs, geometry=geo,
                                        flags=flags, **epi))
    u = (lambda: K.tiled_permute_tables(xs, *tabs, geometry=geo, **epi))
    pl = (lambda: K.tiled_permute_tables_plain(xs, *tabs, geometry=geo,
                                               flags=flags, **epi))
    old = fused_ab.cluster_calls(ab[0], fs, tf, xs, flags=oflags)[0]
    got = g()
    err = max(max_abs_err(torch, got, u()), max_abs_err(torch, got, pl()),
              max_abs_err(torch, got, old()))
    check(err == 0.0 and int(flags.item()) == 0 and int(oflags.item()) == 0,
          ("tile_fused_guarded", err))
    fns = {"old guarded": old, "guarded": g, "unguarded": u}
    turns = in_turns(fns, timed)
    dturns = in_turns(fns, lambda fn: device_ms(torch, fn), rounds=1)
    med = {k: statistics.median(v) for k, v in turns.items()}
    dmed = {k: statistics.median(v) for k, v in dturns.items()}
    plain_ms = cuda_ms(torch, pl, max(3, reps // 3), warmup=1)
    rec = records["tile_fused"]
    out["tile_fused_guarded"] = {
        "ms": med["guarded"], "device_ms": dmed["guarded"],
        "old_ms": med["old guarded"], "old_device_ms": dmed["old guarded"],
        "plain_ms": plain_ms, "bound_ms": rec["bound_ms"],
        "library_ms": rec["library_ms"], "max_abs_err": err}
    say(f"  tile_fused_guarded (largest 2^{n_sort} int32 sort cluster, "
        f"{len(fs.computes)} cmp epilogues): bit-equal to tile_fused, to "
        f"its guarded plain version and to the guarded K4b before its "
        f"schedule; in turns (old guarded, guarded, unguarded, and back) "
        f"one call {turns} ms, device {dturns} ms; medians one call "
        f"{med['guarded']:.4f} ms against unguarded {med['unguarded']:.4f} "
        f"and old guarded {med['old guarded']:.4f}, device "
        f"{dmed['guarded']:.4f} ms against {dmed['unguarded']:.4f} and "
        f"{dmed['old guarded']:.4f} (bound {rec['bound_ms']:.4f}); guarded "
        f"plain {plain_ms:.3f} ms")
    say(f"  clocks, power, temperature: {clocks()}")
    torch.cuda.empty_cache()
    return counts, out, hashes


def phase_traps(torch, n: int):
    """Phase 12: poisoned tables on the card at 2^n."""
    say(f"== phase 12: traps on the card (2^{n} int32) ==")
    from repro_torch import guard, resilience
    from repro_torch.combinators import execute as ex
    from repro_torch.combinators import sort as S
    from repro_torch.core.bmmc import Bmmc
    from repro_torch.guard import inject
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    x = torch.randint(0, 1 << 30, (1 << n,), device=dev, dtype=torch.int32,
                      generator=torch.Generator(device=dev).manual_seed(5))
    ex.clear_caches()
    for c in guarded_kernel_cases(torch, n, x):
        clean = c.unguarded()
        for ti, tname in enumerate(TABLE_NAMES[c.name]):
            for value in (1 << 30, -1):
                pflags = torch.zeros_like(c.flags)
                with inject.poison_device_table(c.plan, dev, index=0,
                                                table=ti, value=value):
                    c.flags.zero_()
                    got = c.guarded()
                    want = c.plain(pflags)
                    bit, pbit = int(c.flags.item()), int(pflags.item())
                    check(bit == 1 and pbit == 1, (c.name, tname, value,
                                                   bit, pbit))
                    if tname != "out_rows":   # an unwritten row is undefined
                        check(torch.equal(got, want), (c.name, tname, value))
                # the next unguarded launch: no sticky error
                again = c.unguarded()
                torch.cuda.synchronize()
                check(torch.equal(again, clean), (c.name, "after the trap"))
        say(f"  {GUARDED[c.name]}: an entry of {'/'.join(TABLE_NAMES[c.name])} "
            f"set to 2^30 or -1 on the card sets bit 1, as the guarded plain "
            f"version does (outputs equal where defined); the next unguarded "
            f"launch succeeds, bit-equal")
        del clean, got, want, again
    # K4b: each table of a sort cluster's pass poisoned on the card only
    t = ops.choose_tile(n, 4)
    fs = max(fused_cases(n, t, "sort"), key=lambda s: len(s.computes))
    plans, entries = ex._fused_plan_cached(fs, t)
    tabs, epi = ex._pass_tables(plans[0], entries, x)
    geo = K.plan_geometry(plans[0])
    clean = K.tiled_permute_tables(x, *tabs, geometry=geo, **epi)
    flags = torch.zeros(1, dtype=torch.int32, device=dev)
    row_len = 1 << geo[1]
    for ti, tname in enumerate(TABLE_NAMES["tile"]):
        # a bad output row id leaves that row unwritten: compare the rest
        keep = torch.ones(1 << n, dtype=torch.bool, device=dev)
        if tname == "out_rows":
            r0 = int(plans[0].out_rows.reshape(-1)[0])
            keep[r0 * row_len:(r0 + 1) * row_len] = False
        for value in (1 << 30, -1):
            flags.zero_()
            pflags = torch.zeros_like(flags)
            with inject.poison_device_table(plans[0], dev, table=ti,
                                            value=value):
                got = K.tiled_permute_tables(x, *tabs, geometry=geo,
                                             flags=flags, **epi)
                pw = K.tiled_permute_tables_plain(x, *tabs, geometry=geo,
                                                  flags=pflags, **epi)
                check(int(flags.item()) == 1 and int(pflags.item()) == 1
                      and torch.equal(got[keep], pw[keep]),
                      ("tile_fused_guarded trap", tname, value))
            again = K.tiled_permute_tables(x, *tabs, geometry=geo, **epi)
            torch.cuda.synchronize()
            check(torch.equal(again, clean), ("tile_fused after the trap",
                                              tname, value))
    say(f"  tile_fused_guarded: an entry of "
        f"{'/'.join(TABLE_NAMES['tile'])} of a sort cluster's pass set to "
        f"2^30 or -1 on the card sets bit 1, as its guarded plain version "
        f"does (outputs bit-equal where defined: all but the row a bad "
        f"output id names); the next unguarded launch succeeds, bit-equal")

    # through the entry points: the cuda -> ref fallback
    b = Bmmc.bit_reverse(n)
    oracle = ref.bmmc_ref_device(x, b)
    guard.reset_stats()
    resilience.reset()
    with guard.guarded():
        ops.bmmc_permute(x, b)
        with inject.poison_plan(b, t):
            check(torch.equal(ops.bmmc_permute(x, b), oracle),
                  "host-poisoned plan: fallback")
        plan = ops.class_plan(b, t)[1][0]
        with inject.poison_device_table(plan, dev):
            check(torch.equal(ops.bmmc_permute(x, b), oracle),
                  "device-poisoned plan: fallback")
        ns = min(N_MATRIX, n)   # the ref fallback runs a sort stage by stage
        xs = x[:1 << ns]
        f = S.compiled_sort(ns)
        ts = ops.choose_tile(ns, 4)
        want_sort = torch.sort(xs).values
        check(torch.equal(f(xs), want_sort), "guarded sort")
        fs0 = next(s for s in f.clustered_program(ns, ts)
                   if getattr(s, "computes", ()))
        with inject.poison_device_table(
                ex._fused_plan_cached(fs0, ts)[0][0], dev):
            check(torch.equal(f(xs), want_sort), "poisoned sort: fallback")
    st = guard.stats()
    # a skipped access may also show in the parity sample (bit 4)
    check(st["traps"].get(("oob", "cuda")) == 3
          and {k for k, _ in st["traps"]} <= {"oob", "parity"}
          and st["fallbacks"] == {"ref": 3} and st["recovered"] == 3,
          ("fallback stats", st))
    say(f"  guarded bmmc_permute at 2^{n} with a poisoned plan (the host "
        f"table, then the card's copy only) and the guarded sort of 2^{ns} "
        f"with a poisoned K4b table on the card: each traps on the card, "
        f"falls back to ref and equals the oracle; guard stats {st}")
    with guard.guarded(), inject.poison_ref_table(b):
        try:
            ops.bmmc_permute(x, b, engine="ref")
            check(False, "a poisoned ref table did not raise")
        except (guard.GuardTrap, guard.CachePoisoned) as e:
            say(f"  guarded ref with a poisoned gather table raises "
                f"{type(e).__name__} (no crash)")
    check(torch.equal(ops.bmmc_permute(x, b), oracle), "after the ref trap")
    torch.cuda.synchronize()
    say("  the next unguarded launches succeed: no sticky error")
    ex.clear_caches()
    torch.cuda.empty_cache()


def store_child(args) -> int:
    """Phase 13's subprocess: drive the 2^n BMMCs of ``STORE_CASES``, the
    2^n_sort sort
    and its float32 gradient against the store at ``args.store_child``;
    write first-call latencies, output hashes and store stats as JSON."""
    import torch
    from repro_torch import store
    from repro_torch.combinators import sort as S
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    store.configure(args.store_child)
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randint(-2**31, 2**31 - 1, (1 << args.n,), generator=gen,
                      device=dev, dtype=torch.int64).to(torch.int32)
    xs = torch.randint(-2**31, 2**31 - 1, (1 << args.n_sort,), generator=gen,
                       device=dev, dtype=torch.int64).to(torch.int32)
    rec = {"first_s": {}, "plans_s": {}, "warm_s": {}, "hash": {}}

    def timed(name, fn, plans=None):
        """The first call (its plans built or loaded by ``plans`` first,
        timed on their own, when given) and a second, warm call."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if plans is not None:
            plans()
            rec["plans_s"][name] = time.perf_counter() - t0
        y = fn()
        torch.cuda.synchronize()
        rec["first_s"][name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        y = fn()
        torch.cuda.synchronize()
        rec["warm_s"][name] = time.perf_counter() - t0
        rec["hash"][name] = dev_hash(torch, y)

    t = ops.choose_tile(args.n, 4)
    for name, b, _ in make_cases(args.n, t):
        if name in STORE_CASES:
            timed(name, lambda b=b: ops.bmmc_permute(x, b),
                  lambda b=b: ops.class_plan(b, t))
    f = S.compiled_sort(args.n_sort)

    def sort_plans():
        t0 = time.perf_counter()
        f._resolve(xs, False)     # lowering and clustering: not stored
        rec["resolve_s"] = time.perf_counter() - t0
        plan_program(f, xs)
    timed("sort", lambda: f(xs), sort_plans)
    g = torch.Generator(device=dev).manual_seed(13)
    xf = (torch.randperm(1 << args.n_sort, generator=g, device=dev)
          .to(torch.float32) * 0.5 - 7.0)
    w = torch.randn(1 << args.n_sort, generator=g, device=dev)

    def grad():
        v = xf.clone().requires_grad_()
        (w * S.sort(v)).sum().backward()
        return v.grad
    timed("sort_grad", grad)
    rec["stats"] = store.stats()
    st = store.active()
    rec["entries"] = st.entry_count()
    rec["bytes"] = sum(p.stat().st_size
                       for p in Path(st.objects).rglob("*.plan"))
    Path(args.child_out).write_text(json.dumps(rec))
    return 0


def phase_store(torch, n: int, n_sort: int, hashes: dict):
    """Phase 13: a store populated by one process and replayed by a fresh
    one; then the disk-fault matrix."""
    say(f"== phase 13: store warm start ({len(STORE_CASES)} 2^{n} BMMCs, "
        f"sort of 2^{n_sort}, its float32 gradient) ==")
    import tempfile
    from repro_torch.guard import inject
    root = tempfile.mkdtemp(prefix="repro-torch-store-")
    got = []
    for label in ("cold", "disk-warm"):
        out = Path(root) / f"{label}.json"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--store-child",
             str(Path(root) / "store"), "--child-out", str(out), "--n",
             str(n), "--n-sort", str(n_sort)], capture_output=True, text=True)
        check(proc.returncode == 0, (label, proc.stdout[-3000:],
                                     proc.stderr[-3000:]))
        rec = json.loads(out.read_text())
        got.append(rec)
        say(f"  {label} process: {time.perf_counter() - t0:.1f} s in all; "
            f"store stats {rec['stats']}; {rec['entries']} entries, "
            f"{rec['bytes'] / 2**20:.1f} MiB on disk")
    cold, warm = got
    check(cold["stats"]["plan_built"] > 0 and cold["stats"]["write"] > 0,
          ("cold process", cold["stats"]))
    check(warm["stats"]["plan_built"] == 0 and warm["stats"]["miss"] == 0
          and warm["stats"]["hit"] > 0, ("disk-warm process built plans",
                                         warm["stats"]))
    check(cold["hash"] == warm["hash"], "outputs differ between processes")
    from repro_torch.kernels import ops
    left_out = {name for name, _, _ in make_cases(
        n, ops.choose_tile(n, 4))} - set(STORE_CASES)
    for name, h in hashes.items():
        if name not in left_out:
            check(cold["hash"].get(name) == h,
                  (name, "differs from this process"))
    for name in cold["first_s"]:
        plans = ("" if name not in cold["plans_s"] else
                 f" (of which resolving and planning or loading plans "
                 f"{cold['plans_s'][name]:.3f} s, {warm['plans_s'][name]:.3f}"
                 f" s)")
        say(f"  {name:17s} first call: cold {cold['first_s'][name]:.3f} s, "
            f"disk-warm {warm['first_s'][name]:.3f} s{plans}; warm (second "
            f"call) {warm['warm_s'][name]:.4f} s")
    say(f"  sort: lowering and clustering {cold['resolve_s']:.3f} s cold, "
        f"{warm['resolve_s']:.3f} s disk-warm (the store keeps plans, not "
        f"programs)")
    say("  the disk-warm process built 0 plans, only hits; every output "
        "bit-equal to the cold process's (64-bit checksums) and to this "
        "process's")
    rep = inject.run_disk_fault_matrix(n=N_MATRIX, device="cuda")
    for c in rep["cases"]:
        say(f"  {c['kind']:22s} caught={c['caught']}  {c['how']}")
    check(rep["caught"] == rep["injected"] == 5, rep)
    import shutil
    shutil.rmtree(root, ignore_errors=True)


def phase_chaos(torch):
    """Phase 14: ring 3's fault matrix and the chaos soak on the card."""
    say("== phase 14: ring 3 and the chaos soak ==")
    from repro_torch.guard import inject
    from repro_torch.resilience import chaos
    rep = inject.run_fault_matrix("cuda", n=N_MATRIX, device="cuda")
    for c in rep["cases"]:
        say(f"  {c['kind']:22s} caught={c['caught']}  {c['how']}")
    check(rep["caught"] == rep["injected"] == len(inject.FAULT_KINDS)
          and not any("SILENT" in c["how"] for c in rep["cases"]), rep)
    say(f"  fault matrix at 2^{N_MATRIX}: {rep['caught']}/{rep['injected']} "
        f"caught, none silently wrong")
    for r in chaos.run_matrix(device="cuda"):
        say("  " + r.summary())
        check(r.passed and r.silent_wrong == 0
              and r.traps_while_open == 0, r.summary())
    say("  every soak SLO met")


# ---------------------------------------------------------------------------
# phase 15: serving a full-width model
# ---------------------------------------------------------------------------

SERVE_ARCH = "mistral-nemo-12b"   # the repo's default architecture
SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS = 4, 512, 32
# One decode step's logits against a prefill over the extended sequence
# (the card's counterpart of
# tests/test_models.py::test_decode_matches_prefill_continuation, which
# holds a 2-layer, 64-wide float32 model to rtol = atol = 2e-4), as a
# norm-wise relative error: in bfloat16 within DECODE_REL_TOL and in
# float32 within DECODE_F32_REL_TOL, both at full width and depth. The
# two paths compute the same function but sum in other orders (other
# product shapes), and the differences add up over the 40 layers.
# tools/decode_vs_prefill.py on an H100: bfloat16 7.6e-3 after 1 layer,
# 2.7e-2 after 10, 6.3e-2 after 40; float32 3.0e-5 after 40, where the
# same float32 prefill at batch 4 and one row at a time already differs
# by 2.9e-5 (the floor of the products' orders). A decode fault (a wrong
# position, cache entry or mask) moves the logits by their own size.
DECODE_REL_TOL = 1e-1
DECODE_F32_REL_TOL = 1e-3
# The same, for the prefill logits with the shuffle on against off, if the
# card's matrix products do not give them bit for bit (the shuffle only
# moves whole heads between the batches of one batched product, so they
# are expected bit-equal; this bounds what the run prints if not).
SHUFFLE_OFF_REL_TOL = 1e-2


def rel_err(torch, got, want) -> float:
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


def shuffle_kernel_cases(torch, cfg, tokens: int):
    """The three shapes and types the kv-head shuffle gives K4a in one
    prefill layer, with how many of its four calls take each."""
    kv, hd, g = cfg.n_kv_heads, cfg.hd, cfg.n_heads // cfg.n_kv_heads
    return [("k, v", (tokens, kv, hd), torch.bfloat16, 2),
            ("q groups", (tokens, kv, g * hd), torch.bfloat16, 1),
            ("output", (tokens, kv, g * hd), torch.float32, 1)]


STATE_KEYS = ("conv", "state", "h")     # the carried states of mamba / rec


def decode_against_prefill(torch, M, cfg, params, prompts,
                           src=None, mesh=None) -> dict:
    """Prefill ``prompts`` (with the source embeddings ``src`` of an
    encoder-decoder or VLM configuration), decode one greedy token, and
    hold its logits against a prefill of the prompts plus that token:
    ``rel`` (norm-wise relative error), ``agree`` (rows whose argmax
    agrees), ``max_abs``; ``state_err``, the carried states (conv tails,
    SSD and RG-LRU states) after the decode step against the longer
    prefill's (None without such states); and for an MoE configuration
    the experts each routing layer chose for the decoded token in the two
    paths (``flips``, ``rows_flipped``, ``rel_kept``), recorded pass by
    pass. A row whose token was routed to other experts in some layer
    (its hidden state differs by the paths' roundings, and the top-k
    choice is a step function of it) has other logits by the experts'
    outputs; the logits of the other rows are compared on their own.
    With a ``mesh`` every pass runs on it (routing through the all-to-all
    branch where the configuration takes it)."""
    from repro_torch.models import moe as MOE
    from repro_torch.models import moe_a2a as A2A
    p, b = prompts.shape[1], prompts.shape[0]
    extra = {} if src is None else {"src": src}
    passes = {"prefill": [], "decode": [], "longer": []}
    calls = passes["prefill"]       # the routing ids of the running pass
    real = MOE.router_topk

    def spy(logits, k):
        out = real(logits, k)
        # (1, tokens, k): the a2a branch routes (tokens, k) on one rank
        calls.append(out[1].sort(dim=-1).values.reshape(1, -1, k))
        return out

    def carried(caches):
        return [t for g in caches.values() for blk in g.values()
                for k, t in blk.items() if k in STATE_KEYS]

    MOE.router_topk = A2A.router_topk = spy
    try:
        with torch.no_grad():
            logits, caches = M.prefill(cfg, params,
                                       {"tokens": prompts, **extra},
                                       mesh=mesh)
            caches = M.grow_caches(caches, p, p + 1)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            calls = passes["decode"]
            dec, caches = M.decode_step(cfg, params, caches, tok, p,
                                        mesh=mesh)
            mine = carried(caches)
            del logits
            calls = passes["longer"]
            full, fcaches = M.prefill(cfg, params, {"tokens": torch.cat(
                [prompts, tok], dim=1), **extra}, mesh=mesh)
            theirs = carried(fcaches)
            state_err = (max(rel_err(torch, x, y)
                             for x, y in zip(mine, theirs))
                         if mine else None)
            del caches, fcaches, mine, theirs
    finally:
        MOE.router_topk = A2A.router_topk = real
    n = len(passes["prefill"])       # routing layers a pass
    check(len(passes["decode"]) == len(passes["longer"]) == n
          and (n > 0) == bool(cfg.n_experts),
          ("router calls a pass", {k: len(v) for k, v in passes.items()}))
    flipped = torch.zeros(b, dtype=torch.bool, device=dec.device)
    flips = 0
    for d, f in zip(passes["decode"], passes["longer"]):
        check(d.shape[:2] == (1, b) and f.shape[:2] == (1, b * (p + 1)),
              ("one routing group a pass", d.shape, f.shape))
        rows = (d[0] != f[0].reshape(b, p + 1, -1)[:, -1]).any(-1)
        flips += int(rows.sum())
        flipped |= rows
    keep = ~flipped
    return {"rel": rel_err(torch, dec, full),
            "agree": int((dec.argmax(-1) == full.argmax(-1)).sum()),
            "max_abs": float((dec - full).abs().max()),
            "state_err": state_err, "routing_layers": n, "flips": flips,
            "rows_flipped": int(flipped.sum()),
            "rel_kept": (rel_err(torch, dec[keep], full[keep])
                         if bool(keep.any()) else None)}


def phase_serve(torch, bw: float, reps: int, smi: str, old_so):
    """Phase 15: serve full-width Mistral-NeMo-12B through the port's serve
    loop with the kv-head shuffle on ``cuda``, ``ref`` and off. Returns
    the record of K4a on the serving path and its launches."""
    import dataclasses
    import gc
    from repro_torch import guard
    from repro_torch.combinators import clear_caches
    from repro_torch.configs import get_config
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve as S
    from repro_torch.models import model as M
    from repro_torch.models.attention import default_head_perm
    from repro_torch.resilience import chaos

    cfg = get_config(SERVE_ARCH)
    say(f"== phase 15: serve {cfg.name} at full width ({cfg.n_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.n_heads} q / {cfg.n_kv_heads} "
        f"kv heads, head_dim {cfg.hd}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {str(cfg.dtype).split('.')[-1]}), batch "
        f"{SERVE_BATCH}, prompt {SERVE_PROMPT}, {SERVE_TOKENS} new tokens ==")
    say(f"  card: {smi}")
    clear_caches()          # the earlier phases' plans and device tables
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda")
    hp = default_head_perm(cfg.n_kv_heads)
    check(hp is not None, cfg.n_kv_heads)
    rows = SERVE_BATCH * SERVE_PROMPT

    # K4a at the three shuffle shapes: bit for bit against its plain
    # version and the plain gather, timed in turns with index_select and
    # the K4a its redesign replaced (behind the host path it had), one call
    # through tiled_permute and through permute_axis (what the prefill
    # calls), and on the device
    import k4a_sweep
    from repro_torch.models.permute import permute_axis
    old = k4a_sweep.old_k4a(old_so, K)
    gen = torch.Generator(device=dev).manual_seed(15)
    idx = ref.bmmc_src_index(hp, dev)
    rec = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "bound_ms": 0.0, "max_abs_err": 0.0, "permute_axis_ms": 0.0,
           "old_ms": 0.0, "old_device_ms": 0.0, "library_device_ms": 0.0}
    timed = (lambda fn: cuda_ms(torch, fn, reps))
    for label, shape, dtype, calls in shuffle_kernel_cases(torch, cfg, rows):
        x4 = torch.randn((SERVE_BATCH, SERVE_PROMPT) + shape[1:],
                         generator=gen, device=dev).to(dtype)
        x = x4.reshape(shape)
        t = ops.choose_tile(hp.n, x.element_size(), shape[2])
        kernel, plans = ops.class_plan(hp, t)
        check(kernel == "tiled" and len(plans) == 1, (label, kernel, t))
        plan = plans[0]
        got = K.tiled_permute(x, plan, batched=True)
        sched = K.k4a_record(x, plan, batched=True).schedule
        err = max(max_abs_err(torch, got, K.tiled_permute_plain(
            x, plan, batched=True)), max_abs_err(torch, got, ref.bmmc_ref(
                x, hp, batched=True)), max_abs_err(torch, ops.bmmc_permute(
                    x, hp, batched=True), got), max_abs_err(
                        torch, permute_axis(x4, hp, axis=2, engine="cuda")
                        .reshape(shape), got), max_abs_err(
                            torch, old(x, plan, batched=True), got))
        check(err == 0.0, (label, err))
        fns = {"kernel": lambda: K.tiled_permute(x, plan, batched=True),
               "permute_axis": lambda: permute_axis(x4, hp, axis=2,
                                                    engine="cuda"),
               "library": lambda: torch.index_select(x, 1, idx),
               "old": lambda: old(x, plan, batched=True)}
        turns = in_turns(fns, timed)
        one = {k: statistics.median(v) for k, v in turns.items()}
        dturns = in_turns({k: fns[k] for k in ("kernel", "library", "old")},
                          lambda fn: device_ms(torch, fn), rounds=1)
        dv = {k: statistics.median(v) for k, v in dturns.items()}
        plain_ms = cuda_ms(torch, lambda: K.tiled_permute_plain(
            x, plan, batched=True), max(3, reps // 3), warmup=1)
        tab_bytes = sum(a.numel() * 4 for a in K.device_tables(plan, dev))
        bound_ms = (2 * x.numel() * x.element_size() + tab_bytes) / bw * 1e3
        for k, v in (("ms", one["kernel"]), ("device_ms", dv["kernel"]),
                     ("plain_ms", plain_ms), ("library_ms", one["library"]),
                     ("bound_ms", bound_ms),
                     ("permute_axis_ms", one["permute_axis"]),
                     ("old_ms", one["old"]), ("old_device_ms", dv["old"]),
                     ("library_device_ms", dv["library"])):
            rec[k] += calls * v
        say(f"  K4a {label} {tuple(shape)} {str(dtype).split('.')[-1]} "
            f"(t={t}, {sched.schedule} schedule, x{calls} a layer): "
            f"bit-equal to its plain version, the gather, permute_axis "
            f"and the old K4a; one call (in turns): tiled_permute "
            f"{one['kernel']:.4f} ms, permute_axis "
            f"{one['permute_axis']:.4f} ms, index_select "
            f"{one['library']:.4f} ms, old K4a {one['old']:.4f} ms; device "
            f"(in turns): kernel {dv['kernel']:.4f} ms, index_select "
            f"{dv['library']:.4f} ms, old K4a {dv['old']:.4f} ms; plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms")
    say(f"  the four shuffles of one layer: one call: tiled_permute "
        f"{rec['ms']:.4f} ms, permute_axis {rec['permute_axis_ms']:.4f} ms, "
        f"index_select {rec['library_ms']:.4f} ms, old K4a "
        f"{rec['old_ms']:.4f} ms; device: kernel {rec['device_ms']:.4f} ms, "
        f"index_select {rec['library_device_ms']:.4f} ms, old K4a "
        f"{rec['old_device_ms']:.4f} ms; plain {rec['plain_ms']:.4f} ms, "
        f"bound {rec['bound_ms']:.4f} ms")
    del x, x4, got
    torch.cuda.empty_cache()

    # the model, from a seed, on the card
    t0 = time.perf_counter()
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_bytes = sum(p.numel() * p.element_size()
                  for p in M.LM(cfg, params).parameters())
    say(f"  init: {init_s:.2f} s, {n_bytes / 1e9:.2f} GB of parameters on "
        f"the card")
    args = S.parse_args(["--arch", cfg.name, "--batch", str(SERVE_BATCH),
                         "--prompt-len", str(SERVE_PROMPT),
                         "--tokens", str(SERVE_TOKENS)])
    prompts = S.make_prompts(cfg, args, dev)
    engines = {"cuda": "cuda", "ref": "ref", "off": None}
    cfgs = {k: dataclasses.replace(cfg, head_shuffle=e)
            for k, e in engines.items()}

    # the serving path with the shuffle on cuda: K4a in every prefill
    # layer, counted from 0
    K.reset_launch_counts()
    first = S.serve(cfgs["cuda"], params, args, prompts)
    counts = K.launch_counts()
    check(not first.errors and first.gen is not None, first.errors)
    launches = counts["tile"]
    say(f"  serving path, shuffle on cuda: kernel launches {counts}")
    check(launches == 4 * cfg.n_layers == counts["tile_wide"], (
        "K4a launches on the serving path", launches, 4 * cfg.n_layers))
    check(sum(v for k, v in counts.items()
              if k not in ("tile", "tile_wide")) == 0, counts)

    runs = {"cuda": [first]}
    for k in ("ref", "off", "off", "ref", "cuda"):     # in turns
        res = S.serve(cfgs[k], params, args, prompts)
        check(not res.errors and res.gen is not None, (k, res.errors))
        runs.setdefault(k, []).append(res)
    want = runs["cuda"][0]
    for k, rs in runs.items():
        for r in rs:
            check(np.array_equal(r.gen, want.gen), (k, "greedy tokens"))
            check(r.gen.shape == (SERVE_BATCH, SERVE_TOKENS), r.gen.shape)
            check(bool(torch.isfinite(r.prefill_logits).all()), k)
    err = max_abs_err(torch, runs["ref"][0].prefill_logits,
                      want.prefill_logits)
    check(err == 0.0, ("prefill logits, shuffle cuda against ref", err))
    off_err = max_abs_err(torch, runs["off"][0].prefill_logits,
                          want.prefill_logits)
    if off_err == 0.0:
        say("  prefill logits bit-equal with the shuffle on cuda, on ref "
            "and off; greedy tokens equal in all six runs")
    else:
        rel = rel_err(torch, runs["off"][0].prefill_logits,
                      want.prefill_logits)
        say(f"  prefill logits: cuda and ref bit-equal; shuffle off NOT "
            f"bit-equal (norm-wise relative {rel:.3e}, within "
            f"{SHUFFLE_OFF_REL_TOL}); greedy tokens equal in all six runs")
        check(rel <= SHUFFLE_OFF_REL_TOL, ("shuffle off", rel))
    for k, rs in runs.items():
        steps = [s for r in rs for s in r.step_s[1:]]   # warm steps
        dec = [r.decode_s for r in rs]
        rate = [SERVE_BATCH * r.gen.shape[1] / r.decode_s for r in rs]
        say(f"  shuffle {k:4s}: prefill "
            f"{', '.join(f'{r.prefill_s * 1e3:.1f}' for r in rs)} ms; warm "
            f"decode {statistics.median(steps) * 1e3:.2f} ms/token (median "
            f"of {len(steps)} steps); decode "
            f"{', '.join(f'{d:.3f}' for d in dec)} s, "
            f"{', '.join(f'{v:.1f}' for v in rate)} tokens/s")

    # the shuffle's share of a prefill: prefills alone, in turns
    def prefill_s(c):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = M.prefill(c, params, {"tokens": prompts})
        torch.cuda.synchronize()
        del out
        return time.perf_counter() - t0
    pre = in_turns({k: (lambda c=cfgs[k]: c) for k in ("cuda", "off")},
                   lambda c: prefill_s(c()), rounds=3)
    med = {k: statistics.median(v) * 1e3 for k, v in pre.items()}
    say(f"  prefill alone, in turns (6 each): shuffle cuda "
        f"{med['cuda']:.1f} ms ({min(pre['cuda']) * 1e3:.1f}-"
        f"{max(pre['cuda']) * 1e3:.1f}), off {med['off']:.1f} ms "
        f"({min(pre['off']) * 1e3:.1f}-{max(pre['off']) * 1e3:.1f}); "
        f"cuda - off {med['cuda'] - med['off']:.1f} ms")

    # one decode step against a prefill over the extended sequence
    d = decode_against_prefill(torch, M, cfgs["cuda"], params, prompts)
    rel, agree, max_abs = d["rel"], d["agree"], d["max_abs"]
    say(f"  bfloat16 decode step vs prefill of {SERVE_PROMPT + 1} tokens: "
        f"norm-wise relative {rel:.3e} (tolerance {DECODE_REL_TOL}), max "
        f"abs {max_abs:.4f}, argmax equal in {agree}/{SERVE_BATCH} rows")
    check(rel <= DECODE_REL_TOL, ("decode vs prefill", rel))

    # --validate: the guarded kernels, zero traps
    guard.reset_stats()
    guard.enable()
    try:
        K.reset_launch_counts()
        # the same horizon as the unguarded runs: decode sums over the
        # grown cache, so another length would round otherwise
        vargs = S.parse_args(["--arch", cfg.name, "--batch",
                              str(SERVE_BATCH), "--prompt-len",
                              str(SERVE_PROMPT), "--tokens",
                              str(SERVE_TOKENS), "--validate"])
        vres = S.serve(cfgs["cuda"], params, vargs, prompts)
        vcounts = K.launch_counts()
        gs = guard.stats()
    finally:
        guard.disable()
    check(not vres.errors and vres.gen is not None, vres.errors)
    check(np.array_equal(vres.gen, want.gen), "validated tokens")
    check(max_abs_err(torch, vres.prefill_logits, want.prefill_logits)
          == 0.0, "validated prefill logits")
    traps = sum(gs["traps"].values())
    fallbacks = sum(gs["fallbacks"].values())
    say(f"  --validate: tile_guarded launches {vcounts['tile_guarded']}, "
        f"unguarded tile {vcounts['tile']}; traps {traps}, fallbacks "
        f"{fallbacks}; logits and tokens equal to the unguarded run")
    check(vcounts["tile_guarded"] == 4 * cfg.n_layers
          and vcounts["tile"] == 0 and traps == 0 and fallbacks == 0,
          (vcounts, gs))
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(f"  peak device memory of the bfloat16 serving runs: {peak:.2f} GiB")
    del params, runs, first, want, vres
    gc.collect()
    torch.cuda.empty_cache()

    # the decode check in float32 at full width and depth (49 GB of
    # parameters)
    c32 = dataclasses.replace(cfgs["cuda"], dtype=torch.float32)
    params = M.init(c32, torch.Generator(device=dev).manual_seed(0))
    d = decode_against_prefill(torch, M, c32, params, prompts)
    rel, agree, max_abs = d["rel"], d["agree"], d["max_abs"]
    say(f"  float32 decode step vs prefill of {SERVE_PROMPT + 1} tokens: "
        f"norm-wise relative {rel:.3e} (tolerance {DECODE_F32_REL_TOL}), "
        f"max abs {max_abs:.2e}, argmax equal in {agree}/{SERVE_BATCH} rows")
    check(rel <= DECODE_F32_REL_TOL, ("float32 decode vs prefill", rel))
    del params
    gc.collect()
    torch.cuda.empty_cache()

    drill = chaos.sigterm_drill(timeout_s=180.0, device="cuda")
    say(f"  sigterm drill on the card: started={drill['started']} "
        f"rc={drill['returncode']} drained={drill['drained']} "
        f"traceback={drill['traceback']}")
    check(drill["ok"], drill["output"][-3000:])
    rec["launches"] = launches
    return rec


# ---------------------------------------------------------------------------
# phase 16: training a full-width model
# ---------------------------------------------------------------------------

# Mistral-NeMo-12B at full width, cut from 40 layers to TRAIN_LAYERS: at 12
# bytes a parameter (bf16 weights and gradients, float32 moments) the 40
# layers' 12.25 B parameters need 147 GB, the 4 layers' 2.43 B 29.2 GB.
TRAIN_LAYERS = 4
TRAIN_BATCH, TRAIN_SEQ = 4, 512     # the serving cell's shapes
TRAIN_STEPS = 10
TRAIN_FIXED_STEPS = 5               # steps on one batch whose loss must fall
TRAIN_SORT_N = 20                   # log2 keys of the sort layer's step
CKPT_PROFILE = "100m"               # the checkpoint drill's model (124 M)


def tree_equal(torch, a, b) -> bool:
    """Every leaf of two trees (same structure) bit-equal."""
    from repro_torch.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(bits(torch, x), bits(torch, y))
        for x, y in zip(la, lb))


def phase_train(torch, smi: str) -> dict:
    """Phase 16: train full-width Mistral-NeMo-12B (4 layers) through the
    port's training loop with the kv-head shuffle on K4a, then the checks
    around it. Returns the launch counts of the training path."""
    import dataclasses
    import gc
    import tempfile
    from repro_torch import guard, obs
    from repro_torch.checkpoint import ckpt
    from repro_torch.combinators import clear_caches
    from repro_torch.combinators.sort import sort_expr
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, ShardedLoader
    from repro_torch.guard.errors import GuardTrap
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.launch import train as LT
    from repro_torch.models import model as M
    from repro_torch.models.permute import PermuteLayer
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_leaves, tree_unflatten

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(SERVE_ARCH), n_periods=TRAIN_LAYERS,
                              head_shuffle="cuda")
    say(f"== phase 16: train {cfg.name} at full width ({cfg.n_layers} of 40 "
        f"layers, d_model {cfg.d_model}, {cfg.n_heads} q / {cfg.n_kv_heads} "
        f"kv heads, head_dim {cfg.hd}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {str(cfg.dtype).split('.')[-1]} weights, "
        f"{cfg.opt_bits}-bit AdamW moments, remat {cfg.remat} "
        f"({cfg.remat_policy})), batch {TRAIN_BATCH} x seq {TRAIN_SEQ} ==")
    say(f"  card: {smi}")
    clear_caches()
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    gib = 2 ** 30
    launches = {}

    def fresh(c=cfg, bits=32):
        """Parameters from seed 0 and zero AdamW state, on the card."""
        params = M.init(c, torch.Generator(device=dev).manual_seed(0))
        return params, adamw_init(params, AdamWConfig(state_bits=bits))

    def drop():
        gc.collect()
        torch.cuda.empty_cache()

    dcfg = DataConfig(n_samples_log2=16, seq_len=TRAIN_SEQ,
                      vocab_size=cfg.vocab_size, seed=0)
    args = LT.parse_args(["--steps", str(TRAIN_STEPS), "--batch",
                          str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                          "--log-every", "1"])

    # 1. ten steps through the training loop, K4a counted from 0
    params, opt = fresh()
    n_par = sum(p.numel() for p in tree_leaves(params))
    state_gb = sum(t.numel() * t.element_size() for t in tree_leaves(
        params) + tree_leaves(opt.m) + tree_leaves(opt.v)) / 1e9
    say(f"  {n_par / 1e9:.3f} B parameters; weights and moments "
        f"{state_gb:.2f} GB, with bf16 gradients "
        f"{state_gb + n_par * 2 / 1e9:.2f} GB (the reckoning: 29.2 GB)")
    before = [dev_hash(torch, p) for p in tree_leaves(params)]
    loader = ShardedLoader(dcfg, batch_size=TRAIN_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    res = LT.train(cfg, params, opt, loader, args)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / gib
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for i, (l, g, s) in enumerate(zip(res.losses, res.grad_norms,
                                      res.step_s)):
        say(f"  step {i}: loss {l:.4f}  grad_norm {g:.4f}  "
            f"{s * 1e3:.1f} ms  {tokens / s:,.0f} tokens/s")
        check(np.isfinite(l) and np.isfinite(g), ("nonfinite", i, l, g))
    warm = res.step_s[1:]
    say(f"  warm steps: median {statistics.median(warm) * 1e3:.1f} ms "
        f"({min(warm) * 1e3:.1f}-{max(warm) * 1e3:.1f}), "
        f"{tokens / statistics.median(warm):,.0f} tokens/s; the first "
        f"(cold) {res.step_s[0] * 1e3:.1f} ms; peak device memory "
        f"{peak:.2f} GiB of {torch.cuda.get_device_properties(0).total_memory / gib:.1f}")
    per_step = counts["tile"] / TRAIN_STEPS
    say(f"  kernel launches in {TRAIN_STEPS} steps: {counts}; K4a "
        f"{per_step:g} a step = 12 x {cfg.n_layers} layers")
    check(counts["tile"] == 12 * cfg.n_layers * TRAIN_STEPS
          == counts["tile_wide"], ("K4a launches on the training path",
                                   counts))
    check(sum(v for k, v in counts.items()
              if k not in ("tile", "tile_wide")) == 0, counts)
    launches["tile_serve"] = counts["tile"]
    moved = [a != dev_hash(torch, p) for a, p in zip(
        before, tree_leaves(res.params))]
    check(all(moved), ("parameters that did not move", moved))
    say(f"  all {len(moved)} parameter leaves moved")
    fixed = LT.batch_to(next(loader), dev)
    step_fn, _ = make_train_step(cfg)
    fl = []
    params, opt = res.params, res.opt_state
    for _ in range(TRAIN_FIXED_STEPS):
        params, opt, m = step_fn(params, opt, fixed)
        fl.append(float(m["loss"]))
    say(f"  {TRAIN_FIXED_STEPS} steps on one batch: loss "
        f"{' -> '.join(f'{v:.4f}' for v in fl)}")
    check(fl[-1] < fl[0], ("fixed-batch loss did not fall", fl))
    del params, opt, res, m, before
    drop()

    # 2. one step from the same parameters, state and batch with the
    # shuffle on cuda, on ref and off; then warm steps in turns
    batch0 = LT.batch_to(next(ShardedLoader(dcfg, batch_size=TRAIN_BATCH)),
                         dev)

    def one_step(c, validate=False, bits=32):
        params, opt = fresh(c, bits)
        step, _ = make_train_step(c, opt_cfg=AdamWConfig(state_bits=bits),
                                  validate=validate)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        del opt
        return params, m, dt, torch.cuda.max_memory_allocated() / gib

    engines = {"cuda": "cuda", "ref": "ref", "off": None}
    cfgs = {k: dataclasses.replace(cfg, head_shuffle=e)
            for k, e in engines.items()}
    want_p, want_m, _, _ = one_step(cfgs["cuda"])
    off_loss = None
    for k in ("ref", "off"):
        p, m, _, _ = one_step(cfgs[k])
        if k == "ref":
            check(torch.equal(m["loss"], want_m["loss"])
                  and torch.equal(m["grad_norm"], want_m["grad_norm"])
                  and tree_equal(torch, p, want_p),
                  "step with the shuffle on ref against cuda")
        else:
            off_loss = m["loss"]
        del p, m
        drop()
    if torch.equal(off_loss, want_m["loss"]):
        say("  one step from the same start with the shuffle on cuda and on "
            "ref: loss, grad_norm and every updated parameter bit-equal; "
            "shuffle off: loss bit-equal")
    else:
        rel = abs(float(off_loss) - float(want_m["loss"])) / abs(
            float(want_m["loss"]))
        say(f"  one step from the same start with the shuffle on cuda and on "
            f"ref: loss, grad_norm and every updated parameter bit-equal; "
            f"shuffle off: loss NOT bit-equal (relative {rel:.3e}, within "
            f"{SHUFFLE_OFF_REL_TOL})")
        check(rel <= SHUFFLE_OFF_REL_TOL, ("shuffle off loss", rel))
    loss_cuda = want_m["loss"]
    del want_p, want_m
    drop()
    # what the shuffle costs a step: warm steps of one model, in turns
    params, opt = fresh()
    steps = {k: make_train_step(c)[0] for k, c in cfgs.items()}

    def timed_step(k):
        nonlocal params, opt
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, _ = steps[k](params, opt, batch0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    for k in steps:
        timed_step(k)                               # warm
    times = in_turns({k: k for k in steps}, timed_step, rounds=3)
    med = {k: statistics.median(v) for k, v in times.items()}
    say("  warm steps in turns (6 each, ms): " + "; ".join(
        f"{k} {med[k]:.1f} ({min(times[k]):.1f}-{max(times[k]):.1f})"
        for k in engines) + f"; the shuffle costs "
        f"{med['cuda'] - med['off']:.1f} ms a step on cuda "
        f"({(med['cuda'] - med['off']) / med['off'] * 100:.1f} %), "
        f"{med['ref'] - med['off']:.1f} on ref")
    del params, opt, steps
    drop()

    # 3. remat on and off: the same loss and gradients
    def grads_of(c):
        params = M.init(c, torch.Generator(device=dev).manual_seed(0))
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        live = tree_unflatten(params, leaves)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        obs.reset()
        obs.enable(sync=False)
        try:
            loss, _ = M.loss_fn(c, live, batch0)
            grads = torch.autograd.grad(loss, leaves)
            dispatched = sum(obs.kernel_counts().values())
        finally:
            obs.disable()
            obs.reset()
        torch.cuda.synchronize()
        return (loss.detach(), grads, torch.cuda.max_memory_allocated() / gib,
                dispatched, K.launch_counts()["tile"])

    r_on = grads_of(cfg)
    r_off = grads_of(dataclasses.replace(cfg, remat=False))
    check(torch.equal(r_on[0], r_off[0]) and all(
        torch.equal(a, b) for a, b in zip(r_on[1], r_off[1])),
        "remat on against off: loss and gradients")
    for name, r, per in (("on", r_on, 12), ("off", r_off, 8)):
        say(f"  remat {name}: peak {r[2]:.2f} GiB; shuffles dispatched "
            f"(obs.kernel_counts) {r[3]}, K4a launches {r[4]} = {per} x "
            f"{cfg.n_layers} layers")
        check(r[3] == r[4] == per * cfg.n_layers, (name, r[3], r[4]))
    say("  remat on and off: loss and every gradient bit-equal")
    del r_on, r_off
    drop()

    # 4. 8-bit moments
    p, m, dt, peak8 = one_step(dataclasses.replace(cfg, opt_bits=8), bits=8)
    check(np.isfinite(float(m["loss"])) and np.isfinite(float(
        m["grad_norm"])), "8-bit step")
    say(f"  8-bit moments: loss {float(m['loss']):.4f}, grad_norm "
        f"{float(m['grad_norm']):.4f}, {dt * 1e3:.1f} ms, peak {peak8:.2f} "
        f"GiB")
    del p, m
    drop()

    # 5. the guarded step: zero traps and the unguarded loss; a poisoned
    # final_scale raises GuardTrap before the update
    guard.reset_stats()
    K.reset_launch_counts()
    p, m, dt, _ = one_step(cfg, validate=True)
    gcounts = K.launch_counts()
    gs = guard.stats()
    traps = sum(gs["traps"].values())
    say(f"  guarded step: {dt * 1e3:.1f} ms, tile_guarded launches "
        f"{gcounts['tile_guarded']}, unguarded tile {gcounts['tile']}; traps "
        f"{traps}, fallbacks {sum(gs['fallbacks'].values())}; loss "
        f"{'bit-equal to' if torch.equal(m['loss'], loss_cuda) else 'NOT'} "
        f"the unguarded step's")
    check(traps == 0 and torch.equal(m["loss"], loss_cuda)
          and gcounts["tile_guarded"] > 0 and gcounts["tile"] == 0,
          (gs, gcounts))
    launches["tile_guarded"] = gcounts["tile_guarded"]
    del p, m
    drop()
    params, opt = fresh()
    params["final_scale"].fill_(float("nan"))
    step, _ = make_train_step(cfg, validate=True)
    try:
        step(params, opt, batch0)
        check(False, "a nonfinite loss did not trap")
    except GuardTrap as e:
        say(f"  poisoned final_scale: GuardTrap {e.kinds} on "
            f"{e.engine!r}; optimizer step still {int(opt.step)}")
        check(int(opt.step) == 0, "the update ran after a trap")
    guard.reset_stats()
    del params, opt, step
    drop()

    # 6. K5 inside a step: a sort layer in a loss override
    n = TRAIN_SORT_N
    g = torch.Generator(device=dev).manual_seed(16)
    w0 = torch.randn(1 << n, generator=g, device=dev)
    sb = {"x": torch.randn((TRAIN_BATCH, 1 << n), generator=g, device=dev),
          "y": torch.randn((TRAIN_BATCH, 1 << n), generator=g, device=dev)}

    def sort_step(engine):
        layer = PermuteLayer(sort_expr(n), axis=1, engine=engine)

        def loss_fn(params, batch):
            l = torch.mean((layer(batch["x"] * params["w"]) - batch["y"])
                           ** 2)
            return l, {"mse": l}
        step, oc = make_train_step(cfg, opt_cfg=AdamWConfig(),
                                   loss_fn=loss_fn)
        return step, oc

    sort_runs = {}
    for eng in ("cuda", "ref"):
        step, oc = sort_step(eng)
        K.reset_launch_counts()
        p = {"w": w0.clone()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, _, m = step(p, adamw_init(p, oc), sb)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        c = K.launch_counts()
        sort_runs[eng] = (step, oc, p, m, cold, c)
    _, _, pc, mc, cold_c, c_cuda = sort_runs["cuda"]
    _, _, pr, mr, cold_r, c_ref = sort_runs["ref"]
    say(f"  sort layer (2^{n} float32 keys x {TRAIN_BATCH}): launches on "
        f"cuda {c_cuda}; on ref {sum(c_ref.values())}")
    check(c_cuda["tile_fused"] > 0 and c_cuda["tile_bwd"] > 0,
          ("K4b and K5 in the sort layer's step", c_cuda))
    check(torch.equal(mc["loss"], mr["loss"])
          and torch.equal(mc["grad_norm"], mr["grad_norm"])
          and torch.equal(pc["w"], pr["w"]),
          "sort layer step: cuda against ref")
    for k in ("tile", "tile_fused", "tile_bwd"):
        launches[k] = launches.get(k, 0) + c_cuda[k]

    def timed_sort(eng):
        step, oc = sort_runs[eng][:2]
        p = {"w": w0.clone()}
        st = adamw_init(p, oc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(p, st, sb)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    st = in_turns({"cuda": "cuda", "ref": "ref"}, timed_sort, rounds=3)
    say(f"  sort layer step: loss, grad_norm and new w bit-equal on cuda "
        f"(K4b forward, K5 backward) and on ref; cold {cold_c * 1e3:.0f} / "
        f"{cold_r * 1e3:.0f} ms; warm in turns (6 each): cuda "
        f"{statistics.median(st['cuda']):.2f} ms ({min(st['cuda']):.2f}-"
        f"{max(st['cuda']):.2f}), ref {statistics.median(st['ref']):.2f} ms "
        f"({min(st['ref']):.2f}-{max(st['ref']):.2f})")
    del sort_runs, pc, pr, mc, mr, sb, w0
    clear_caches()
    drop()

    # 7. checkpoint and resume on the card (the 100m profile)
    common = ["--profile", CKPT_PROFILE, "--log-every", "100"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        a = LT.main(common + ["--steps", "4", "--ckpt-every", "4",
                              "--ckpt-dir", d])
        check(ckpt.latest_step(d) == 4 and len(a.save_s) == 1, a.save_s)
        t0 = time.perf_counter()
        (rp, rs), extra = ckpt.restore(d, 4, (a.params, a.opt_state),
                                       device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(tree_equal(torch, {"p": rp, "s": rs.step, "m": rs.m,
                                 "v": rs.v},
                         {"p": a.params, "s": a.opt_state.step,
                          "m": a.opt_state.m, "v": a.opt_state.v}),
              "restored parameters and state against those saved")
        state_mb = sum(t.numel() * t.element_size() for t in tree_leaves(
            rp) + tree_leaves(rs.m) + tree_leaves(rs.v)) / 1e6
        del rp, rs
        a.params = a.opt_state = None
        b = LT.main(common + ["--steps", "8", "--ckpt-every", "100",
                              "--ckpt-dir", d])
    c = LT.main(common + ["--steps", "8"])
    check(b.start == 4 and extra["loader"]["step"] == 4, (b.start, extra))
    check(a.losses == c.losses[:4] and b.losses == c.losses[4:],
          ("resumed losses against an uninterrupted run", a.losses,
           b.losses, c.losses))
    say(f"  {CKPT_PROFILE} checkpoint ({state_mb:.0f} MB of weights and "
        f"moments): save {a.save_s[0]:.2f} s, restore {restore_s:.2f} s; "
        f"restored parameters and state bit-equal to those saved; the run "
        f"resumed at step 4 and its losses equal steps 4-7 of an "
        f"uninterrupted run bit for bit")
    del a, b, c
    drop()
    say(f"  phase 16: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 17: the non-dense block kinds at full width
# ---------------------------------------------------------------------------

# (configuration, serving cut, training cut or None: not trained, 8-bit
# moments): every width as published; depth cut only where the card's
# 80 GB force it (bf16 weights; training holds 12 bytes a parameter with
# float32 moments, about 6 with 8-bit ones, before activations).
KINDS_CELLS = (
    ("mamba2-130m", {}, {}, False),                 # whole: 24 layers
    ("recurrentgemma-2b", {}, {}, False),           # whole: 26 layers
    # 32 layers hold 84 GB of experts: serve 16 (42 GB), train 2 (34 GB)
    ("phi3.5-moe-42b-a6.6b", {"n_periods": 16}, {"n_periods": 2}, False),
    # one MoE layer holds 34 GB of experts: serve the dense prefix + 1 MoE
    # layer (40 GB); a step would need about 200 GB
    ("kimi-k2-1t-a32b", {"n_periods": 1}, None, False),
    # one period (4 dense + 1 cross, 13 GB); 8-bit moments to train it
    ("llama-3.2-vision-90b", {"n_periods": 1}, {"n_periods": 1}, True),
    ("seamless-m4t-medium", {}, {}, False),         # whole: 12 + 12 layers
)
KINDS_STEPS = 3                 # train steps on one fixed batch
# The decode check of an MoE configuration runs at the capacity factor
# n_experts / top_k (a slot per token and expert: nothing dropped), and
# kimi's with the prompt cut to 128 tokens (its no-drop buffers at 513
# tokens would need 30 GB beside 40 GB of weights): a prefill drops a
# token past an expert's capacity, and the last token is the first
# dropped, where one decode step routes 4 tokens and drops none.
KINDS_DECODE_PROMPT = {"kimi-k2-1t-a32b": 128}
# In bfloat16 the decode step's hidden state and the prefill's differ by
# their roundings (6e-2 norm-wise at 40 layers of Mistral-NeMo: the note
# at DECODE_REL_TOL), and an MoE layer's top-k choice is a step function
# of it: where the decoded token is routed to other experts, its logits
# differ by those experts' outputs.
# So the bfloat16 check holds the rows routed alike, of which there must
# be at least one (and all rows when none flipped), and the MoE decode path
# is held again in float32 at full width, cut to 4 layers (22 GB): there
# every routing choice must agree and all rows be within DECODE_F32_REL_TOL.
KINDS_F32_DECODE = {"phi3.5-moe-42b-a6.6b": {"n_periods": 4}}


def self_attention_layers(cfg, scanned=None) -> int:
    """The layers that shuffle kv heads: every self-attention kind, the
    encoder's too (``scanned``: only those in a stacked group, or only
    those outside)."""
    kinds = ("dense", "local", "moe", "enc", "dec")
    scan = cfg.pattern * cfg.n_periods + (
        cfg.enc_pattern * cfg.n_enc_periods if cfg.is_encdec else ())
    rest = cfg.prefix + cfg.tail
    groups = {None: scan + rest, True: scan, False: rest}[scanned]
    return sum(k in kinds for k in groups)


def phase_kinds(torch, smi: str) -> dict:
    """Phase 17: serve and train the non-dense block kinds (SSM, hybrid,
    MoE, VLM, encoder-decoder) at full width, with the kv-head shuffle on
    K4a wherever the configuration has power-of-two kv heads. Returns the
    K4a launches of the prefills and of a train step, by configuration."""
    import dataclasses
    import gc
    from repro_torch.combinators import clear_caches
    from repro_torch.configs import get_config
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.launch import serve as S
    from repro_torch.models import model as M
    from repro_torch.models.attention import default_head_perm
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    say(f"== phase 17: the non-dense block kinds at full width: serve batch "
        f"{SERVE_BATCH}, prompt {SERVE_PROMPT}, {SERVE_TOKENS} new tokens; "
        f"train batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, {KINDS_STEPS} steps "
        f"on one batch ==")
    say(f"  card: {smi}")
    dev = torch.device("cuda")
    gib = 2 ** 30
    out = {"serve": {}, "train": {}}

    def drop():
        clear_caches()
        gc.collect()
        torch.cuda.empty_cache()

    def only_k4a(counts, want):
        check(counts["tile"] == want == counts["tile_wide"]
              and sum(v for k, v in counts.items()
                      if k not in ("tile", "tile_wide")) == 0,
              ("K4a launches", want, counts))

    for arch, serve_cut, train_cut, opt8 in KINDS_CELLS:
        t_cfg = time.perf_counter()
        base = get_config(arch)
        shuffled = default_head_perm(base.n_kv_heads) is not None and (
            self_attention_layers(base) > 0)
        eng = "cuda" if shuffled else None
        cfg = dataclasses.replace(base, head_shuffle=eng, **serve_cut)
        layers = (f"{cfg.n_layers}" + (f" + {cfg.n_enc_periods} encoder"
                                       if cfg.is_encdec else ""))
        cut = (f"cut to {layers} of {base.n_layers} layers" if serve_cut
               else f"whole: {layers} layers")
        say(f"  -- {arch} ({base.family}: kinds "
            f"{sorted(set(base.layer_kinds))}, d_model {cfg.d_model}, "
            f"{cfg.n_heads} q / {cfg.n_kv_heads} kv heads, vocab "
            f"{cfg.vocab_size}"
            + (f", {cfg.n_experts} experts top {cfg.top_k}"
               if cfg.n_experts else "")
            + (f", src {cfg.src_len} x {cfg.d_model}" if cfg.src_len else "")
            + f"); serving {cut}; shuffle "
            + (f"cuda (K4a, {cfg.n_kv_heads} kv heads, 4 a self-attention "
               f"layer)" if shuffled else "none (no power-of-two kv heads "
                                         "in a self-attention layer)"))
        drop()
        torch.cuda.reset_peak_memory_stats()
        params = M.init(cfg, torch.Generator(device=dev).manual_seed(0))
        n_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
        args = S.parse_args(["--arch", arch, "--batch", str(SERVE_BATCH),
                             "--prompt-len", str(SERVE_PROMPT),
                             "--tokens", str(SERVE_TOKENS)])
        prompts = S.make_prompts(cfg, args, dev)
        src = S.make_src(cfg, args, dev)
        want = 4 * self_attention_layers(cfg) if shuffled else 0

        K.reset_launch_counts()
        first = S.serve(cfg, params, args, prompts, src)
        counts = K.launch_counts()
        check(not first.errors and first.gen is not None, first.errors)
        check(first.gen.shape == (SERVE_BATCH, SERVE_TOKENS), first.gen.shape)
        check(bool(torch.isfinite(first.prefill_logits).all()), arch)
        only_k4a(counts, want)
        out["serve"][arch] = counts["tile"]
        runs = [first]
        if shuffled:
            off = S.serve(dataclasses.replace(cfg, head_shuffle=None),
                          params, args, prompts, src)
            check(not off.errors, off.errors)
            err = max_abs_err(torch, off.prefill_logits, first.prefill_logits)
            check(err == 0.0 and np.array_equal(off.gen, first.gen),
                  (arch, "shuffle cuda against off", err))
            runs.append(off)
        if cfg.n_experts:
            with torch.no_grad():
                again, _ = M.prefill(cfg, params, {"tokens": prompts})
            check(torch.equal(again[:, -1:], first.prefill_logits),
                  (arch, "two prefills"))
            del again
        steps = [st for r in runs for st in r.step_s[1:]]
        say(f"    {n_bytes / 1e9:.2f} GB of weights; K4a launches in the "
            f"prefill {counts['tile']} (wide {counts['tile_wide']}), no "
            f"other kernel"
            + ("; prefill logits and ids bit-equal with the shuffle off"
               if shuffled else "")
            + ("; two prefills bit-equal" if cfg.n_experts else ""))
        say(f"    prefill {', '.join(f'{r.prefill_s * 1e3:.1f}' for r in runs)}"
            f" ms (first, then warm); warm decode "
            f"{statistics.median(steps) * 1e3:.2f} ms/token (median of "
            f"{len(steps)}); "
            f"{', '.join(f'{SERVE_BATCH * r.gen.shape[1] / r.decode_s:.1f}' for r in runs)}"
            f" tokens/s; {smi}")
        dcfg = cfg
        if cfg.n_experts:
            dcfg = dataclasses.replace(
                cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        dp = KINDS_DECODE_PROMPT.get(arch, SERVE_PROMPT)
        d = decode_against_prefill(torch, M, dcfg, params, prompts[:, :dp], src)
        say(f"    decode step vs prefill of {dp + 1} tokens"
            + (f" (capacity factor {dcfg.capacity_factor:g}: no drops)"
               if cfg.n_experts else "")
            + f": norm-wise relative {d['rel']:.3e} (tolerance "
            f"{DECODE_REL_TOL}), max abs {d['max_abs']:.4f}, argmax equal in "
            f"{d['agree']}/{SERVE_BATCH} rows"
            + ("" if d["state_err"] is None else
               f"; carried states after the step (conv tails, "
               f"{'SSD' if 'mamba' in cfg.layer_kinds else 'RG-LRU'} "
               f"states) vs the longer prefill's: worst norm-wise relative "
               f"{d['state_err']:.3e}")
            + f"; peak {torch.cuda.max_memory_allocated() / gib:.2f} GiB; "
            f"{smi}")
        check(d["state_err"] is None or d["state_err"] <= DECODE_REL_TOL,
              (arch, "carried states vs prefill", d["state_err"]))
        if cfg.n_experts:
            kept = d["rel_kept"]
            say(f"    routing of the decoded token, decode vs the longer "
                f"prefill: {d['flips']} (layer, row) choices of "
                f"{d['routing_layers']} x {SERVE_BATCH} differ, in "
                f"{d['rows_flipped']} rows; the other rows' logits: "
                + ("none left" if kept is None else
                   f"norm-wise relative {kept:.3e}"))
            check(kept is not None and kept <= DECODE_REL_TOL,
                  (arch, "decode vs prefill, rows routed alike", kept))
            if d["flips"] == 0:
                check(d["rel"] <= DECODE_REL_TOL,
                      (arch, "decode vs prefill", d["rel"]))
        else:
            check(d["rel"] <= DECODE_REL_TOL,
                  (arch, "decode vs prefill", d["rel"]))
        del params, runs, first
        drop()
        if arch in KINDS_F32_DECODE:
            c32 = dataclasses.replace(
                dcfg, dtype=torch.float32, **KINDS_F32_DECODE[arch])
            params = M.init(c32, torch.Generator(device=dev).manual_seed(0))
            d = decode_against_prefill(torch, M, c32, params, prompts, src)
            say(f"    float32 ({c32.n_layers} layers, "
                f"{sum(t.numel() for t in tree_leaves(params)) * 4 / 1e9:.1f}"
                f" GB): decode step vs prefill of {SERVE_PROMPT + 1} tokens: "
                f"norm-wise relative {d['rel']:.3e} over all rows (tolerance "
                f"{DECODE_F32_REL_TOL}), argmax equal in {d['agree']}/"
                f"{SERVE_BATCH} rows; routing choices that differ "
                f"{d['flips']} of {d['routing_layers']} x {SERVE_BATCH} "
                f"(must be 0)")
            check(d["flips"] == 0 and d["rel"] <= DECODE_F32_REL_TOL,
                  (arch, "float32 decode vs prefill", d))
            del params
            drop()
        del src

        if train_cut is None:
            say(f"    not trained on the card: {arch} at one MoE layer holds "
                f"{n_bytes / 1e9:.0f} GB of bf16 weights, and a step needs "
                f"weights, gradients and moments of them")
            say(f"    {arch}: {time.perf_counter() - t_cfg:.1f} s")
            continue
        tcfg = dataclasses.replace(base, head_shuffle=eng,
                                   opt_bits=8 if opt8 else base.opt_bits,
                                   **train_cut)
        ocfg = AdamWConfig(state_bits=tcfg.opt_bits)
        g = torch.Generator(device=dev).manual_seed(17)
        batch = {k: torch.randint(0, tcfg.vocab_size,
                                  (TRAIN_BATCH, TRAIN_SEQ), generator=g,
                                  device=dev) for k in ("tokens", "labels")}
        if tcfg.src_len:
            batch["src"] = torch.randn(
                (TRAIN_BATCH, tcfg.src_len, tcfg.d_model), generator=g,
                device=dev).to(tcfg.dtype)
        per_step = (12 if tcfg.remat else 8) * self_attention_layers(
            tcfg, scanned=True) + 8 * self_attention_layers(
                tcfg, scanned=False) if shuffled else 0

        def first_step(c):
            params = M.init(c, torch.Generator(device=dev).manual_seed(0))
            opt = adamw_init(params, ocfg)
            step, _ = make_train_step(c, opt_cfg=ocfg)
            K.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
            return (params, opt, step, m, time.perf_counter() - t0,
                    K.launch_counts())

        torch.cuda.reset_peak_memory_stats()
        params, opt, step, m, dt, counts = first_step(tcfg)
        only_k4a(counts, per_step)
        if tcfg.opt_bits == 8:
            # the leaves of an 8-bit moment come in (q, s) pairs
            lost = sum(int(((vq == 0) & (mq != 0)).sum()) for mq, vq in zip(
                tree_leaves(opt.m)[0::2], tree_leaves(opt.v)[0::2]))
            lost /= sum(t.numel() for t in tree_leaves(params))
        hashes = [dev_hash(torch, t) for t in tree_leaves(params)]
        losses, times = [float(m["loss"])], [dt]
        m0 = {k: m[k] for k in ("loss", "grad_norm")}
        for _ in range(KINDS_STEPS - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        peak = torch.cuda.max_memory_allocated() / gib
        n_par = sum(t.numel() for t in tree_leaves(params))
        if tcfg.opt_bits == 8:
            # the reference's 8-bit moments: a second moment under 1/254 of
            # its block's largest dequantizes to 0, so the next update
            # divides a first moment by sqrt of the new gradient's square
            # alone; after a first step that fits the batch, that gradient
            # is orders smaller and the step overshoots. The first update
            # (fresh moments) is held; the later ones are printed.
            check(np.isfinite(losses[1]) and losses[1] < losses[0],
                  (arch, "loss on one batch, first update", losses))
            say(f"    8-bit moments after the first step: {lost:.2%} of the "
                f"entries have a first moment and a second moment of 0 "
                f"(int8 blocks of 256 scaled by their largest entry, as the "
                f"reference's); the loss after the first update "
                f"{losses[1]:.4f} < {losses[0]:.4f}, after the later ones "
                f"{', '.join(f'{v:.4f}' for v in losses[2:])}")
        else:
            check(all(np.isfinite(losses)) and losses[-1] < losses[0],
                  (arch, "loss on one batch", losses))
        out["train"][arch] = counts["tile"]
        del params, opt, step, m
        drop()
        if shuffled:
            rp, _, _, rm, _, rcounts = first_step(
                dataclasses.replace(tcfg, head_shuffle="ref"))
            check(all(torch.equal(rm[k], m0[k]) for k in m0)
                  and [dev_hash(torch, t) for t in tree_leaves(rp)] == hashes
                  and rcounts["tile"] == 0,
                  (arch, "a step with the shuffle on ref against cuda"))
            del rp, rm
            drop()
        warm = statistics.median(times[1:])
        tokens = TRAIN_BATCH * TRAIN_SEQ
        tcut = (f"cut to {tcfg.n_layers} of {base.n_layers} layers"
                if train_cut else "whole")
        say(f"    train ({tcut}; {n_par / 1e9:.3f} B parameters, "
            f"{tcfg.opt_bits}-bit moments, remat {tcfg.remat}): loss "
            f"{' -> '.join(f'{v:.4f}' for v in losses)}; K4a "
            f"{counts['tile']} a step"
            + (f" = {'12' if tcfg.remat else '8'} x "
               f"{self_attention_layers(tcfg)} self-attention layers; a step "
               f"with the shuffle on ref bit-equal (loss, grad_norm, every "
               f"parameter)" if shuffled else "")
            + f"; first step {times[0] * 1e3:.1f} ms, warm "
            f"{', '.join(f'{v * 1e3:.1f}' for v in times[1:])} ms, "
            f"{tokens / warm:,.0f} tokens/s; peak {peak:.2f} GiB; {smi}")
        say(f"    {arch}: {time.perf_counter() - t_cfg:.1f} s")
    say(f"  phase 17: {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 18: the model on a device mesh
# ---------------------------------------------------------------------------

MESH_ARCH = "phi3.5-moe-42b-a6.6b"     # moe_impl="a2a", 16 experts top 2
MESH_KIMI = "kimi-k2-1t-a32b"          # moe_impl="a2a", 384 experts top 8
# Norm-wise relative error allowed between the logits (and a step's
# loss) of the all-to-all branch on a (1, 1) mesh and the capacity branch
# with no mesh. On one rank both pack each expert's rows alike (one peer:
# the same per-expert capacity, the same rows in the same order, so the
# same drops and the same products); they differ only in the order a
# token's routed copies are added: by top-k rank against by expert id.
# For top 2 the orders give the same bits (a sum of two terms commutes).
# For kimi's top 8 each element of the MoE output may round otherwise at
# each of the 7 additions: at most 7 units of bfloat16's roundoff (2^-8)
# of the terms' magnitude, 2.7e-2 per element and much less norm-wise,
# which the final norm and the head carry to the logits. So 3e-2.
A2A_REL_TOL = 3e-2
MESH_TRAIN_LAYERS = 2             # phi trained at 2 layers, as in phase 17
MESH_TRAIN_STEPS = 3
MESH_DECODE_STEPS = 20


def phase_mesh(torch, smi: str, bw: float, reps: int) -> dict:
    """Phase 18: the model on a (1, 1) device mesh of one single-rank NCCL
    group: ``moe_ffn_a2a`` at phi's layer width with the slot shuffle on
    K4a, phi served and trained and kimi served through the all-to-all
    branch. Returns the K4a launches of its runs."""
    import dataclasses
    import gc

    import torch.distributed as dist
    from repro_torch import obs
    from repro_torch.combinators import clear_caches
    from repro_torch.configs import get_config
    from repro_torch.core.bmmc import Bmmc
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve as S
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models import model as M
    from repro_torch.models.attention import default_head_perm
    from repro_torch.models.moe_a2a import moe_ffn_a2a
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    say("== phase 18: the model on a device mesh: a (1, 1) mesh of one "
        "single-rank NCCL group; moe_ffn_a2a at phi's layer width, phi "
        f"served ({SERVE_BATCH} x {SERVE_PROMPT}) and trained, kimi served, "
        "through the all-to-all branch ==")
    say(f"  card: {smi}")
    dev = torch.device("cuda")
    gib = 2 ** 30
    launches = {}
    timed = (lambda fn: cuda_ms(torch, fn, reps))

    def drop():
        clear_caches()
        gc.collect()
        torch.cuda.empty_cache()

    def only_k4a(counts, want, what):
        check(counts["tile"] == want == counts["tile_wide"]
              and sum(v for k, v in counts.items()
                      if k not in ("tile", "tile_wide")) == 0,
              (what, "K4a launches", want, counts))

    check(not dist.is_initialized(), "a process group before phase 18")
    mesh = make_dev_mesh(1, 1, device="cuda")
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              (dist.get_backend(), dist.get_world_size()))
        say(f"  {mesh}: backend {dist.get_backend()}, world "
            f"{dist.get_world_size()}, coordinates {mesh.coords}")

        # -- moe_ffn_a2a at phi's layer width -------------------------------
        base = get_config(MESH_ARCH)
        e, f, xn, k = base.d_model, base.moe_d_ff, base.n_experts, base.top_k
        b, s = SERVE_BATCH, SERVE_PROMPT
        t = b * s
        cf = base.capacity_factor
        cap = int(np.ceil(k * t * cf))
        cap = max(8, int(np.ceil(cap / 8)) * 8)
        p2 = 1 << (cap - 1).bit_length()
        cf_off = p2 / (k * t)          # the same power-of-two capacity
        check(int(np.ceil(k * t * cf_off)) == p2, (cf_off, p2))
        gen = torch.Generator(device=dev).manual_seed(18)

        def rnd(shape, scale):
            return (torch.randn(shape, generator=gen, device=dev)
                    * scale).to(torch.bfloat16)
        inputs = [rnd((b, s, e), 1.0), rnd((e, xn), 0.02),
                  rnd((xn, e, f), 0.02), rnd((xn, e, f), 0.02),
                  rnd((xn, f, e), 0.02)]
        ct = torch.randn((b, s, e), generator=gen, device=dev)

        def a2a(eng, cfac, grad):
            ts = [v.clone().requires_grad_(grad) for v in inputs]
            obs.reset()
            obs.enable(sync=False)
            K.reset_launch_counts()
            try:
                out, aux = moe_ffn_a2a(
                    *ts, top_k=k, capacity_factor=cfac, mesh=mesh,
                    dispatch_shuffle=eng is not None,
                    shuffle_engine=eng or "cuda")
                torch.cuda.synchronize()
                fwd, fobs = K.launch_counts(), obs.kernel_counts()
                grads = None
                if grad:
                    ((out.float() * ct).sum() + aux).backward()
                    torch.cuda.synchronize()
                    grads = [v.grad for v in ts]
                both, bobs = K.launch_counts(), obs.kernel_counts()
            finally:
                obs.disable()
                obs.reset()
            return out.detach(), aux.detach(), grads, fwd, both, fobs, bobs

        runs = {"cuda": a2a("cuda", cf, False), "ref": a2a("ref", cf, False),
                "off": a2a(None, cf_off, False)}
        only_k4a(runs["cuda"][3], 2, "a2a forward on cuda")
        check(runs["cuda"][5] == {"tiled": 2, "ref": 1}, runs["cuda"][5])
        check(runs["ref"][3]["tile"] == runs["off"][3]["tile"] == 0,
              "K4a on ref or off")
        for name in ("ref", "off"):
            check(max_abs_err(torch, runs[name][0], runs["cuda"][0]) == 0.0
                  and torch.equal(runs[name][1], runs["cuda"][1]),
                  ("a2a shuffle", name, "against cuda"))
        gc_, gr = a2a("cuda", cf, True), a2a("ref", cf, True)
        only_k4a(gc_[4], 4, "a2a forward and backward on cuda")
        check(gc_[6] == {"tiled": 4, "ref": 1}, gc_[6])
        check(gr[4]["tile"] == 0, gr[4])
        check(max_abs_err(torch, gc_[0], gr[0]) == 0.0
              and torch.equal(gc_[1], gr[1])
              and all(max_abs_err(torch, x, y) == 0.0
                      for x, y in zip(gc_[2], gr[2])),
              "a2a forward and backward, cuda against ref")
        launches["dispatch shuffle, forward and backward"] = gc_[4]["tile"]
        say(f"  moe_ffn_a2a (E {e}, F {f}, {xn} experts top {k}, bf16, T = "
            f"{b} x {s}): capacity {cap} slots, {p2} with the shuffle; "
            f"shuffle on cuda, on ref and off (capacity factor {cf_off:g}, "
            f"{p2} slots): outputs and aux bit-equal (aux "
            f"{float(runs['cuda'][1]):.6f}); K4a launched "
            f"{runs['cuda'][3]['tile']} times a forward (wide "
            f"{runs['cuda'][3]['tile_wide']}), {gc_[4]['tile']} with the "
            f"backward, no other kernel (obs: {gc_[6]}; the metadata's "
            f"shuffle is the plain gather); forward and backward on cuda "
            f"and ref bit-equal (output, aux, 5 gradients)")
        del runs, gc_, gr

        # K4a at the dispatch shuffle's shape, timed in turns with
        # index_select
        bm = Bmmc.bit_reverse(p2.bit_length() - 1)
        buf = rnd((1, p2, e), 1.0)
        tt = ops.choose_tile(bm.n, buf.element_size(), e)
        kernel, plans = ops.class_plan(bm, tt)
        check(kernel == "tiled" and len(plans) == 1, (kernel, tt))
        plan = plans[0]
        got = K.tiled_permute(buf, plan, batched=True)
        sched = K.k4a_record(buf, plan, batched=True).schedule
        err = max(max_abs_err(torch, got, K.tiled_permute_plain(
            buf, plan, batched=True)), max_abs_err(torch, got, ref.bmmc_ref(
                buf, bm, batched=True)), max_abs_err(
                    torch, ops.bmmc_permute(buf, bm, batched=True), got))
        check(err == 0.0, ("K4a at the dispatch shuffle's shape", err))
        idx = ref.bmmc_src_index(bm, dev)
        fns = {"kernel": lambda: K.tiled_permute(buf, plan, batched=True),
               "library": lambda: torch.index_select(buf, 1, idx)}
        one = {kk: statistics.median(v)
               for kk, v in in_turns(fns, timed).items()}
        dv = {kk: statistics.median(v) for kk, v in in_turns(
            fns, lambda fn: device_ms(torch, fn), rounds=1).items()}
        plain_ms = cuda_ms(torch, lambda: K.tiled_permute_plain(
            buf, plan, batched=True), max(3, reps // 3), warmup=1)
        tab_bytes = sum(a.numel() * 4 for a in K.device_tables(plan, dev))
        bound_ms = (2 * buf.numel() * buf.element_size() + tab_bytes) / bw \
            * 1e3
        say(f"  K4a, MoE dispatch shuffle {tuple(buf.shape)} bf16 "
            f"(bit-reverse of 2^{bm.n} slots of {e * 2} bytes, t={tt}, "
            f"{sched.schedule} schedule, {sched.per_cta} elements a block, "
            f"{sched.grid} blocks): bit-equal to its plain version and "
            f"the gather; one call (in turns): kernel {one['kernel']:.4f} "
            f"ms, index_select {one['library']:.4f} ms; device (in turns): "
            f"kernel {dv['kernel']:.4f} ms, index_select "
            f"{dv['library']:.4f} ms; plain {plain_ms:.4f} ms; bound "
            f"{bound_ms:.4f} ms ({2 * buf.numel() * 2 / 2 ** 20:.0f} MiB "
            f"moved); {smi}")
        del buf, got, inputs, ct
        drop()

        # -- phi served with the mesh ---------------------------------------
        cfg = dataclasses.replace(base, head_shuffle="cuda", n_periods=16)
        torch.cuda.reset_peak_memory_stats()
        params = M.init(cfg, torch.Generator(device=dev).manual_seed(0))
        args = S.parse_args(["--arch", cfg.name, "--batch", str(SERVE_BATCH),
                             "--prompt-len", str(SERVE_PROMPT),
                             "--tokens", str(SERVE_TOKENS)])
        prompts = S.make_prompts(cfg, args, dev)
        moe_layers = cfg.layer_kinds.count("moe")

        def prefill(c, m, p, toks):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                lg, caches = M.prefill(c, p, {"tokens": toks}, mesh=m)
            torch.cuda.synchronize()
            return lg, caches, (time.perf_counter() - t0) * 1e3

        def counted(fn):
            obs.reset()
            obs.enable(sync=False)
            K.reset_launch_counts()
            try:
                got = fn()
                return got, K.launch_counts(), obs.counter_value(
                    "model.moe_a2a")
            finally:
                obs.disable()
                obs.reset()

        (lg1, c1, ms1), counts, n_a2a = counted(
            lambda: prefill(cfg, mesh, params, prompts))
        check(n_a2a == moe_layers == 16, ("a2a branch", n_a2a, moe_layers))
        want = 4 * self_attention_layers(cfg)
        only_k4a(counts, want, "phi prefill with the mesh")
        launches["phi prefill (16 layers)"] = counts["tile"]
        del c1
        lg2, c2, _ = prefill(cfg, mesh, params, prompts)
        check(torch.equal(lg1, lg2), "phi: two mesh prefills")
        del c2
        lg0, c0, ms0 = prefill(cfg, None, params, prompts)
        del c0
        rel = rel_err(torch, lg1, lg0)
        check(rel <= A2A_REL_TOL, ("phi: mesh against no mesh", rel))
        say(f"  {cfg.name} (cut to {cfg.n_layers} of {base.n_layers} "
            f"layers, bf16, weights from a seed): prefill with the mesh: "
            f"the a2a branch in {n_a2a} of {moe_layers} MoE layers; K4a "
            f"{counts['tile']} (wide {counts['tile_wide']}, 4 in each "
            f"self-attention layer), no other kernel; two mesh prefills "
            f"bit-equal; logits against no mesh (capacity branch): "
            f"norm-wise relative {rel:.3e}"
            + (" (bit-equal)" if torch.equal(lg1, lg0) else "")
            + f" (tolerance {A2A_REL_TOL})")
        del lg1, lg2, lg0
        pre = in_turns(
            {"mesh": lambda: prefill(cfg, mesh, params, prompts)[2],
             "none": lambda: prefill(cfg, None, params, prompts)[2]},
            lambda fn: fn(), rounds=1)

        def decode_ms(m):
            lg, caches, _ = prefill(cfg, m, params, prompts)
            caches = M.grow_caches(caches, SERVE_PROMPT,
                                   SERVE_PROMPT + MESH_DECODE_STEPS)
            times = []
            with torch.no_grad():
                for i in range(MESH_DECODE_STEPS):
                    tok = torch.argmax(lg[:, -1], -1)[:, None]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    lg, caches = M.decode_step(cfg, params, caches, tok,
                                               SERVE_PROMPT + i, mesh=m)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(times[1:])
        dec = in_turns({"mesh": lambda: decode_ms(mesh),
                        "none": lambda: decode_ms(None)},
                       lambda fn: fn(), rounds=1)
        dcfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        d = decode_against_prefill(torch, M, dcfg, params, prompts,
                                   mesh=mesh)
        kept = d["rel_kept"]
        check(kept is not None and kept <= DECODE_REL_TOL,
              ("phi: mesh decode vs prefill, rows routed alike", kept))
        if d["flips"] == 0:
            check(d["rel"] <= DECODE_REL_TOL, ("phi: mesh decode", d["rel"]))
        serve_peak = torch.cuda.max_memory_allocated() / gib
        say(f"    decode step with the mesh vs a mesh prefill of "
            f"{SERVE_PROMPT + 1} tokens (capacity factor "
            f"{dcfg.capacity_factor:g}: no drops): routing choices that "
            f"differ {d['flips']} of {d['routing_layers']} x {SERVE_BATCH}, "
            f"in {d['rows_flipped']} rows; the other rows norm-wise "
            f"relative {kept:.3e}, all rows {d['rel']:.3e} (tolerance "
            f"{DECODE_REL_TOL})")
        say(f"    prefill {SERVE_BATCH} x {SERVE_PROMPT} (in turns, first "
            f"call {ms1:.1f} ms with the mesh, {ms0:.1f} without): mesh "
            f"{', '.join(f'{v:.1f}' for v in pre['mesh'])} ms, no mesh "
            f"{', '.join(f'{v:.1f}' for v in pre['none'])} ms; warm decode "
            f"(median of {MESH_DECODE_STEPS - 1}, in turns): mesh "
            f"{', '.join(f'{v:.2f}' for v in dec['mesh'])} ms/token, no "
            f"mesh {', '.join(f'{v:.2f}' for v in dec['none'])} ms/token; "
            f"peak {serve_peak:.2f} GiB; {smi}")
        del params, pre, dec, d
        drop()

        # -- kimi served with the mesh --------------------------------------
        kbase = get_config(MESH_KIMI)
        shuffled = default_head_perm(kbase.n_kv_heads) is not None
        kcfg = dataclasses.replace(kbase, n_periods=1,
                                   head_shuffle="cuda" if shuffled else None)
        torch.cuda.reset_peak_memory_stats()
        kparams = M.init(kcfg, torch.Generator(device=dev).manual_seed(0))
        kprompts = S.make_prompts(kcfg, S.parse_args(
            ["--arch", kcfg.name, "--batch", str(SERVE_BATCH),
             "--prompt-len", str(SERVE_PROMPT), "--tokens",
             str(SERVE_TOKENS)]), dev)
        (kl1, kc1, kms1), kcounts, k_a2a = counted(
            lambda: prefill(kcfg, mesh, kparams, kprompts))
        del kc1
        kmoe = kcfg.layer_kinds.count("moe")
        check(k_a2a == kmoe == 1, ("kimi: a2a branch", k_a2a, kmoe))
        only_k4a(kcounts, 4 * self_attention_layers(kcfg) if shuffled else 0,
                 "kimi prefill with the mesh")
        launches["kimi prefill (prefix + 1)"] = kcounts["tile"]
        kl2, kc2, _ = prefill(kcfg, mesh, kparams, kprompts)
        del kc2
        check(torch.equal(kl1, kl2), "kimi: two mesh prefills")
        kl0, kc0, kms0 = prefill(kcfg, None, kparams, kprompts)
        del kc0
        krel = rel_err(torch, kl1, kl0)
        check(krel <= A2A_REL_TOL, ("kimi: mesh against no mesh", krel))
        kpre = in_turns(
            {"mesh": lambda: prefill(kcfg, mesh, kparams, kprompts)[2],
             "none": lambda: prefill(kcfg, None, kparams, kprompts)[2]},
            lambda fn: fn(), rounds=1)
        say(f"  {kcfg.name} (the dense prefix + {kcfg.n_periods} MoE layer "
            f"of {kcfg.n_experts} experts top {kcfg.top_k}): prefill with "
            f"the mesh through the a2a branch ({k_a2a} layer); K4a "
            f"{kcounts['tile']}, no other kernel; two mesh prefills "
            f"bit-equal; logits against no mesh: norm-wise relative "
            f"{krel:.3e}" + (" (bit-equal)" if torch.equal(kl1, kl0) else "")
            + f" (tolerance {A2A_REL_TOL}); prefill (first call {kms1:.1f} "
            f"ms with the mesh, {kms0:.1f} without; then in turns): mesh "
            f"{', '.join(f'{v:.1f}' for v in kpre['mesh'])} ms, no mesh "
            f"{', '.join(f'{v:.1f}' for v in kpre['none'])} ms; peak "
            f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB; {smi}")
        del kparams, kl1, kl2, kl0
        drop()

        # -- phi trained with the mesh --------------------------------------
        tcfg = dataclasses.replace(base, head_shuffle="cuda",
                                   n_periods=MESH_TRAIN_LAYERS)
        ocfg = AdamWConfig(state_bits=tcfg.opt_bits)
        g = torch.Generator(device=dev).manual_seed(17)
        batch = {kk: torch.randint(0, tcfg.vocab_size,
                                   (TRAIN_BATCH, TRAIN_SEQ), generator=g,
                                   device=dev) for kk in ("tokens", "labels")}
        per_step = (12 if tcfg.remat else 8) * self_attention_layers(tcfg)

        def train(m):
            params = M.init(tcfg, torch.Generator(device=dev).manual_seed(0))
            opt = adamw_init(params, ocfg)
            step, _ = make_train_step(tcfg, m, opt_cfg=ocfg)
            losses, times = [], []
            for i in range(MESH_TRAIN_STEPS):
                if i == 0:
                    obs.reset()
                    obs.enable(sync=False)
                    K.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, met = step(params, opt, batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(met["loss"]))
                if i == 0:
                    counts = K.launch_counts()
                    n_a2a = obs.counter_value("model.moe_a2a")
                    obs.disable()
                    obs.reset()
                    first = ({kk: met[kk].clone() for kk in
                              ("loss", "grad_norm")},
                             [dev_hash(torch, v) for v in tree_leaves(params)])
            del params, opt, step
            drop()
            return losses, times, counts, n_a2a, first

        torch.cuda.reset_peak_memory_stats()
        ta = train(mesh)
        tn = train(None)
        tb = train(mesh)
        train_peak = torch.cuda.max_memory_allocated() / gib
        losses = ta[0]
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              ("phi with the mesh: loss on one batch", losses))
        only_k4a(ta[2], per_step, "phi step with the mesh")
        check(ta[3] >= MESH_TRAIN_LAYERS, ("a2a in the step", ta[3]))
        launches["phi train step (2 layers)"] = ta[2]["tile"]
        check(all(torch.equal(ta[4][0][kk], tb[4][0][kk])
                  for kk in ("loss", "grad_norm")) and ta[4][1] == tb[4][1],
              "phi with the mesh: the first step of two runs")
        lrel = abs(ta[0][0] - tn[0][0]) / abs(tn[0][0])
        check(lrel <= A2A_REL_TOL, ("phi: step loss, mesh vs none", lrel))
        step_equal = all(torch.equal(ta[4][0][kk], tn[4][0][kk])
                         for kk in ("loss", "grad_norm")) and \
            ta[4][1] == tn[4][1]
        tokens = TRAIN_BATCH * TRAIN_SEQ
        warm = statistics.median(ta[1][1:] + tb[1][1:])
        say(f"  {tcfg.name} trained with the mesh (cut to {tcfg.n_layers} "
            f"layers, {tcfg.opt_bits}-bit moments, remat {tcfg.remat}): "
            f"loss {' -> '.join(f'{v:.4f}' for v in losses)}; the a2a "
            f"branch {int(ta[3])} times a step; K4a {ta[2]['tile']} a step, "
            f"no other kernel; first step of two mesh runs bit-equal (loss, "
            f"grad_norm, every parameter); its loss against no mesh: "
            f"relative {lrel:.3e}"
            + (" (the whole step bit-equal)" if step_equal else "")
            + f" (tolerance {A2A_REL_TOL})")
        say(f"    step ms (runs in turns: mesh, none, mesh; first step, "
            f"then warm): mesh {', '.join(f'{v:.1f}' for v in ta[1])} and "
            f"{', '.join(f'{v:.1f}' for v in tb[1])}, no mesh "
            f"{', '.join(f'{v:.1f}' for v in tn[1])}; {tokens / warm * 1e3:,.0f}"
            f" tokens/s with the mesh; peak {train_peak:.2f} GiB; {smi}")
    finally:
        mesh.close()
    check(not dist.is_initialized(), "the phase's process group outlived it")
    say(f"  K4a launches in phase 18: {launches}; the group destroyed")
    say(f"  phase 18: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 19: the dry run held against a real run
# ---------------------------------------------------------------------------

DRY_PHI_LAYERS = 16               # phi served with the mesh, as in phase 18
# The dry run's peak of live storages against the card's: the card's
# ``max_memory_allocated`` over the run less what the allocator held
# beside the run's inputs when it started. They differ where the
# allocator differs from a count of storages: it rounds every block up
# to 512 bytes and hands out a cached block whole when less than 1 MiB of
# it would be left; the real run also uploads K4a's index tables (a few
# hundred bytes), and the dry run sees RoPE's host tables, which a real
# run makes with no aten op (16 KiB a layer at most). So 2 % of the peak
# plus 64 MiB.
DRY_PEAK_REL, DRY_PEAK_ABS = 0.02, 64 * 2 ** 20


def _serve_once(torch, M, cfg, params, tokens, mesh=None) -> None:
    """The serving cell's work: a prefill, then one decode step over the
    caches grown by one position."""
    s = tokens.shape[1]
    with torch.no_grad():
        logits, caches = M.prefill(cfg, params, {"tokens": tokens},
                                   mesh=mesh)
        caches = M.grow_caches(caches, s, s + 1)
        nxt = torch.argmax(logits[:, -1], -1)[:, None]
        M.decode_step(cfg, params, caches, nxt, s, mesh=mesh)


def phase_dryrun(torch, smi: str) -> dict:
    """Phase 19: each cell dry-run on a fake one-rank world, then run for
    real on the card under the same op counter, the counts held equal;
    then Mistral-NeMo ``decode_32k`` dry-run on a fake 256-rank world.
    Returns the K4a launches each run counted."""
    import dataclasses
    import gc
    import tempfile

    import torch.distributed as dist
    from repro_torch.combinators import clear_caches
    from repro_torch.configs import get_config
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.hw import HBM_BYTES
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.launch.op_analysis import (COLLECTIVE_KINDS, OpCounter,
                                                dry_run)
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import make_train_step, opt_state_shapes

    t_phase = time.perf_counter()
    say("== phase 19: the dry run (fake tensors, a fake world) held against "
        "a real run on the card: dot FLOPs, collective bytes and kernel "
        "launches equal, the peak within a bound; then Mistral-NeMo "
        "decode_32k on a fake 256-rank world ==")
    say(f"  card: {smi}")
    check(not dist.is_initialized(), "a process group before phase 19")
    dev = torch.device("cuda")
    gib = 2 ** 30
    launches = {}

    def drop():
        clear_caches()
        gc.collect()
        torch.cuda.empty_cache()

    def dry(make, work, mesh_world):
        """``work(inputs, mesh)`` on fake tensors from ``make("cpu")``."""
        mesh = (make_dev_mesh(1, 1, device="cpu", dry_run=True)
                if mesh_world else None)
        t0 = time.perf_counter()
        try:
            with dry_run() as c:
                inputs = make("cpu")
                work(inputs, mesh)
                del inputs
        finally:
            if mesh is not None:
                mesh.close()
        check(not dist.is_initialized(), "the fake world outlived its run")
        return c.result(), time.perf_counter() - t0

    def real(inputs, work, mesh):
        """``work`` on the card under a counter holding ``inputs``; the
        card's peak less what the allocator held beside the inputs."""
        torch.cuda.synchronize()
        c = OpCounter()
        c.hold(inputs)
        other = torch.cuda.memory_allocated() - c.live_bytes
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with c:
            work(inputs, mesh)
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return (c.result(), torch.cuda.max_memory_allocated() - other,
                secs, K.launch_counts())

    def held_equal(name, d, r, peak, counts, want_k4a):
        for k in COLLECTIVE_KINDS + ("dot_flops",):
            check(d[k] == r[k], (name, k, "dry", d[k], "real", r[k]))
        check(d["kernel_launches"] == r["kernel_launches"],
              (name, "launches", d["kernel_launches"], r["kernel_launches"]))
        k4a = d["kernel_launches"].get("tile_wide", {}).get("launches", 0)
        check(k4a == want_k4a == counts["tile"] == counts["tile_wide"]
              and sum(counts.values()) == 2 * k4a,
              (name, "K4a", k4a, want_k4a, counts))
        gap = peak - d["peak_bytes"]
        bound = DRY_PEAK_REL * d["peak_bytes"] + DRY_PEAK_ABS
        check(abs(gap) <= bound, (name, "peak", d["peak_bytes"], peak))
        return k4a, gap

    def report(name, d, ds, r, peak, rs, k4a, gap):
        say(f"  {name}: dot FLOPs {d['dot_flops']:.6e} (dry = real); "
            f"collective bytes {d['collective_total']:.0f} "
            f"({', '.join(f'{k} {d[k]:.0f}' for k in COLLECTIVE_KINDS if d[k])}"
            f"{'none' if not d['collective_total'] else ''}; dry = real); "
            f"K4a {k4a} (wide, dry = real, by launch); aten calls dry "
            f"{d['ops']}, real {r['ops']}; peak dry {d['peak_bytes'] / gib:.3f}"
            f" GiB, card {peak / gib:.3f} GiB (card - dry {gap / 2 ** 20:+.1f}"
            f" MiB; bound {DRY_PEAK_REL:.0%} + {DRY_PEAK_ABS >> 20} MiB); "
            f"dry {ds:.1f} s, real {rs:.2f} s")

    # -- serving: Mistral-NeMo-12B at 40 layers, prefill + one decode ------
    cfg = dataclasses.replace(get_config(SERVE_ARCH), head_shuffle="cuda")
    tok_shape = (SERVE_BATCH, SERVE_PROMPT)

    def serve_work(inputs, mesh):
        _serve_once(torch, M, cfg, inputs[0], inputs[1], mesh)

    d, ds = dry(lambda device: (D._materialize(M.param_shapes(cfg), device),
                                torch.zeros(tok_shape, dtype=torch.int64,
                                            device=device)),
                serve_work, False)
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, tok_shape, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    r, peak, rs, counts = real((params, tokens), serve_work, None)
    del params, tokens
    drop()
    k4a, gap = held_equal("serving", d, r, peak, counts,
                          4 * self_attention_layers(cfg))
    launches["serving (prefill + decode)"] = k4a
    report(f"{cfg.name} ({cfg.n_layers} layers, bf16; prefill "
           f"{SERVE_BATCH} x {SERVE_PROMPT} + one decode step)", d, ds, r,
           peak, rs, k4a, gap)

    # -- training: the same model cut to 4 layers, one step ------------------
    tcfg = dataclasses.replace(cfg, n_periods=TRAIN_LAYERS)
    ocfg = AdamWConfig(state_bits=tcfg.opt_bits)
    step, _ = make_train_step(tcfg, opt_cfg=ocfg)
    bshape = (TRAIN_BATCH, TRAIN_SEQ)

    def train_work(inputs, mesh):
        step(*inputs)

    def train_dry(device):
        p = D._materialize(M.param_shapes(tcfg), device)
        o = D._materialize(opt_state_shapes(tcfg, M.param_shapes(tcfg), ocfg),
                           device)
        b = {k: torch.zeros(bshape, dtype=torch.int64, device=device)
             for k in ("tokens", "labels")}
        return p, o, b
    d, ds = dry(train_dry, train_work, False)
    params = M.init(tcfg, torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(17)
    batch = {k: torch.randint(0, tcfg.vocab_size, bshape, generator=g,
                              device=dev) for k in ("tokens", "labels")}
    r, peak, rs, counts = real((params, adamw_init(params, ocfg), batch),
                               train_work, None)
    del params, batch
    drop()
    k4a, gap = held_equal("training", d, r, peak, counts,
                          12 * self_attention_layers(tcfg))
    launches["training step (4 layers)"] = k4a
    report(f"{tcfg.name} cut to {tcfg.n_layers} layers, one step of "
           f"{TRAIN_BATCH} x {TRAIN_SEQ} ({tcfg.opt_bits}-bit moments, remat "
           f"{tcfg.remat_policy})", d, ds, r, peak, rs, k4a, gap)

    # -- phi on a (1, 1) mesh: a fake world, then a real NCCL group ---------
    pcfg = dataclasses.replace(get_config(MESH_ARCH), head_shuffle="cuda",
                               n_periods=DRY_PHI_LAYERS)

    def phi_work(inputs, mesh):
        with torch.no_grad():
            M.prefill(pcfg, inputs[0], {"tokens": inputs[1]}, mesh=mesh)

    d, ds = dry(lambda device: (D._materialize(M.param_shapes(pcfg), device),
                                torch.zeros(tok_shape, dtype=torch.int64,
                                            device=device)),
                phi_work, True)
    params = M.init(pcfg, torch.Generator(device=dev).manual_seed(0))
    tokens = torch.randint(0, pcfg.vocab_size, tok_shape, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    mesh = make_dev_mesh(1, 1, device="cuda")
    try:
        check(dist.get_backend() == "nccl", dist.get_backend())
        r, peak, rs, counts = real((params, tokens), phi_work, mesh)
    finally:
        mesh.close()
    check(not dist.is_initialized(), "phase 19's NCCL group outlived it")
    del params, tokens
    drop()
    check(d["all-to-all"] > 0, ("phi: no all-to-all", d))
    k4a, gap = held_equal("phi with the mesh", d, r, peak, counts,
                          4 * self_attention_layers(pcfg))
    launches["phi mesh prefill (16 layers)"] = k4a
    report(f"{pcfg.name} at {pcfg.n_layers} layers, prefill {SERVE_BATCH} x "
           f"{SERVE_PROMPT} on a (1, 1) mesh (fake world, then one NCCL "
           f"rank)", d, ds, r, peak, rs, k4a, gap)

    # -- a production cell: decode_32k on a fake 256-rank world -------------
    with tempfile.TemporaryDirectory(prefix="dryrun_torch_") as out:
        rec = D.run_cell(SERVE_ARCH, "decode_32k", False, out, resume=False)
    check("error" not in rec, rec.get("traceback"))
    check(not dist.is_initialized(), "the 256-rank fake world outlived it")
    mem, ops = rec["memory"], rec["op_analysis"]
    check(mem["fits_hbm"] == (mem["peak_bytes"] <= HBM_BYTES), mem)
    say(f"  {SERVE_ARCH} decode_32k on a fake {rec['n_devices']}-rank world "
        f"({rec['mesh']}; rank 0 traced): {rec['trace_s']:.1f} s; dot FLOPs "
        f"per rank {ops['dot_flops']:.4e}; held parameters "
        f"{mem['held_param_bytes'] / 1e9:.2f} GB (spec: "
        f"{rec['param_bytes_per_device'] / 1e9:.3f}), kv cache "
        f"{mem['held_cache_bytes'] / 1e9:.1f} GB (spec: "
        f"{rec['cache_bytes_per_device'] / 1e9:.3f}); peak "
        f"{mem['peak_bytes'] / 1e9:.1f} GB; fits_hbm {mem['fits_hbm']}")
    secs = time.perf_counter() - t_phase
    check(secs < 60, ("phase 19 took", secs))
    say(f"  phase 19: {secs:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 20: the element types the reference's fused kernel takes
# ---------------------------------------------------------------------------

NEW_TYPES = ("float16", "int8", "uint8", "int16", "uint16", "uint32", "bool")
WIDE_TYPES = ("int64", "uint64", "float64")
# Norm-wise relative error of a planar FFT against the exact (float64, or
# for float64 itself the float64 library FFT): each product and sum
# rounds to the type (unit roundoff u = 2^-11 for float16, 2^-8 for
# bfloat16, 2^-53 for float64), and a radix-2 FFT's error grows like
# u * log2(N) at worst; the limit is that bound.
FFT_U = {"float16": 2.0 ** -11, "bfloat16": 2.0 ** -8, "float64": 2.0 ** -53}


def stack_frames(log: str, fragment: str) -> list:
    """(kernel, "N bytes stack frame") of each kernel whose mangled name
    holds ``fragment``, from an ``nvcc -Xptxas -v`` log."""
    out, name = [], None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = ln.split("Function properties for")[-1].strip()
        elif "stack frame" in ln and name is not None and fragment in name:
            out.append((name[:60], " ".join(ln.split()[:3])))
    return out


def phase_dtypes(torch, n_sort: int, n_fft: int, reps: int, bw: float,
                 smi: str) -> list:
    """Phase 20: the 2^n_sort sort of each new element type (the 64-bit
    ones too), the float16 and float64 sort gradients, the 2^n_fft FFT on
    float16, bfloat16 and float64 planar input and a map beside
    butterflies, through their entry points, each with the launch counts
    set to 0 just before and read just after; the largest cluster's K4b,
    guarded K4b and K5 bit for bit against their plain versions and timed
    beside their byte bound and the torch composite of the cluster
    (forward, or its backward under autograd). Returns the rows this phase
    adds to the kernels line."""
    say("== phase 20: element types ==")
    from repro_torch import guard, obs
    from repro_torch.combinators import (CmpHalves, FusedStage, Perm,
                                         compile_expr, program_cost)
    from repro_torch.combinators import execute as ex
    from repro_torch.combinators import fft as F
    from repro_torch.combinators import sort as S
    from repro_torch.combinators import vocab as V
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.kernels import build as B
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2616)
    signed = {1: torch.int8, 2: torch.int16, 4: torch.int32}
    rows = []

    def keys(dtype, n):
        if dtype == torch.bool:
            return torch.randint(0, 2, (1 << n,), generator=gen,
                                 device=dev) > 0
        if dtype.is_floating_point:
            return torch.randn(1 << n, generator=gen, device=dev,
                               dtype=torch.float64).to(dtype)
        raw = torch.randint(-2**31, 2**31 - 1, (1 << n,), generator=gen,
                            device=dev, dtype=torch.int64)
        size = torch.empty((), dtype=dtype).element_size()
        if size == 8:   # all 64 bits random
            low = torch.randint(0, 2**32, (1 << n,), generator=gen,
                                device=dev, dtype=torch.int64)
            return ((raw << 32) | low).view(dtype)
        return raw.to(signed[size]).view(dtype)

    def cold(fn, x):
        """``fn(x)`` with telemetry on and the launch counts set to 0 just
        before: (result, round trips counted, fused fallbacks, launch
        counts, kernel histogram)."""
        obs.reset()
        obs.enable(sync=True)
        K.reset_launch_counts()
        try:
            y = fn(x)
            torch.cuda.synchronize()
        finally:
            obs.disable()
        c = K.launch_counts()
        hist = {dict(lab)["kernel"]: v for (nm, lab), v
                in obs.counters().items() if nm == "dispatch.kernel"}
        rt = obs.counter_total("model.round_trips")
        fb = obs.counter_total("dispatch.fused_fallback")
        obs.reset()
        return y, rt, fb, c, hist

    def largest(prog):
        return max((s for s in prog if isinstance(s, FusedStage)
                    and s.computes), key=lambda s: len(s.computes))

    def row(name, src, launches, err, ms, dev_ms, plain_ms, bound_ms,
            composite_ms):
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": "src/repro/kernels/bmmc_permute.py:"
                                 + ("265" if "bwd" in name else "181"),
                     "launches": launches, "max_abs_err": err, "ms": ms,
                     "device_ms": dev_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": "bytes",
                     "library_ms": None, "composite_ms": composite_ms})
        say(f"  {name}: bit-equal to its plain version; {launches} "
            f"launches on its path; {ms:.4f} ms a call, {dev_ms:.4f} ms on "
            f"the device (bound {bound_ms:.4f} ms, "
            f"{bound_ms / dev_ms:.2f} of it), plain {plain_ms:.3f} ms"
            + f", torch composite {composite_ms:.3f} ms  [{smi}]")

    def k4b_rows(label, fs, t, x, launches, guarded_launches, composite):
        """K4b and the guarded K4b on cluster ``fs``: bit for bit against
        their plain versions (the guarded one with no flag), timed beside
        the cluster's torch composite ``composite``."""
        got = fused_call(K, ex, fs, t, x)
        want = fused_call(K, ex, fs, t, x, plain=True)
        check(max_abs_err(torch, got, want) == 0.0, ("K4b", label))
        plans, entries = ex._fused_plan_cached(fs, t)
        tabs, epi = ex._pass_tables(plans[0], entries, x)
        geo = K.plan_geometry(plans[0])
        flags = torch.zeros(1, dtype=torch.int32, device=dev)
        pflags = torch.zeros_like(flags)

        def guarded():
            return K.tiled_permute_tables(x, *tabs, geometry=geo,
                                          flags=flags, **epi)
        if guarded_launches is not None:
            g = guarded()
            gp = K.tiled_permute_tables_plain(x, *tabs, geometry=geo,
                                              flags=pflags, **epi)
            torch.cuda.synchronize()
            check(int(flags) == 0 and int(pflags) == 0,
                  ("guard flag", label))
            check(max_abs_err(torch, g, want) == 0.0
                  and max_abs_err(torch, gp, want) == 0.0,
                  ("guarded", label))
        nbytes = x.numel() * x.element_size()
        bound = 2 * nbytes / bw * 1e3
        if all(isinstance(s, (Perm, CmpHalves)) for s in fs.stages):
            check(max_abs_err(torch, composite(), want) == 0.0,
                  ("composite", label))
        else:   # butterflies: the ref engine may round apart
            c = composite().double()
            check(float(torch.linalg.vector_norm(c - want.double())
                        / torch.linalg.vector_norm(want.double()))
                  <= 8 * fs.bmmc.n * FFT_U.get(str(x.dtype)[6:], 2.0 ** -24),
                  ("composite", label))
        comp = cuda_ms(torch, composite, max(3, reps // 3))
        row(f"tile_fused[{label}]", KERNEL_INFO["tile_fused"][0], launches,
            0.0, cuda_ms(torch, lambda: fused_call(K, ex, fs, t, x), reps),
            device_ms(torch, lambda: fused_call(K, ex, fs, t, x)),
            cuda_ms(torch, lambda: fused_call(K, ex, fs, t, x, plain=True),
                    max(3, reps // 3), warmup=1), bound, comp)
        if guarded_launches is not None:
            row(f"tile_fused_guarded[{label}]",
                KERNEL_INFO["tile_fused_guarded"][0], guarded_launches, 0.0,
                cuda_ms(torch, guarded, reps), device_ms(torch, guarded),
                cuda_ms(torch, lambda: K.tiled_permute_tables_plain(
                    x, *tabs, geometry=geo, flags=pflags, **epi),
                    max(3, reps // 3), warmup=1), bound, comp)

    def k5_row(label, fs, t, x, ct, launches):
        """K5 on cluster ``fs`` bit for bit against its plain version,
        timed beside the torch composite's backward (autograd through the
        cluster's stages as torch calls, the forward not timed)."""
        got = bwd_call(K, ex, fs, t, x, ct)
        want = bwd_call(K, ex, fs, t, x, ct, plain=True)
        check(max_abs_err(torch, got, want) == 0.0, ("K5", label))
        nbytes = x.numel() * x.element_size()
        xr = x.clone().requires_grad_(True)
        v = composite_of(fs, xr, grad=True)()
        comp = cuda_ms(torch, lambda: torch.autograd.grad(
            v, xr, ct, retain_graph=True), max(3, reps // 3))
        row(f"tile_bwd[{label}]", KERNEL_INFO["tile_bwd"][0], launches, 0.0,
            cuda_ms(torch, lambda: bwd_call(K, ex, fs, t, x, ct), reps),
            device_ms(torch, lambda: bwd_call(K, ex, fs, t, x, ct)),
            cuda_ms(torch, lambda: bwd_call(K, ex, fs, t, x, ct, plain=True),
                    max(3, reps // 3), warmup=1), 3 * nbytes / bw * 1e3,
            comp)
        del v, xr

    def composite_of(fs, x, grad=False):
        """The cluster's stages as torch calls: each Perm an index_select of
        the bits (of the values, ``grad``) on a precomputed index, each
        CmpHalves ``cmp_min`` and ``cmp_max`` of the halves; a cluster of
        butterflies runs its stages on the ``ref`` engine (torch gathers and
        the butterfly's torch ops)."""
        if any(not isinstance(s, (Perm, CmpHalves)) for s in fs.stages):
            return lambda: ex.run_program(fs.stages, x, "ref")
        idx = {id(s): ref.bmmc_src_index(s.bmmc, dev) for s in fs.stages
               if isinstance(s, Perm)}

        def run():
            v = x
            for s in fs.stages:
                if isinstance(s, Perm):
                    v = (torch.index_select(v, 0, idx[id(s)]) if grad else
                         torch.index_select(K._bits(v), 0, idx[id(s)]).view(
                             x.dtype))
                else:
                    lo, hi = v.chunk(2)
                    v = torch.cat([K.cmp_min(lo, hi), K.cmp_max(lo, hi)])
            return v
        return run

    # the sort of every new type, the 64-bit ones too
    sorts_of = {torch.int8, torch.uint8, torch.int16, torch.float16,
                torch.int64, torch.float64}   # where torch.sort is the oracle
    for name in NEW_TYPES + WIDE_TYPES:
        dtype = getattr(torch, name)
        x = keys(dtype, n_sort)
        f = S.compiled_sort(n_sort)
        prog, t, plan_s = plan_program(f, x)
        y, rt, fb, c, hist = cold(f, x)
        fused = sum(1 for s in prog if isinstance(s, FusedStage)
                    and s.computes)
        cost = program_cost(prog, t, x.element_size())
        check(fb == 0, (name, "fused fallbacks", fb))
        check(rt == cost["round_trips"], (name, rt, cost["round_trips"]))
        check(c["tile_fused"] == fused == hist.get("fused"),
              (name, c["tile_fused"], fused, hist))
        if dtype in sorts_of:
            check(max_abs_err(torch, y, torch.sort(x).values) == 0.0,
                  (name, "torch.sort"))
        else:   # no torch.sort of the type: sorted, and the same keys
            def ordered(v):   # as int64 in the type's order
                w = K._int_view(v).to(torch.int64)
                if dtype == torch.uint64:
                    return w ^ (-2**63)
                return w & (0xFFFFFFFF if dtype == torch.uint32 else 0xFFFF
                            if dtype == torch.uint16 else -1)
            wide, xw = ordered(y), ordered(x)
            check(bool((wide[1:] >= wide[:-1]).all())
                  and torch.equal(wide, torch.sort(xw).values),
                  (name, "sorted"))
        graph_ms = cuda_ms(torch, lambda: f(x), reps)
        check(max_abs_err(torch, f(x), y) == 0.0, (name, "graph"))
        eager_ms = cuda_ms(torch, lambda: f.call_per_stage(x),
                           max(3, reps // 3), warmup=1)
        say(f"  sort of 2^{n_sort} {name} (t={t}): bit-equal "
            f"{'to torch.sort' if dtype in sorts_of else 'to the sorted keys'}; "
            f"plan {plan_s:.2f} s; fused fallbacks 0; round trips "
            f"{int(rt)} = program_cost; histogram {hist}; launches "
            f"{ {k: v for k, v in c.items() if v} }; graph {graph_ms:.3f} ms, "
            f"one call stage by stage {eager_ms:.3f} ms")
        with guard.guarded():
            yg, _, fbg, cg, _ = cold(f, x)
        check(max_abs_err(torch, yg, y) == 0.0 and fbg == 0
              and cg["tile_fused_guarded"] == fused
              and cg["tile_fused"] == 0, (name, "guarded sort", cg))
        fs = largest(prog)
        k4b_rows(name, fs, t, x, c["tile_fused"], cg["tile_fused_guarded"],
                 composite_of(fs, x))
        del x, y, yg
        torch.cuda.empty_cache()

    # the float16 and float64 sort gradients: K5 once a compute cluster
    for name in ("float16", "float64"):
        dtype = getattr(torch, name)
        x = keys(dtype, n_sort)
        w = torch.randn(1 << n_sort, generator=gen, device=dev,
                        dtype=torch.float64).to(dtype)
        f = S.compiled_sort(n_sort)
        prog, t, _ = plan_program(f, x)

        def grad(v):
            v = v.clone().requires_grad_(True)
            (w * f(v)).sum().backward()
            return v.grad
        gx, _, fb, c, _ = cold(grad, x)
        fused = sum(1 for s in prog if isinstance(s, FusedStage)
                    and s.computes)
        check(fb == 0 and c["tile_bwd"] == fused, (name, "gradient", fb, c))
        check(bool(torch.isfinite(gx).all()), (name, "gradient finite"))
        # distinct keys: the gradient is w scattered to the sorting
        # permutation
        order = torch.sort(x.double(), stable=True).indices
        if int(torch.unique(x).numel()) == x.numel():
            check(torch.equal(gx, torch.zeros_like(w).index_put_(
                (order,), w)), (name, "gradient = scattered w"))
        g_ms = cuda_ms(torch, lambda: grad(x), max(3, reps // 3))
        # with ties, the kernel route against the collapsed route, bit for
        # bit
        n_ties = min(n_sort, N_TIES)
        xt = torch.randint(0, 6, (1 << n_ties,), generator=gen,
                           device=dev).to(dtype)
        wt = torch.randn(1 << n_ties, generator=gen, device=dev,
                         dtype=torch.float64).to(dtype)
        ft = S.compiled_sort(n_ties)
        routes = {}
        for mega in (True, False):
            ex.BWD_MEGAKERNEL = mega
            try:
                v = xt.clone().requires_grad_(True)
                (wt * ft(v)).sum().backward()
                routes[mega] = v.grad
            finally:
                ex.BWD_MEGAKERNEL = True
        check(max_abs_err(torch, routes[True], routes[False]) == 0.0,
              (name, "gradient routes"))
        say(f"  {name} sort gradient at 2^{n_sort}: fused fallbacks 0, K5 "
            f"{c['tile_bwd']} launches (one a compute cluster); forward + "
            f"backward {g_ms:.3f} ms; at 2^{n_ties} keys with ties the K5 "
            f"route bit-equal to the collapsed route")
        ct = torch.randn(1 << n_sort, generator=gen, device=dev,
                         dtype=torch.float64).to(dtype)
        k5_row(name, largest(prog), t, x, ct, c["tile_bwd"])
        del x, w, gx, ct, routes
        torch.cuda.empty_cache()

    # the FFT on half-float and float64 planar input, forward and gradient
    z = torch.complex(torch.randn(1 << n_fft, generator=gen, device=dev,
                                  dtype=torch.float64),
                      torch.randn(1 << n_fft, generator=gen, device=dev,
                                  dtype=torch.float64))
    for name in ("float16", "bfloat16", "float64"):
        dtype = getattr(torch, name)
        xr = torch.stack([z.real, z.imag], dim=-1).to(dtype)
        g = F.compiled_fft(n_fft)
        prog, t, _ = plan_program(g, xr)
        y, rt, fb, c, hist = cold(F.fft_planar, xr)
        fused = sum(1 for s in prog if isinstance(s, FusedStage)
                    and s.computes)
        check(fb == 0 and c["tile_fused"] == fused, (name, "fft", fb, c))
        xc = torch.complex(xr[:, 0].double(), xr[:, 1].double())
        exact = torch.fft.fft(xc)
        got = torch.complex(y[:, 0].double(), y[:, 1].double())
        rel = float(torch.linalg.vector_norm(got - exact)
                    / torch.linalg.vector_norm(exact))
        tol = n_fft * FFT_U[name]
        check(rel <= tol, (name, "fft error", rel, tol))
        wg = torch.randn(xr.shape, generator=gen, device=dev,
                         dtype=torch.float64).to(dtype)

        def grad(v):
            v = v.clone().requires_grad_(True)
            (wg * F.fft_planar(v)).sum().backward()
            return v.grad
        _, _, fbg, cg, _ = cold(grad, xr)
        check(fbg == 0 and cg["tile_bwd"] == fused, (name, "fft grad", cg))
        # the library FFT of the whole transform in the nearest complex
        # type torch has on the card (complex32 for float16, complex64 for
        # bfloat16, complex128 for float64)
        lib = xc.to({"float16": torch.complex32, "bfloat16": torch.complex64,
                     "float64": torch.complex128}[name])
        lib_ms = cuda_ms(torch, lambda: torch.fft.fft(lib), reps)
        say(f"  FFT of 2^{n_fft} planar {name} (t={t}): fused fallbacks 0, "
            f"K4b {c['tile_fused']} launches = the model's clusters; "
            f"norm-wise relative error {rel:.3e} against float64 (limit "
            f"{tol:.3e} = log2(N) * unit roundoff); its gradient K5 "
            f"{cg['tile_bwd']} launches; graph "
            f"{cuda_ms(torch, lambda: g(xr), reps):.3f} ms, torch.fft.fft "
            f"({lib.dtype}) {lib_ms:.3f} ms  [{smi}]")
        fs = largest(prog)
        with guard.guarded():
            _, _, _, cgf, _ = cold(F.fft_planar, xr)
        check(cgf["tile_fused_guarded"] == fused, (name, "guarded fft", cgf))
        k4b_rows(f"{name} planar", fs, t, xr, c["tile_fused"],
                 cgf["tile_fused_guarded"], composite_of(fs, xr))
        ct = torch.randn(xr.shape, generator=gen, device=dev,
                         dtype=torch.float64).to(dtype)
        k5_row(f"{name} planar", fs, t, xr, ct, cg["tile_bwd"])
        del xr, y, ct, lib, xc, exact, got
        torch.cuda.empty_cache()

    # a map beside butterflies: v * 2 - 1 after the first FFT stage whose
    # cluster then holds it beside butterflies
    xr = F.to_planar(z)

    def mixed_of(prog):
        return [s for s in prog if isinstance(s, FusedStage)
                and {"Map", "Bfly"} <= {type(cc).__name__
                                        for cc, _ in s.computes}]
    for map_at in range(n_fft):
        stages = [V.bit_reverse(n_fft)]
        for s in range(n_fft):
            e = F._stage_core(s)
            for _ in range(n_fft - s - 1):
                e = V.two(e)
            stages.append(e)
            if s == map_at:
                stages.append(V.emap("twice_less_one", lambda v: v * 2 - 1))
        fm = compile_expr(V.seq(*stages))
        prog, t, _ = plan_program(fm, xr)
        if mixed_of(prog):
            break
    mixed = mixed_of(prog)
    y, rt, fb, c, _ = cold(fm, xr)
    check(fb == 0 and len(mixed) == 1, ("map beside butterflies", fb))
    wg = torch.randn(xr.shape, generator=gen, device=dev)

    def mgrad(v):
        v = v.clone().requires_grad_(True)
        (wg * fm(v)).sum().backward()
        return v.grad
    _, _, fbg, cg, _ = cold(mgrad, xr)
    check(fbg == 0 and cg["tile_bwd"] >= 1, ("map beside butterflies", cg))
    say(f"  FFT of 2^{n_fft} float32 with a map after stage {map_at}: the map and "
        f"its butterflies in one cluster, fused fallbacks 0, K4b "
        f"{c['tile_fused']} launches, K5 {cg['tile_bwd']} in its gradient")
    k4b_rows("float32 planar + map", mixed[0], t, xr, c["tile_fused"], None,
             composite_of(mixed[0], xr))
    ct = torch.randn(xr.shape, generator=gen, device=dev)
    k5_row("float32 planar + map", mixed[0], t, xr, ct, cg["tile_bwd"])
    del xr, y, ct, z
    torch.cuda.empty_cache()

    # sin in a map: K4b on the cluster that holds it, beside an exact map
    x = torch.randn(1 << n_sort, generator=gen, device=dev) * 100
    times = {}
    for mname, fn in (("sin", torch.sin), ("twice", lambda v: v * 2)):
        fsm = compile_expr(V.emap(mname, fn) >> S.sort_expr(n_sort))
        prog, t, _ = plan_program(fsm, x)
        first = next(s for s in prog if isinstance(s, FusedStage)
                     and s.computes)
        check(max_abs_err(torch, fused_call(K, ex, first, t, x),
                          fused_call(K, ex, first, t, x, plain=True)) == 0.0,
              (mname, "map cluster"))
        times[mname] = device_ms(torch, lambda: fused_call(K, ex, first, t,
                                                           x))
    log = B.BUILD_LOG.get("tile_fused", {}).get("ptxas", "")
    frames = (stack_frames(log, "tile_fused_items_kernelIfLi1ELi8ELb1E")
              + stack_frames(log, "map_trig"))
    say(f"  a sin map on 2^{n_sort} float32 keys in [-300, 300] (its large-"
        f"argument path): K4b {times['sin']:.4f} ms on the device against "
        f"{times['twice']:.4f} ms for v * 2 (the first sort cluster, bit-"
        f"equal to its plain version, eager torch.sin); stack frames of the "
        f"float32 map kernel and of map_trig (sinf, cosf): {frames}  "
        f"[{smi}]")
    say(f"  clocks, power, temperature: {clocks()}")
    return rows


# Phase 22: the map cases beyond a chain. Exact cases are held bit for bit
# against their plain versions (eager torch on the card); the
# transcendental ones (erf, log2, exp2, gelu, silu, softplus, a general
# pow) to MAP_DAG_ULPS units of the last place (the distance of the bit
# patterns): their libm calls and their contracted products are the same
# code as PyTorch's only where nvcc compiles them alike.
MAP_DAG_ULPS = 8


def map_dag_cases(torch) -> list:
    """(name, function, dtypes, exact) of phase 22's single-map cases: a
    DAG map, a where/comparison map, a 32-op tape and each new aten op
    once, on the types torch defines it for."""
    import functools
    F = torch.nn.functional
    fl = ("float32", "bfloat16", "float16", "float64")
    fi = fl + ("int32",)
    w = torch.where
    return [
        ("gelu-tanh written out (a DAG)", lambda v: 0.5 * v * (1 + torch.tanh(
            0.7978845608028654 * (v + 0.044715 * v * v * v))), fl, True),
        ("leaky ReLU by where", lambda v: w(v > 0, v, 0.01 * v), fl, True),
        ("32-op tape", lambda v: functools.reduce(
            lambda a, k: a * 0.5 + 0.25 * (k % 3), range(16), v), fl, True),
        ("32-op tape, int", lambda v: functools.reduce(
            lambda a, k: a * 3 + k, range(16), v), ("int32",), True),
        ("eq", lambda v: w(v == 1, v, -v), fi, True),
        ("ne", lambda v: w(v != 1, v, -v), fi, True),
        ("lt", lambda v: w(v < 1, v, 2 * v), fi, True),
        ("le", lambda v: w(v <= 1, v, 2 * v), fi, True),
        ("gt", lambda v: w(v > v * 2, v, -v), fi, True),
        ("ge", lambda v: w(v >= -1, v * v, v), fi, True),
        ("logical_not", lambda v: w(torch.logical_not(v > 0), v, 2 * v), fi,
         True),
        ("logical_and", lambda v: w(torch.logical_and(v > -2, v < 2), v * v,
                                    v), fi, True),
        ("logical_or", lambda v: w(torch.logical_or(v < -2, v > 2), -v, v),
         fi, True),
        ("maximum", lambda v: torch.maximum(v, -v), fi, True),
        ("minimum", lambda v: torch.minimum(v, v * 2), fi, True),
        ("pow 2", lambda v: v ** 2, fi, True),
        ("pow 3", lambda v: v ** 3, fi, True),
        ("pow 0.5", lambda v: torch.abs(v) ** 0.5, fl, True),
        ("pow -0.5", lambda v: (torch.abs(v) + 1) ** -0.5, fl, True),
        ("pow -1", lambda v: v ** -1, fl, True),
        ("pow -2", lambda v: v ** -2, fl, True),
        ("pow 1.7", lambda v: torch.abs(v) ** 1.7, fl, False),
        ("reciprocal", torch.reciprocal, fl, True),
        ("floor", lambda v: torch.floor(v * 3), fi, True),
        ("ceil", lambda v: torch.ceil(v * 3), fi, True),
        ("trunc", lambda v: torch.trunc(v * 3), fi, True),
        ("round", lambda v: torch.round(v * 2), fi, True),
        ("sign", torch.sign, fi, True),
        ("erf", torch.erf, fl, False),
        ("log2", lambda v: torch.log2(torch.abs(v) + 0.25), fl, False),
        ("exp2", torch.exp2, fl, False),
        ("gelu", F.gelu, fl, False),
        ("gelu tanh", lambda v: F.gelu(v, approximate="tanh"), fl, False),
        ("silu", F.silu, fl, False),
        ("softplus", lambda v: F.softplus(v, beta=2.0, threshold=4.0), fl,
         False),
        ("leaky_relu", lambda v: F.leaky_relu(v, 0.1), fl, True),
        ("hardtanh", lambda v: F.hardtanh(v, -0.5, 0.5), fl, True),
        ("relu6", F.relu6, fi, True),
        ("floor_divide", lambda v: v // 0.75, fl, True),
        ("floor_divide, int", lambda v: v // -3, ("int32",), True),
        ("div floor", lambda v: torch.div(v, 0.75, rounding_mode="floor"), fl,
         True),
        ("div trunc", lambda v: torch.div(v, 0.75, rounding_mode="trunc"), fl,
         True),
        ("div trunc, int", lambda v: torch.div(v, -3, rounding_mode="trunc"),
         ("int32",), True),
        ("remainder", lambda v: v % 0.75, fl, True),
        ("remainder, int", lambda v: v % -3, ("int32",), True),
        ("fmod", lambda v: torch.fmod(v, 0.75), fl, True),
        ("fmod, int", lambda v: torch.fmod(v, -3), ("int32",), True),
    ]


def map_typed_cases(torch) -> list:
    """(name, function, dtypes, exact) of phase 22's typed-tape cases:
    each cast inside a map and each aten op the DAG tapes left out, once,
    on the types it takes; all held bit for bit (each op as PyTorch's CUDA
    kernel computes it)."""
    F = torch.nn.functional
    fl = ("float32", "bfloat16", "float16", "float64")
    ints = ("int32", "int8", "int64")
    w = torch.where
    return [(name, fn, dts, True) for name, fn, dts in [
        ("cast tanh", lambda v: torch.tanh(v.float()).to(v.dtype), fl),
        ("cast affine", lambda v: (v.float() * 3 + 1).to(v.dtype), fl),
        ("cast mask", lambda v: (v > 0).to(v.dtype) * v, fl + ints),
        ("cast double", lambda v: (v.double() * 0.1).to(v.dtype), fl),
        ("cast half", lambda v: (v.half() * 3 - v.bfloat16()).to(v.dtype),
         fl),
        ("cast int", lambda v: (v.int() * 3).to(v.dtype) + v, fl),
        ("cast int half", lambda v: (v.float() * 0.5).to(v.dtype),
         ints + ("int16", "uint8")),
        ("cast long", lambda v: (v.long() * 3).to(v.dtype), ints),
        ("cast bool", lambda v: v.bool().to(v.dtype) + v, fl + ints),
        ("cast uint8", lambda v: v.to(torch.uint8).to(v.dtype) * 0.5 + v,
         fl),
        ("cast int64 float", lambda v: (v.to(torch.int64) + 7).float().to(
            v.dtype) + v, fl),
        ("cast uint64", lambda v: v.to(torch.uint64).to(v.dtype) + 1,
         ("int64", "int32")),
        ("cast float64 int32", lambda v: (v.double() * 0.75).to(
            torch.int32).to(v.dtype), ("int64", "int32")),
        ("isnan", lambda v: w(torch.isnan(torch.log(v)), 0.0, v), fl),
        ("isinf", lambda v: w(torch.isinf(torch.exp(v * 30)), -v, v), fl),
        ("isfinite", lambda v: w(torch.isfinite(torch.log(v)), v, 1.0), fl),
        ("nan_to_num", lambda v: torch.nan_to_num(torch.log(v)), fl),
        ("nan_to_num numbers", lambda v: torch.nan_to_num(
            torch.log(v), 1.0, 2.0, -3.0), fl),
        ("copysign", lambda v: torch.copysign(v, -1.0), fl),
        ("copysign value", lambda v: torch.copysign(v, v - 1), fl),
        ("signbit", lambda v: w(torch.signbit(v), v, -v * 2), fl),
        ("pow values", lambda v: torch.pow(v.abs() + 1, v * 0.5), fl),
        ("remainder values", lambda v: torch.remainder(v, v.abs() + 1), fl),
        ("fmod values", lambda v: torch.fmod(v, v.abs() + 0.5), fl),
        ("remainder and fmod values, int", lambda v: torch.remainder(
            v, v.abs() + 1) + torch.fmod(v, v.abs() + 3), ints),
        ("atan2", lambda v: torch.atan2(v, v + 1), fl),
        ("hypot", lambda v: torch.hypot(v, v + 1), fl),
        ("lerp", lambda v: torch.lerp(v, v * 2 + 1, 0.3), fl),
        ("lerp far", lambda v: torch.lerp(v, v * 2 + 1, 0.7), fl),
        ("addcmul", lambda v: torch.addcmul(v, v, v + 1, value=0.5), fl),
        ("addcmul value 1", lambda v: torch.addcmul(v, v, v + 1), fl),
        ("addcdiv", lambda v: torch.addcdiv(v, v, v.abs() + 1, value=0.3),
         fl),
        ("elu", F.elu, fl),
        ("elu alpha", lambda v: F.elu(v, 0.3), fl),
        ("selu", F.selu, fl),
        ("celu", lambda v: F.celu(v, 0.5), fl),
        ("hardsigmoid", F.hardsigmoid, fl),
        ("hardswish", F.hardswish, fl),
        ("mish", F.mish, fl),
        ("logsigmoid", F.logsigmoid, fl),
        ("hardshrink", lambda v: F.hardshrink(v, 1.0), fl),
        ("softshrink", lambda v: F.softshrink(v, 0.75), fl),
        ("threshold", lambda v: F.threshold(v, 0.5, 2.0), fl),
        ("threshold, int", lambda v: F.threshold(v, 3, -7), ints),
        ("logit", lambda v: torch.logit(torch.sigmoid(v)), fl),
        ("logit eps", lambda v: torch.logit(v * 0.2 + 0.5, 0.05), fl),
        ("tan", lambda v: torch.tan(v * 0.3), fl),
        ("atan", torch.atan, fl),
        ("asin", lambda v: torch.asin(v * 0.2), fl),
        ("acos", lambda v: torch.acos(v * 0.2), fl),
        ("sinh", torch.sinh, fl),
        ("cosh", torch.cosh, fl),
        ("asinh", torch.asinh, fl),
        ("acosh", lambda v: torch.acosh(v.abs() + 1), fl),
        ("atanh", lambda v: torch.atanh(v * 0.2), fl),
        ("erfc", torch.erfc, fl),
        ("erfinv", lambda v: torch.erfinv(v * 0.2), fl),
        ("log10", lambda v: torch.log10(v.abs() + 0.5), fl),
        ("xlogy", lambda v: torch.xlogy(v, v.abs() + 1), fl),
        ("sinc", torch.sinc, fl),
        ("round decimals", lambda v: torch.round(v * 3, decimals=1) + v, fl),
    ]]


def phase_map_dag(torch, n_sort: int, n_fft: int, reps: int, bw: float,
                  smi: str) -> list:
    """Phase 22: K4b and K5 on the maps the chain tapes left out, at the
    largest 2^n_sort sort cluster's geometry on a case's first type and
    the largest 2^(n_sort - 2) one's on its others (each case a map
    inserted in that cluster: an exact one in the middle, a
    transcendental one last, so that its rounding stays where it is
    made), then clusters of 6 and
    12 maps (K5 keeping the inputs of those that fit and recomputing the
    others'), then programs through ``compile_expr`` with the launch
    counts set to 0 just before each and read just after: ``emap(leaky)
    >> sort`` and its gradient, a sort with a map after each of its last
    12 compares, the 2^n_fft FFT with a DAG map beside its butterflies.
    Returns the rows this phase adds to the kernels line."""
    say("== phase 22: maps beyond the chain ==")
    import functools
    from repro_torch import obs
    from repro_torch.combinators import (CmpHalves, FusedStage, Perm,
                                         compile_expr)
    from repro_torch.combinators import execute as ex
    from repro_torch.combinators import fft as F
    from repro_torch.combinators import sort as S
    from repro_torch.combinators import vocab as V
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2919)
    rows = []

    def inputs(dtype, n):
        """Keys of 2^n: half uniform in [-4, 4), half multiples of 1/4
        there (ties, the halves of round, floor's integers), zeros of
        both signs; int32 in [-1000, 1000]."""
        if dtype == torch.int32:
            return torch.randint(-1000, 1001, (1 << n,), generator=gen,
                                 device=dev, dtype=torch.int32)
        if not dtype.is_floating_point:   # other integers: in [-100, 100)
            return torch.randint(-100, 100, (1 << n,), generator=gen,
                                 device=dev).to(dtype)
        cont = (torch.rand(1 << n, generator=gen, device=dev) - 0.5) * 8
        grid = torch.randint(-16, 17, (1 << n,), generator=gen,
                             device=dev).float() / 4
        u = torch.rand(1 << n, generator=gen, device=dev)
        v = torch.where(u < 0.5, cont, grid)
        v[:4] = torch.tensor([0.0, -0.0, 1.0, -1.0], device=dev)
        return v.to(dtype)

    @functools.lru_cache(maxsize=None)
    def cluster(itemsize, n=n_sort):
        t = ops.choose_tile(n, itemsize)
        fs = max(fused_cases(n, t, "sort"), key=lambda s: len(s.computes))
        return fs, t

    def with_maps(fs, t, dtype, maps):
        """The cluster's one tiled pass with ``maps`` (position, name,
        function) inserted: (keyword arguments, forward tables, backward
        tables) of the raw wrappers, the tables on the card."""
        plans, entries = ex._fused_plan_cached(fs, t)
        sig, scal, vmem, _ = map(list, ex._fused_kernel_args(entries, dtype))
        for pos, name, _ in sorted(maps, key=lambda m: m[0]):
            sig.insert(pos, ("map", name))
            scal.insert(pos, ())
            vmem.insert(pos, ())
        fns = [next(f for _, nm, f in maps if nm == sg[1]) for sg in sig
               if sg[0] == "map"]
        plan = plans[0]
        s0 = plan.src0.reshape(-1)
        inv = np.empty_like(s0)
        inv[s0] = np.arange(s0.size, dtype=s0.dtype)
        tabs = [torch.from_numpy(a).to(dev) for a in (
            plan.in_rows, plan.out_rows, plan.xor_low, plan.src0,
            inv.reshape(plan.src0.shape))]
        kw = dict(geometry=K.plan_geometry(plan), epilogue=tuple(sig),
                  epi_scalar=tuple(scal), epi_vmem=tuple(vmem),
                  map_fns=tuple(fns))
        return kw, tabs[:4], tabs[:3] + tabs[4:]

    def held(label, call, plain, exact, timed=True):
        """The error of ``call`` against ``plain`` (held to 0, or to
        MAP_DAG_ULPS) and, ``timed``, the text of its time: one call and
        device time (3 calls a graph)."""
        err = max_abs_err(torch, call(), plain())
        check(err == 0.0 if exact else err <= MAP_DAG_ULPS,
              ("phase 22", label, err))
        if not timed:
            return err, ""
        return err, (f" ({cuda_ms(torch, call, 3):.4f} ms a call, "
                     f"{device_ms(torch, call, inner=3):.4f} device)")

    def ulp(err):
        return "bit-equal" if not err else f"{err:.0f} ulp"

    def slots_of(x, kw):
        ents = K._epi_entries(kw["epilogue"], kw["epi_scalar"],
                              kw["epi_vmem"], kw["map_fns"], x.dtype)
        info = K._epi_launch_args(x.reshape(1, -1, 1), kw["geometry"], ents,
                                  n_buf=2)[2].info
        return info["maps"], info["map_slots"]

    # each case alone in the largest sort cluster, timed on its first type;
    # its other types at the largest 2^(n_sort - 2) sort cluster (the same
    # kernels at a quarter of the plain versions' work)
    worst = {True: 0.0, False: 0.0}
    for name, fn, dtypes, exact in (map_dag_cases(torch)
                                    + map_typed_cases(torch)):
        for dname in dtypes:
            timed = dname == dtypes[0]
            n = n_sort if timed else n_sort - 2
            dtype = getattr(torch, dname)
            fs, t = cluster(torch.empty((), dtype=dtype).element_size(), n)
            n_epi = len(fs.computes)
            kw, ft, bt = with_maps(fs, t, dtype, [(
                n_epi // 2 if exact else n_epi, "dag_" + name, fn)])
            x = inputs(dtype, n)
            err, ms = held((name, dname), lambda: K.tiled_permute_tables(
                x, *ft, **kw), lambda: K.tiled_permute_tables_plain(
                x, *ft, **kw), exact, timed)
            line = f"  {name}, {dname}: K4b {ulp(err)}{ms}"
            worst[exact] = max(worst[exact], err)
            if dtype.is_floating_point and "floor_divide" not in name:
                ct = inputs(dtype, n).flip(0).contiguous()
                err, ms = held(
                    (name, dname, "K5"),
                    lambda: K.tiled_permute_bwd_tables(x, ct, *bt, **kw),
                    lambda: K.tiled_permute_bwd_tables_plain(x, ct, *bt,
                                                             **kw),
                    exact, timed)
                worst[exact] = max(worst[exact], err)
                line += f"; K5 {ulp(err)}{ms}"
            say(line)
            del x
    say(f"  [{time.perf_counter() - _T0:.0f} s] the largest 2^{n_sort} sort "
        f"cluster (2^{n_sort - 2} past a case's first type) with one map "
        f"each: exact "
        f"cases bit-equal to eager torch (worst {worst[True]}), "
        f"transcendental ones within {worst[False]:.0f} of {MAP_DAG_ULPS} "
        f"ulp  [{smi}]")

    # clusters of 6 and 12 maps, forward and backward
    mix = [c for c in map_dag_cases(torch) if c[3] and "float64" in c[2]
           and "floor_divide" not in c[0]]
    for dname in ("float32", "float64"):
        dtype = getattr(torch, dname)
        fs, t = cluster(torch.empty((), dtype=dtype).element_size())
        n_epi = len(fs.computes)
        for n_maps in (6, 12):
            maps = [(k * (n_epi + n_maps) // n_maps, f"mix{k}_" + c[0], c[1])
                    for k, c in enumerate(mix[:n_maps])]
            kw, ft, bt = with_maps(fs, t, dtype, maps)
            x = inputs(dtype, n_sort)
            ct = inputs(dtype, n_sort).flip(0).contiguous()
            _, f_ms = held((n_maps, dname), lambda: K.tiled_permute_tables(
                x, *ft, **kw), lambda: K.tiled_permute_tables_plain(
                x, *ft, **kw), True)
            K.reset_launch_counts()
            K.tiled_permute_bwd_tables(x, ct, *bt, **kw)
            torch.cuda.synchronize()
            check(K.launch_counts()["tile_bwd"] == 1, ("one K5", n_maps))
            _, b_ms = held((n_maps, dname, "K5"),
                           lambda: K.tiled_permute_bwd_tables(x, ct, *bt,
                                                              **kw),
                           lambda: K.tiled_permute_bwd_tables_plain(
                               x, ct, *bt, **kw), True)
            n_m, slots = slots_of(x, kw)
            kept = n_m if slots >= n_m else slots - 1
            say(f"  {n_maps} maps in the largest 2^{n_sort} sort cluster, "
                f"{dname}: K4b bit-equal{f_ms}, K5 one launch, bit-equal"
                f"{b_ms}; K5 keeps {kept} maps' inputs and recomputes "
                f"{n_m - kept}  [{smi}]")
            del x, ct
    torch.cuda.empty_cache()

    def cold(fn, x):
        obs.reset()
        obs.enable(sync=True)
        K.reset_launch_counts()
        try:
            y = fn(x)
            torch.cuda.synchronize()
        finally:
            obs.disable()
        fb = obs.counter_total("dispatch.fused_fallback")
        obs.reset()
        return y, fb, K.launch_counts()

    def grad_of(f, w):
        def run(v):
            v = v.clone().requires_grad_(True)
            (w * f(v)).sum().backward()
            return v.grad
        return run

    def routes(f, x, w):
        got = {}
        for mega in (True, False):
            ex.BWD_MEGAKERNEL = mega
            try:
                got[mega] = grad_of(f, w)(x)
            finally:
                ex.BWD_MEGAKERNEL = True
        return max_abs_err(torch, got[True], got[False])

    def composite_of(fs, x):
        """The cluster's stages as torch calls: each Perm an index_select
        on a precomputed index, each CmpHalves ``cmp_min`` and ``cmp_max``
        of the halves, each Map its function."""
        idx = {id(s): ref.bmmc_src_index(s.bmmc, dev) for s in fs.stages
               if isinstance(s, Perm)}

        def run():
            v = x
            for s in fs.stages:
                if isinstance(s, Perm):
                    v = torch.index_select(v, 0, idx[id(s)])
                elif isinstance(s, CmpHalves):
                    lo, hi = v.chunk(2)
                    v = torch.cat([K.cmp_min(lo, hi), K.cmp_max(lo, hi)])
                else:
                    v = s.fn(v)
            return v
        return run

    def rows_of(label, fs, t, x, ct, fwd_launches, bwd_launches):
        nbytes = x.numel() * x.element_size()
        check(max_abs_err(torch, composite_of(fs, x)(), fused_call(
            K, ex, fs, t, x, plain=True)) == 0.0, ("composite", label))
        comp = cuda_ms(torch, composite_of(fs, x), 3)
        xr = x.clone().requires_grad_(True)
        v = composite_of(fs, xr)()
        comp_b = cuda_ms(torch, lambda: torch.autograd.grad(
            v, xr, ct, retain_graph=True), 3)
        del v, xr
        for name, call, plain, launches, bound, cm in (
                (f"tile_fused[{label}]", lambda: fused_call(K, ex, fs, t, x),
                 lambda: fused_call(K, ex, fs, t, x, plain=True),
                 fwd_launches, 2 * nbytes / bw * 1e3, comp),
                (f"tile_bwd[{label}]", lambda: bwd_call(K, ex, fs, t, x, ct),
                 lambda: bwd_call(K, ex, fs, t, x, ct, plain=True),
                 bwd_launches, 3 * nbytes / bw * 1e3, comp_b)):
            err = max_abs_err(torch, call(), plain())
            check(err == 0.0, (name, err))
            ms, dms = cuda_ms(torch, call, reps), device_ms(torch, call)
            plain_ms = cuda_ms(torch, plain, max(3, reps // 3), warmup=1)
            rows.append({"name": name, "route": "cuda",
                         "source": KERNEL_INFO[name.split("[")[0]][0],
                         "replaces": KERNEL_INFO[name.split("[")[0]][1],
                         "launches": launches, "max_abs_err": err, "ms": ms,
                         "device_ms": dms, "plain_ms": plain_ms,
                         "bound_ms": bound, "bound_by": "bytes",
                         "library_ms": None, "composite_ms": cm})
            say(f"  {name}: bit-equal to its plain version; {launches} "
                f"launches on its path; {ms:.4f} ms a call, {dms:.4f} ms on "
                f"the device (bound {bound:.4f} ms, {bound / dms:.2f} of it),"
                f" plain {plain_ms:.3f} ms, torch composite {cm:.3f} ms  "
                f"[{smi}]")

    # emap(leaky) >> sort and its gradient, float32 and bfloat16
    leaky = ("leaky", lambda v: torch.where(v > 0, v, 0.01 * v))
    f = compile_expr(V.emap(*leaky) >> S.sort_expr(n_sort))
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        x = torch.randn(1 << n_sort, generator=gen, device=dev).to(dtype)
        w = torch.randn(1 << n_sort, generator=gen, device=dev).to(dtype)
        y, fb, c = cold(f, x)
        check(fb == 0 and c["tile_fused"] >= 1, ("leaky >> sort", fb, c))
        want = torch.sort(torch.where(x > 0, x, 0.01 * x)).values
        check(max_abs_err(torch, y, want) == 0.0, ("leaky >> sort", dname))
        g, fbg, cg = cold(grad_of(f, w), x)
        check(fbg == 0 and cg["tile_bwd"] >= 1, ("leaky >> sort grad", cg))
        lib = ""
        if (dtype == torch.float32
                and int(torch.unique(x).numel()) == x.numel()):
            xr = x.clone().requires_grad_(True)
            (w * torch.sort(torch.where(xr > 0, xr, 0.01 * xr)).values
             ).sum().backward()
            check(max_abs_err(torch, g, xr.grad) == 0.0, ("leaky grad", "lib"))
            lib = ", bit-equal to autograd through torch.sort (distinct keys)"
        n_t = min(n_sort, N_TIES)
        ft = compile_expr(V.emap(*leaky) >> S.sort_expr(n_t))
        xt = torch.randint(-3, 4, (1 << n_t,), generator=gen,
                           device=dev).to(dtype)
        wt = torch.randn(1 << n_t, generator=gen, device=dev).to(dtype)
        check(routes(ft, xt, wt) == 0.0, ("leaky routes", dname))
        ms = cuda_ms(torch, lambda: f(x), reps)
        g_ms = cuda_ms(torch, lambda: grad_of(f, w)(x), max(3, reps // 3))
        say(f"  [{time.perf_counter() - _T0:.0f} s] emap(leaky) >> sort, "
            f"2^{n_sort} {dname}: bit-equal to "
            f"torch.sort, fused fallbacks 0 (forward and gradient), K4b "
            f"{c['tile_fused']}, K5 {cg['tile_bwd']} launches; the gradient"
            f"{lib}; at 2^{n_t} keys with ties the K5 route bit-equal to the "
            f"collapsed route; {ms:.3f} ms a call, forward + backward "
            f"{g_ms:.3f} ms  [{smi}]")
        if dtype == torch.float32:
            prog, t, _ = plan_program(f, x)
            fs = next(s for s in prog if isinstance(s, FusedStage) and any(
                type(cc).__name__ == "Map" for cc, _ in s.computes))
            ct = torch.randn(1 << n_sort, generator=gen, device=dev)
            rows_of("dag maps", fs, t, x, ct, c["tile_fused"], cg["tile_bwd"])
            del ct
        del x, w, y, g
        torch.cuda.empty_cache()

    # emap(tanh(v.float()).to(v.dtype)) >> sort on bfloat16: a typed tape
    # (casts around a float32 tanh) in K4b and K5
    cast_tanh = ("cast_tanh", lambda v: torch.tanh(v.float()).to(v.dtype))
    f = compile_expr(V.emap(*cast_tanh) >> S.sort_expr(n_sort))
    dtype = torch.bfloat16
    x = torch.randn(1 << n_sort, generator=gen, device=dev).to(dtype)
    w = torch.randn(1 << n_sort, generator=gen, device=dev).to(dtype)
    y, fb, c = cold(f, x)
    check(fb == 0 and c["tile_fused"] >= 1, ("cast tanh >> sort", fb, c))
    want = torch.sort(torch.tanh(x.float()).to(dtype)).values
    check(max_abs_err(torch, y, want) == 0.0, "cast tanh >> sort")
    g, fbg, cg = cold(grad_of(f, w), x)
    check(fbg == 0 and cg["tile_bwd"] >= 1, ("cast tanh >> sort grad", cg))
    check(bool(torch.isfinite(g).all()), "cast tanh >> sort grad finite")
    # the whole sort's gradient against autograd through torch.sort, on
    # 2^n_d keys whose mapped values are distinct (bfloat16 holds too few
    # values for 2^n_sort), and the K5 route against the collapsed route
    # at 2^n_ties keys with ties
    n_d = min(n_sort, 12)
    cand = torch.arange(-(1 << 15), 1 << 15, device=dev,
                        dtype=torch.int32).to(torch.int16).view(dtype)
    cand = cand[(cand.float().abs() > 1e-6) & (cand.float().abs() < 3)]
    _, inv, cnt = torch.unique(torch.tanh(cand.float()).to(dtype).float(),
                               return_inverse=True, return_counts=True)
    cand = cand[cnt[inv] == 1]
    check(cand.numel() >= 1 << n_d, ("distinct cast-tanh keys", cand.numel()))
    xd = cand[torch.randperm(cand.numel(), generator=gen,
                             device=dev)[:1 << n_d]]
    wd = torch.randn(1 << n_d, generator=gen, device=dev).to(dtype)
    fd = compile_expr(V.emap(*cast_tanh) >> S.sort_expr(n_d))
    gd, fbd, cd = cold(grad_of(fd, wd), xd)
    check(fbd == 0 and cd["tile_bwd"] >= 1, ("cast tanh grad, 2^n_d", cd))
    xr = xd.clone().requires_grad_(True)
    (wd * torch.sort(torch.tanh(xr.float()).to(dtype)).values).sum(
        ).backward()
    check(max_abs_err(torch, gd, xr.grad) == 0.0, ("cast tanh grad", "lib"))
    n_t = min(n_sort, N_TIES)
    ft = compile_expr(V.emap(*cast_tanh) >> S.sort_expr(n_t))
    xt = torch.randint(-3, 4, (1 << n_t,), generator=gen,
                       device=dev).to(dtype)
    wt = torch.randn(1 << n_t, generator=gen, device=dev).to(dtype)
    check(routes(ft, xt, wt) == 0.0, "cast tanh routes")
    ms = cuda_ms(torch, lambda: f(x), reps)
    g_ms = cuda_ms(torch, lambda: grad_of(f, w)(x), max(3, reps // 3))
    say(f"  [{time.perf_counter() - _T0:.0f} s] emap(torch.tanh(v.float())"
        f".to(v.dtype)) >> sort, 2^{n_sort} bfloat16: bit-equal to "
        f"torch.sort of the eager map, fused fallbacks 0 (forward and "
        f"gradient), K4b {c['tile_fused']}, K5 {cg['tile_bwd']} launches; "
        f"the gradient at 2^{n_d} keys of distinct mapped values bit-equal "
        f"to autograd through torch.sort; at 2^{n_t} keys with ties the K5 "
        f"route bit-equal to the collapsed route; {ms:.3f} ms a call, "
        f"forward + backward {g_ms:.3f} ms  [{smi}]")
    prog, t, _ = plan_program(f, x)
    fs = next(s for s in prog if isinstance(s, FusedStage) and any(
        type(cc).__name__ == "Map" for cc, _ in s.computes))
    ct = torch.randn(1 << n_sort, generator=gen, device=dev).to(dtype)
    rows_of("typed maps", fs, t, x, ct, c["tile_fused"], cg["tile_bwd"])
    del x, w, y, g, ct, xd, wd, gd, xr, xt, wt
    torch.cuda.empty_cache()

    # a sort with a map after each of its last 12 compares: one cluster
    # holds 12 maps
    mix12 = [(f"s{k}_" + c[0], c[1]) for k, c in enumerate(mix[:12])]

    def sort_with_maps(n, engine="cuda"):
        stages = list(S.compiled_sort(n).program(n))
        at = [i for i, s in enumerate(stages) if isinstance(s, CmpHalves)]
        for k, i in enumerate(reversed(at[-12:])):
            stages.insert(i + 1, V.emap(*mix12[k]))
        return compile_expr(V.seq(*stages), engine=engine)

    for dname in ("float32",):
        dtype = getattr(torch, dname)
        f12 = sort_with_maps(n_sort)
        x = inputs(dtype, n_sort)
        prog, t, _ = plan_program(f12, x)
        fs = max((s for s in prog if isinstance(s, FusedStage)),
                 key=lambda s: sum(type(cc).__name__ == "Map"
                                   for cc, _ in s.computes))
        n_m = sum(type(cc).__name__ == "Map" for cc, _ in fs.computes)
        y, fb, c = cold(f12, x)
        w = inputs(dtype, n_sort).flip(0).contiguous()
        g, fbg, cg = cold(grad_of(f12, w), x)
        check(fb == 0 and fbg == 0, ("12 maps", fb, fbg))
        # at 2^n_ties: the forward against the ref engine, the K5 route
        # against the collapsed route
        n_t = min(n_sort, N_TIES)
        xt = inputs(dtype, n_t)
        check(max_abs_err(torch, sort_with_maps(n_t)(xt),
                          sort_with_maps(n_t, "ref")(xt)) == 0.0,
              ("12 maps", dname, "forward against the ref engine"))
        check(routes(sort_with_maps(n_t), xt,
                     inputs(dtype, n_t).flip(0).contiguous()) == 0.0,
              ("12 maps routes", dname))
        plans, entries = ex._fused_plan_cached(fs, t)
        ents = K._epi_entries(*ex._fused_kernel_args(entries, dtype), dtype)
        info = K._epi_launch_args(x.reshape(1, -1, 1), K.plan_geometry(
            plans[0]), ents, n_buf=2)[2].info
        kept = n_m if info["map_slots"] >= n_m else info["map_slots"] - 1
        say(f"  [{time.perf_counter() - _T0:.0f} s] sort of 2^{n_sort} "
            f"{dname} with a map after each of its last "
            f"12 compares: its largest map cluster holds {n_m} maps, K5 "
            f"keeps {kept} maps' inputs and recomputes {n_m - kept}; fused "
            f"fallbacks 0, K4b {c['tile_fused']}, K5 {cg['tile_bwd']} "
            f"launches; at 2^{n_t} bit-equal to the same program on the ref "
            f"engine, and the K5 route to the collapsed route")
        ct = inputs(dtype, n_sort)
        rows_of(f"{n_m} maps {dname}", fs, t, x, ct, c["tile_fused"],
                cg["tile_bwd"])
        del x, w, y, g, ct
        torch.cuda.empty_cache()

    # the FFT with a DAG map beside its butterflies
    dag = ("dag_fft", lambda v: torch.where(v > 0, v * v, -v) * 0.5)
    z = torch.randn(1 << n_fft, generator=gen, device=dev,
                    dtype=torch.complex64)
    xr = F.to_planar(z)
    for map_at in range(n_fft):
        stages = [V.bit_reverse(n_fft)]
        for s in range(n_fft):
            e = F._stage_core(s)
            for _ in range(n_fft - s - 1):
                e = V.two(e)
            stages.append(e)
            if s == map_at:
                stages.append(V.emap(*dag))
        fm = compile_expr(V.seq(*stages))
        prog, t, _ = plan_program(fm, xr)
        mixed = [s for s in prog if isinstance(s, FusedStage)
                 and {"Map", "Bfly"} <= {type(cc).__name__
                                         for cc, _ in s.computes}]
        if mixed:
            break
    y, fb, c = cold(fm, xr)
    wg = torch.randn(xr.shape, generator=gen, device=dev)
    _, fbg, cg = cold(grad_of(fm, wg), xr)
    check(fb == 0 and fbg == 0 and cg["tile_bwd"] >= 1, ("fft dag", fb, cg))
    fs = mixed[0]
    check(max_abs_err(torch, fused_call(K, ex, fs, t, xr),
                      fused_call(K, ex, fs, t, xr, plain=True)) == 0.0,
          "fft dag K4b")
    ct = torch.randn(xr.shape, generator=gen, device=dev)
    check(max_abs_err(torch, bwd_call(K, ex, fs, t, xr, ct),
                      bwd_call(K, ex, fs, t, xr, ct, plain=True)) == 0.0,
          "fft dag K5")
    say(f"  [{time.perf_counter() - _T0:.0f} s] FFT of 2^{n_fft} planar "
        f"float32 with a DAG map after stage "
        f"{map_at}: the map beside butterflies in one cluster, fused "
        f"fallbacks 0, K4b {c['tile_fused']} and K5 {cg['tile_bwd']} "
        f"launches, both bit-equal to their plain versions; K4b "
        f"{device_ms(torch, lambda: fused_call(K, ex, fs, t, xr)):.4f} ms, "
        f"K5 {device_ms(torch, lambda: bwd_call(K, ex, fs, t, xr, ct)):.4f}"
        f" ms on the device  [{smi}]")
    del xr, z, y, ct
    torch.cuda.empty_cache()
    return rows


def planar_typed_maps(torch) -> list:
    """(name, function) of phase 22b's maps beside butterflies: a
    transcendental cast (float-family registers on the half floats, the
    word path on float64), a word-path map, an exact float-family cast."""
    return [("cast tanh", lambda v: torch.tanh(v.float()).to(v.dtype)),
            ("cast int", lambda v: (v.int() * 3).to(v.dtype) + v),
            ("cast affine", lambda v: (v.float() * 3 + 1).to(v.dtype))]


def phase_map_planar(torch, n_fft: int, reps: int, bw: float,
                     smi: str) -> list:
    """Phase 22b: ``emap(m) >> fft`` on 2^n_fft planar points of float32,
    bfloat16, float16 and float64 for each map of planar_typed_maps,
    through ``compile_expr`` with the launch counts set to 0 just before
    the program and its gradient and read just after: no fused fallback
    in either direction, the counted K5 passes equal to
    ``vjp_round_trips(n, t, dtype)``, the program bit-equal to the same
    program stage by stage on the ``ref`` engine (eager torch) and its
    gradient to autograd through it; the map cluster's K4b and K5 bit for
    bit against their plain versions and timed (one call, device); on the
    cast-tanh map also their plain versions and the cluster's torch
    composite (its stages on the ``ref`` engine, forward, and its backward
    under autograd). The maps share one FFT expression and run type by
    type, and the store of device tables is raised to 16 GiB for the
    phase (then emptied): the ``ref`` engine's index tables and twiddles
    of one 2^22 FFT outgrow its 1 GiB, so each of its passes would upload
    them again. Returns the rows this phase adds to the kernels line (the
    bfloat16 cast-tanh cluster)."""
    say("== phase 22b: typed maps beside butterflies ==")
    from repro_torch import obs
    from repro_torch.combinators import FusedStage, compile_expr
    from repro_torch.combinators import execute as ex
    from repro_torch.combinators import fft as F
    from repro_torch.combinators import vocab as V
    from repro_torch.kernels import bmmc_permute as K
    from repro_torch.kernels import map_lower as ML
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3131)
    rows = []

    def counted(f, x, w):
        """A cold ``(w * f(x)).sum()`` and its backward, the counts set to
        0 just before: (output, gradient, forward and backward fallbacks,
        counted backward round trips, launches after the forward and
        after the backward)."""
        obs.reset()
        obs.enable(sync=True)
        K.reset_launch_counts()
        try:
            xt = x.clone().requires_grad_(True)
            y = f(xt)
            torch.cuda.synchronize()
            fb, c = obs.counter_total("dispatch.fused_fallback"), \
                K.launch_counts()
            (w * y).sum().backward()
            torch.cuda.synchronize()
            return (y.detach(), xt.grad, fb,
                    obs.counter_total("dispatch.fused_fallback") - fb,
                    obs.counter_total("model.vjp_round_trips"), c,
                    K.launch_counts())
        finally:
            obs.disable()
            obs.reset()

    fft = F.fft_expr(n_fft)
    progs = []
    for mname, fn in planar_typed_maps(torch):
        name = "planar_" + mname.replace(" ", "_")
        expr = V.seq(V.emap(name, fn), fft)
        progs.append((mname, name, fn, compile_expr(expr),
                      compile_expr(expr, engine="ref")))
    keep = K._DEV_CACHE.max_bytes
    K._DEV_CACHE.max_bytes = 16 << 30
    try:
        for dname in ("float32", "bfloat16", "float16", "float64"):
            dtype = getattr(torch, dname)
            for mname, name, fn, f, fr in progs:
                typed = ML.lower_map(name, fn, dtype).typed
                x, w, ct = (torch.randn(1 << n_fft, 2, generator=gen,
                                        device=dev, dtype=torch.float64)
                            .to(dtype) for _ in range(3))
                prog, t, _ = plan_program(f, x)
                (fs,) = [s for s in prog if isinstance(s, FusedStage)
                         and {"Map", "Bfly"} <= {type(c).__name__
                                                 for c, _ in s.computes}]
                y, g, fb, fbg, rt, c, cg = counted(f, x, w)
                model = f.vjp_round_trips(n_fft, t, dtype)
                label = (mname, dname)
                check(fb == 0 and fbg == 0, (label, "fused fallbacks", fb,
                                             fbg))
                check(rt == model and model is not None,
                      (label, "vjp round trips", rt, model))
                check(c["tile_fused_ext"] == int(typed)
                      and c["tile_bwd"] == 0
                      and cg["tile_bwd_ext"] == int(typed)
                      and cg["tile_bwd"] >= 1, (label, "launches", c, cg))
                xr = x.clone().requires_grad_(True)
                yr = fr(xr)
                (w * yr).sum().backward()
                check(max_abs_err(torch, y, yr.detach()) == 0.0,
                      (label, "program"))
                check(max_abs_err(torch, g, xr.grad) == 0.0,
                      (label, "gradient"))
                del xr, yr
                row = mname == "cast tanh"
                times = {}
                for kname, call, plain in (
                        ("tile_fused", lambda: fused_call(K, ex, fs, t, x),
                         lambda: fused_call(K, ex, fs, t, x, plain=True)),
                        ("tile_bwd", lambda: bwd_call(K, ex, fs, t, x, ct),
                         lambda: bwd_call(K, ex, fs, t, x, ct,
                                          plain=True))):
                    err = max_abs_err(torch, call(), plain())
                    check(err == 0.0, (label, kname, err))
                    times[kname] = (cuda_ms(torch, call, reps),
                                    device_ms(torch, call),
                                    cuda_ms(torch, plain, 3, warmup=0)
                                    if row else None)
                (fm, fd, fp), (bm, bd, bp) = (times["tile_fused"],
                                              times["tile_bwd"])
                nbytes = x.numel() * x.element_size()
                line = (f"  emap({mname}) >> fft, 2^{n_fft} planar {dname} "
                        f"({'typed: ext' if typed else 'untyped: base'} "
                        f"kernels, t={t}): fused fallbacks 0 / 0, K5 passes "
                        f"{rt} = the model's; program and gradient bit-equal "
                        f"to eager torch and autograd; the map cluster's "
                        f"K4b bit-equal, {fm:.4f} ms a call, {fd:.4f} "
                        f"device, bound {2 * nbytes / bw * 1e3:.4f}; K5 "
                        f"bit-equal, {bm:.4f} a call, {bd:.4f} device, bound "
                        f"{3 * nbytes / bw * 1e3:.4f} ms; K4b "
                        f"{c['tile_fused']} (ext {c['tile_fused_ext']}), K5 "
                        f"{cg['tile_bwd']} (ext {cg['tile_bwd_ext']}) "
                        f"launches")
                if row:
                    comp = cuda_ms(torch, lambda: ex.run_program(
                        fs.stages, x, "ref"), 3)
                    xr = x.clone().requires_grad_(True)
                    v = ex.run_program(fs.stages, xr, "ref")
                    comp_b = cuda_ms(torch, lambda: torch.autograd.grad(
                        v, xr, ct, retain_graph=True), 3)
                    del v, xr
                    line += (f"; plain K4b {fp:.3f}, K5 {bp:.3f} ms, torch "
                             f"composite {comp:.3f}, backward {comp_b:.3f}")
                say(line + f"  [{smi}]")
                if label == ("cast tanh", "bfloat16"):
                    for kname, (ms, dms, pms), bound, cm, n_l in (
                            ("tile_fused", times["tile_fused"], 2, comp,
                             c["tile_fused_ext"]),
                            ("tile_bwd", times["tile_bwd"], 3, comp_b,
                             cg["tile_bwd_ext"])):
                        rows.append({
                            "name": f"{kname}[typed maps, planar]",
                            "route": "cuda", "source": KERNEL_INFO[kname][0],
                            "replaces": KERNEL_INFO[kname][1],
                            "launches": n_l, "max_abs_err": 0.0, "ms": ms,
                            "device_ms": dms, "plain_ms": pms,
                            "bound_ms": bound * nbytes / bw * 1e3,
                            "bound_by": "bytes", "library_ms": None,
                            "composite_ms": cm})
                del x, w, ct, y, g
            torch.cuda.empty_cache()
    finally:
        K._DEV_CACHE.max_bytes = keep
        K.clear_device_tables()
        torch.cuda.empty_cache()
    say(f"  [{time.perf_counter() - _T0:.0f} s] typed maps beside "
        f"butterflies: {len(progs)} maps x 4 float types, every check held")
    return rows


def twin_launches(out: str) -> dict:
    """The kernel launches a twin reported: every ``kernel launches...:
    name=count ...`` line of its output, summed."""
    counts: dict = {}
    for line in out.splitlines():
        if line.startswith("kernel launches"):
            for pair in line.split(":", 1)[1].split():
                k, v = pair.split("=")
                counts[k] = counts.get(k, 0) + int(v)
    return counts


def phase_examples(smi: str, card_sizes: dict) -> dict:
    """Run each example twin on the card at its default size, then the
    twins of ``card_sizes`` again at the card's size (``--n``),
    ``TWIN_WORKERS`` at a time, the card's sizes first; returns the
    launches of each kernel summed over all these runs, and under
    ``tile_serve`` the serving twin's K4a launches."""
    say(f"== phase 21: the example twins ({TWIN_WORKERS} at a time) ==")
    from concurrent.futures import ThreadPoolExecutor
    env = dict(os.environ, PYTHONPATH=str(HERE / "src"))
    runs = [(name, []) for name in EXAMPLE_TWINS]
    runs += [(name, ["--n", str(n)]) for name, n in card_sizes.items()]

    def run(name_extra):
        name, extra = name_extra
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, str(HERE / "examples" / name), "--device",
             "cuda"] + extra, cwd=HERE, env=env, capture_output=True,
            text=True, timeout=EXAMPLE_TIMEOUT_S)
        return res, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(TWIN_WORKERS) as pool:
        done = list(pool.map(run, runs[::-1]))[::-1]
    say(f"  all {len(runs)} runs: {time.perf_counter() - t0:.1f} s")
    total: dict = {}
    for (name, extra), (res, wall) in zip(runs, done):
        got = twin_launches(res.stdout)
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        ran = {k: v for k, v in got.items() if v}
        size = " ".join(extra) if extra else "default size"
        say(f"  {name} ({size}): exit {res.returncode} in {wall:.1f} s; "
            f"K4b (tile_fused) {got.get('tile_fused', 0)}, K5 (tile_bwd) "
            f"{got.get('tile_bwd', 0)} launches; all launched: {ran}  "
            f"[{smi}]")
        for line in res.stdout.splitlines():
            say(f"    | {line}")
        if res.returncode != 0:
            say(res.stderr[-4000:])
        check(res.returncode == 0, f"{name} {size} exited {res.returncode}")
        if name.startswith("serve_batch"):
            total["tile_serve"] = got.get("tile", 0)
    check(total.get("tile_fused", 0) > 0, "no twin launched K4b")
    check(total.get("tile_bwd", 0) > 0, "no twin launched K5")
    say(f"  launches summed over the twins' runs: "
        f"{ {k: v for k, v in total.items() if v} }")
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=30,
                    help="log2 elements of the main path (paper: 30)")
    ap.add_argument("--n-sort", type=int, default=N_SORT,
                    help="log2 keys of the combinator path's sort")
    ap.add_argument("--n-fft", type=int, default=N_FFT,
                    help="log2 points of the combinator path's FFT")
    ap.add_argument("--n-ties", type=int, default=N_TIES,
                    help="log2 keys of the gradient-route comparison")
    ap.add_argument("--n-perm", type=int, default=N_PERM,
                    help="log2 elements of the gradient's permutation chain")
    # phase 13 runs this script in fresh processes against one store
    ap.add_argument("--store-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--child-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)
    if args.store_child:
        return store_child(args)

    smi = phase_env(torch)
    bw = peak_bw(torch.cuda.get_device_name(0))
    old_so, ab = phase_build()
    records = phase_kernels(torch, N_SMALL, args.n, REPS, bw)
    counts = phase_main(torch, args.n, REPS, bw, old_so)

    phase_sweep(torch, args.n, REPS)
    records["tile_fused"] = phase_fused(torch, N_SMALL - 2, args.n_sort,
                                        args.n_fft, REPS, bw, ab)
    comb = phase_combinators(torch, args.n_sort, args.n_fft, REPS)

    say("== phase 8: launch counts ==")
    missing = [k for k in PERM_KERNELS if counts.get(k, 0) <= 0]
    check(not missing, f"kernels never launched on the main path: {missing}")
    check(comb["tile_fused"] > 0, "tile_fused never launched on the "
          "combinator path")
    say(f"  main path (phase 4): {counts}")
    say(f"  combinator path (cold calls of the sort, the descending sort "
        f"and the FFT): {comb}")
    counts["tile_fused"] = comb["tile_fused"]

    records["tile_bwd"] = phase_bwd_kernel(torch, N_SMALL - 2, args.n_sort,
                                           args.n_fft, REPS, bw, ab)
    counts["tile_bwd"] = phase_gradients(torch, args.n_sort, args.n_ties,
                                         args.n_fft, args.n_perm, REPS)
    check(counts["tile_bwd"] > 0, "tile_bwd never launched on the "
          "gradient path")
    say(f"  tile_bwd launches on the gradient path (the cold backwards of "
        f"the sort, tanh >> sort and the FFT): {counts['tile_bwd']}")

    g_counts, g_records, hashes = phase_guarded(torch, args.n, args.n_sort,
                                                REPS, bw, records, ab)
    records.update(g_records)
    for name in GUARDED.values():
        counts[name] = g_counts[name]
    phase_traps(torch, min(N_FAULT, args.n))
    phase_store(torch, args.n, args.n_sort, hashes)
    phase_chaos(torch)
    records["tile_serve"] = phase_serve(torch, bw, REPS, smi, old_so)
    counts["tile_serve"] = records["tile_serve"]["launches"]
    train_counts = phase_train(torch, smi)
    kinds = phase_kinds(torch, smi)
    kinds_counts = {"tile_serve": (sum(kinds["serve"].values()),
                                   sum(kinds["train"].values()))}
    mesh_counts = {"tile_serve": sum(phase_mesh(torch, smi, bw,
                                                REPS).values())}
    dry_counts = {"tile_serve": sum(phase_dryrun(torch, smi).values())}
    dtype_rows = phase_dtypes(torch, args.n_sort, args.n_fft, REPS, bw, smi)
    dag_rows = phase_map_dag(torch, args.n_sort, args.n_fft, REPS, bw, smi)
    dag_rows += phase_map_planar(torch, args.n_fft, REPS, bw, smi)
    ex_counts = phase_examples(smi, {
        "sorting_network_torch.py": args.n_sort,
        "fft_pipeline_torch.py": args.n_fft,
        "grad_permute_torch.py": args.n_ties})
    kernels = []
    for name, (src, replaces) in KERNEL_INFO.items():
        r = records[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "device_ms": r.get("device_ms"),
                        "permute_axis_ms": r.get("permute_axis_ms"),
                        "old_ms": r.get("old_ms"),
                        "old_device_ms": r.get("old_device_ms"),
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": "bytes", "library_ms": r["library_ms"],
                        "train_launches": train_counts.get(name, 0),
                        "kinds_launches": kinds_counts.get(name, (0, 0))[0],
                        "kinds_train_launches":
                            kinds_counts.get(name, (0, 0))[1],
                        "mesh_launches": mesh_counts.get(name, 0),
                        "dryrun_launches": dry_counts.get(name, 0),
                        "examples_launches": ex_counts.get(name, 0)})
    kernels += dtype_rows + dag_rows
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
