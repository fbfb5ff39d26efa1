"""Target-hardware constants for roofline analysis: one NVIDIA H100.

The counterpart of :mod:`repro.launch.hw`, under its names. Every value
is for the H100 SXM5 80GB HBM3 at its 700 W power limit, from NVIDIA's
data sheet (dense rates, no sparsity); a card set below 700 W runs
slower under load. None of the reference's TPU v5e values carries over.
"""

# H100 SXM5 80GB HBM3, 700 W, data sheet: bf16 tensor-core peak, dense
PEAK_FLOPS_BF16 = 989e12     # FLOP/s per GPU
# H100 SXM5 80GB HBM3, 700 W, data sheet: HBM3 bandwidth
HBM_BW = 3.35e12             # bytes/s per GPU
# H100 SXM5 80GB HBM3, 700 W, data sheet: NVLink 4, 900 GB/s in all,
# 450 GB/s each way (the reference's ICI_BW is per link and direction)
ICI_BW = 450e9               # bytes/s per GPU, per direction
# H100 SXM5 80GB HBM3, 700 W, data sheet: 80 GB of HBM3
HBM_BYTES = 80 * 10**9       # bytes per GPU

# H100 SXM5 80GB HBM3, 700 W, data sheet: an HGX H100 node holds 8 GPUs,
# all to all over NVLink. The reference counts a 16x16 v5e pod and two
# of them; the port counts GPUs in the same two meshes.
GPUS_PER_NODE = 8
CHIPS_SINGLE_POD = 256       # a (16, 16) mesh: 32 nodes
CHIPS_MULTI_POD = 512        # a (2, 16, 16) mesh: 64 nodes
