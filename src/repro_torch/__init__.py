"""PyTorch/CUDA port of the BMMC permutation system.

The counterpart of the JAX package :mod:`repro`, which stays the
reference. Offline planning (:mod:`.core`) is numpy; the kernels
(:mod:`.kernels`) are CUDA C++ for Hopper (``sm_90a``) built at first
use, each with a plain PyTorch version that serves CPU tensors. This
package imports neither JAX nor :mod:`repro`.

Entry point: :func:`repro_torch.kernels.ops.bmmc_permute`.
"""
