"""PyTorch/CUDA port of the BMMC permutation system.

The counterpart of the JAX package :mod:`repro`, which stays the
reference. Offline planning (:mod:`.core`) is numpy; the kernels
(:mod:`.kernels`) are CUDA C++ for Hopper (``sm_90a``) built at first
use, each with a plain PyTorch version that serves CPU tensors. This
package imports neither JAX nor :mod:`repro`.

Entry points: :func:`repro_torch.kernels.ops.bmmc_permute`, the
combinator programs of :mod:`repro_torch.combinators`, and the LM server
:mod:`repro_torch.launch.serve` (dense configurations).
"""
