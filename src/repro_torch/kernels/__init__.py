"""The permutation kernels: CUDA sources in ``csrc/``, their build
(:mod:`.build`), host wrappers with plain PyTorch versions
(:mod:`.bmmc_permute`), the gather oracle (:mod:`.ref`) and the class
dispatch (:mod:`.ops`)."""
