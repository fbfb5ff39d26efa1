"""Array combinators over BMMC index permutations (paper §7, generalized).

The counterpart of :mod:`repro.combinators`: a lazy expression IR
(:mod:`.ir`), a vocabulary of named combinators (:mod:`.vocab`), a
fusing optimizer implementing the §7.2 rewrite algebra (:mod:`.optimize`),
and a multi-engine executor with a compiled-plan cache (:mod:`.execute`).
Workloads: the balanced-periodic sorting network (:mod:`.sort`) and a
radix-2 FFT (:mod:`.fft`). Programs are differentiable: a compiled
expression called on a tensor that requires grad records one autograd
rule whose backward runs the compiled backward (on the ``"cuda"``
engine, the gradient kernel K5 per compute cluster).

Quick tour::

    from repro_torch.combinators import vocab as V, compile_expr

    e = V.riffle(10) >> V.bit_reverse(10) >> V.rev(10)
    f = compile_expr(e)              # one fused tiled pass, on "cuda"
    y = f(x)                         # x: a tensor of 2^10 elements
"""
from .ir import (Bfly, CmpHalves, Compose, Expr, Id, Ilv, Map, ParmE, Perm,
                 Seq, Two, seq)
from .optimize import (FusedStage, cluster, expand_clusters, fold_free, fuse,
                       inverse_program, inverse_stage, is_perm_program,
                       lower, num_perm_stages, optimize, program_cost)
from .execute import (CompiledExpr, cache_stats, clear_caches, compile_expr,
                      engines, fused_apply, get_engine, perm_apply,
                      program_apply, register_engine, run_program)
from . import vocab
from .sort import compiled_sort, sort_expr
# NB: the fft *function* stays in .fft to avoid shadowing the submodule
# attribute (``repro_torch.combinators.fft`` must remain the module).
from .fft import compiled_fft, fft_expr

__all__ = [
    "Bfly", "CmpHalves", "Compose", "Expr", "Id", "Ilv", "Map", "ParmE",
    "Perm", "Seq", "Two", "seq", "FusedStage", "cluster", "expand_clusters",
    "fold_free", "fuse", "inverse_program", "inverse_stage",
    "is_perm_program", "lower", "num_perm_stages", "optimize",
    "program_cost", "CompiledExpr", "cache_stats", "clear_caches",
    "compile_expr", "engines", "fused_apply", "get_engine", "perm_apply",
    "program_apply", "register_engine", "run_program",
    "vocab", "compiled_sort", "sort_expr", "compiled_fft", "fft_expr",
]
