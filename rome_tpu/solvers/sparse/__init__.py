"""Sparsity-exploiting linear solver for the parametric path.

Nested-dissection multifrontal block-sparse Cholesky, designed for batched
accelerator execution: a one-time host-side symbolic phase (ordering, supernode
tree, index maps — numpy) and a fully batched device numeric phase (one
scatter-add assembly + ~log(n) level-batched dense partial factorizations +
two level-batched tree sweeps, all inside a single XLA program).

Reference contract: the Bayes-tree sparse elimination at the heart of the
reference solve (/root/reference/src/legacy/Slam.jl:261 solveTree!; SURVEY.md
§7 "Bayes-tree on accelerator") — here expressed as a fan-in multifrontal
method whose fronts are level-scheduled so every level is one batched op.
"""

from rome_tpu.solvers.sparse.symbolic import SymbolicChol, symbolic_factor
from rome_tpu.solvers.sparse.ndchol import (
    ndchol_assemble,
    ndchol_factorize,
    ndchol_solve,
    ndchol_takahashi,
)

__all__ = [
    "SymbolicChol",
    "symbolic_factor",
    "ndchol_assemble",
    "ndchol_factorize",
    "ndchol_solve",
    "ndchol_takahashi",
]
