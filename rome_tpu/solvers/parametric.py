"""High-level parametric solve API — IIF.solveGraphParametric! analogue
(SURVEY.md §3.3).
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np

from rome_tpu.graph.graph import FactorGraph
from rome_tpu.graph.lower import lower, write_back
from rome_tpu.solvers.gauss_newton import (
    GNOptions,
    ParametricSolver,
    marginal_covariances,
)
from rome_tpu.solvers.linearize import runtime_state

logger = logging.getLogger("rome_tpu")


def solve_graph_parametric(
    fg: FactorGraph,
    solve_key: str = "parametric",
    init: bool = True,
    options: Optional[GNOptions] = None,
    compute_covariances: bool = False,
    dtype=None,
    chordal_init: bool = True,
    pad: bool = False,
    schedule: str = "fused",
):
    """Batch nonlinear least-squares solve of the whole graph.

    Mirrors ``IIF.solveGraphParametric!(fg)``: stacks every factor's
    (mean, sqrt-info) measurement (testParametric.jl:41), minimizes the
    whitened residual sum over the product manifold, writes results to the
    ``:parametric`` solveKey, and optionally recovers per-variable marginal
    covariances (testParametricCovariances.jl:33-55).

    Returns a result dict with stats, and covariances when requested.
    """
    import jax
    import jax.numpy as jnp

    if dtype is None:
        dtype = jnp.float64 if fg.params.dtype == "float64" else jnp.float32
    if init:
        fg.init_all(solve_key)

    if fg.params.multiproc and len(jax.devices()) > 1:
        # SolverParams.multiproc (reference: clique dispatch to Distributed
        # workers): run the factor-sharded solve over the full device mesh
        from rome_tpu.parallel.distributed import solve_graph_distributed

        return solve_graph_distributed(
            fg, solve_key=solve_key, chordal_init=chordal_init
        )

    ga = lower(fg, solve_key, dtype=dtype, pad=pad)

    # gauge check: a graph with no unary factor has a global gauge freedom;
    # anchor the first variable like the reference examples do by adding a
    # prior (ManhattanDatasetBatch.jl:30-33). We freeze instead of adding.
    has_unary = any(b.ftype.arity == 1 for b in ga.batches)
    frozen_gauge = None
    if not has_unary:
        t0 = ga.type_names[0]
        ga.free[t0] = ga.free[t0].at[0].set(0.0)
        frozen_gauge = ga.var_labels[t0][0]
        logger.warning(
            "graph has no prior factor; freezing %s as gauge anchor", frozen_gauge
        )

    opts = options or GNOptions(
        max_iters=fg.params.max_iters,
        lam0=fg.params.lm_lambda0,
    )
    t0 = time.time()
    values0 = ga.values0
    want_chordal = (
        chordal_init and "Pose2" in ga.counts and ga.counts["Pose2"] > 2
    )
    if want_chordal and schedule == "fused" and opts.fused_chordal:
        # opt-in fused path (GNOptions.fused_chordal): the chordal init
        # runs INSIDE the compiled solve program — one dispatch for init +
        # LM. Not the default: the merged program's one-time compile is
        # substantially longer, which the separate-programs path amortizes
        # better on short sessions (the steady-state win is ~2 dispatch
        # round-trips).
        pass
    elif want_chordal:
        from rome_tpu.solvers.init2d import chordal_init_pose2

        values0 = chordal_init_pose2(ga, values0)
    # structure-cached solver: identical (padded) shapes reuse the compiled
    # LM program; the graph's data rides in as the traced runtime_state
    solver = ParametricSolver.cached(ga, opts)
    run = solver.solve if schedule == "fused" else solver.solve_host
    values, stats = run(values0, rt=runtime_state(ga))
    dt = time.time() - t0

    write_back(fg, ga, values, solve_key)

    result = {
        "stats": stats,
        "solve_time_s": dt,
        "num_variables": fg.num_variables,
        "num_factors": fg.num_factors,
        "linear_solver": solver.linear,
        "gauge_frozen": frozen_gauge,
    }
    if compute_covariances:
        covs = marginal_covariances(ga, values)
        out = {}
        for t in ga.type_names:
            arr = np.asarray(covs[t], dtype=np.float64)
            for slot, label in enumerate(ga.var_labels[t]):
                out[label] = arr[slot]
        result["covariances"] = out
    return result


# reference-style alias
solveGraphParametric = solve_graph_parametric
