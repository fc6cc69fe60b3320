"""Nested-dissection multifrontal Cholesky (solvers/sparse) tests.

Mirrors the role of the reference's Bayes-tree solve correctness tests
(SURVEY.md §3.4; /root/reference/src/legacy/Slam.jl:261 solveTree!): the
sparse factorization must reproduce the dense solve exactly, the selected
inverse must match the dense inverse on the filled pattern, and the full LM
driver with linear="ndchol" must land on the same optimum as the dense path.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rome_tpu import (
    FactorGraph,
    GNOptions,
    MvNormal,
    Pose2,
    Pose2Pose2,
    PriorPose2,
    solve_graph_parametric,
)
from rome_tpu.graph.lower import lower
from rome_tpu.solvers.linearize import (
    dense_normal_eqs,
    free_vector,
    linearize_all,
    normal_eq_entry_values,
    runtime_state,
)
from rome_tpu.solvers.sparse import (
    ndchol_assemble,
    ndchol_factorize,
    ndchol_solve,
    ndchol_takahashi,
    symbolic_factor,
)


@pytest.fixture(autouse=True)
def _x64():
    """These are exactness tests (sparse must equal dense to f64 accuracy);
    run the whole module under x64 like bench.py does in production."""
    with jax.enable_x64():
        yield


def _grid_graph(rows=6, cols=6, seed=0):
    """A 2D grid pose graph (odometry chain + cross links) — enough loop
    structure to force real separators and Schur updates."""
    rng = np.random.default_rng(seed)
    fg = FactorGraph()
    n = rows * cols
    for i in range(n):
        fg.add_variable(f"x{i}", Pose2)
    fg.add_factor(["x0"], PriorPose2(MvNormal([0, 0, 0], [0.1, 0.1, 0.05])))

    def noisy(dx, dy, dth):
        return MvNormal(
            [dx + rng.normal(0, 0.02), dy + rng.normal(0, 0.02),
             dth + rng.normal(0, 0.01)],
            [0.1, 0.1, 0.05],
        )

    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            if c + 1 < cols:
                fg.add_factor([f"x{i}", f"x{i+1}"], Pose2Pose2(noisy(1, 0, 0)))
            if r + 1 < rows:
                fg.add_factor(
                    [f"x{i}", f"x{i+cols}"], Pose2Pose2(noisy(0, 1, 0))
                )
    fg.init_all()
    return fg


def _symbolic_and_parts(fg, leaf=4):
    ga = lower(fg, dtype=jnp.float64)
    rt = runtime_state(ga)
    dofs = {t: ga.manifolds[t].dof for t in ga.type_names}
    specs = [(b.vtypes, np.asarray(b.vslots)) for b in ga.batches]
    sym = symbolic_factor(ga.type_names, ga.counts, dofs, specs, leaf=leaf)
    return ga, rt, sym


def _scaled_system(ga, rt, lam):
    lins = linearize_all(ga, ga.values0, rt)
    H, g = dense_normal_eqs(ga, lins, dtype=jnp.float64, rt=rt)
    diag = jnp.maximum(jnp.diag(H), 1e-8)
    Hd = H + lam * jnp.diag(diag)
    d = 1.0 / jnp.sqrt(jnp.maximum(jnp.diag(Hd), 1e-12))
    Hs = Hd * d[:, None] * d[None, :]
    return lins, Hs, -g * d


def _ndchol_factor(ga, rt, sym, lins, lam, jitter=0.0):
    arrs = sym.device_arrs()
    vals = normal_eq_entry_values(ga, lins, dtype=jnp.float64)
    fvec = free_vector(ga, rt).astype(jnp.float64)
    diag_H = jnp.zeros(sym.D, jnp.float64).at[arrs["diag_dst"]].add(
        vals[arrs["diag_src"]] * fvec[arrs["diag_dst"]] ** 2
    )
    dv = 1.0 / jnp.sqrt(jnp.maximum(diag_H * (1.0 + lam), 1e-12))
    df = dv * fvec
    diag_add = fvec * (lam / (1.0 + lam) + jitter) + (1.0 - fvec)
    Ws = ndchol_assemble(sym, arrs, vals, df, diag_add)
    Linvs, L21s, _L11s = ndchol_factorize(sym, arrs, Ws)
    return arrs, Linvs, L21s


def test_ndchol_matches_dense_solve():
    fg = _grid_graph()
    ga, rt, sym = _symbolic_and_parts(fg)
    assert sym.nlev >= 3, "grid should produce a real separator tree"
    lam = jnp.asarray(1e-4, jnp.float64)
    lins, Hs, b = _scaled_system(ga, rt, lam)
    x_dense = jnp.linalg.solve(Hs, b)
    arrs, Linvs, L21s = _ndchol_factor(ga, rt, sym, lins, lam)
    x_nd = ndchol_solve(sym, arrs, Linvs, L21s, b)
    np.testing.assert_allclose(
        np.asarray(x_nd), np.asarray(x_dense), rtol=0, atol=1e-9
    )


def test_ndchol_frozen_variables():
    """free=0 variables must behave as constants (zero update), matching
    the dense path's identity-row convention (fixed-lag freeze)."""
    fg = _grid_graph(4, 4)
    for lbl in ["x1", "x5"]:
        fg.variables[lbl].solvable = 0
    ga, rt, sym = _symbolic_and_parts(fg)
    lam = jnp.asarray(1e-3, jnp.float64)
    lins, Hs, b = _scaled_system(ga, rt, lam)
    x_dense = jnp.linalg.solve(Hs, b)
    arrs, Linvs, L21s = _ndchol_factor(ga, rt, sym, lins, lam)
    x_nd = ndchol_solve(sym, arrs, Linvs, L21s, b)
    np.testing.assert_allclose(
        np.asarray(x_nd), np.asarray(x_dense), rtol=0, atol=1e-9
    )
    # frozen slots: exactly zero update
    slots = [ga.var_labels["Pose2"].index(l) for l in ["x1", "x5"]]
    for s in slots:
        assert np.all(np.asarray(x_nd[s * 3 : s * 3 + 3]) == 0.0)


def test_takahashi_selected_inverse():
    fg = _grid_graph(5, 5)
    ga, rt, sym = _symbolic_and_parts(fg)
    lam = jnp.asarray(1e-4, jnp.float64)
    lins, Hs, _b = _scaled_system(ga, rt, lam)
    arrs, Linvs, L21s = _ndchol_factor(ga, rt, sym, lins, lam)
    Xs = ndchol_takahashi(sym, arrs, Linvs, L21s)
    Hinv = np.asarray(jnp.linalg.inv(Hs))
    for lvl in range(sym.nlev):
        n_l, sm, bm = sym.plan[lvl]
        if n_l == 0 or Xs[lvl] is None:
            continue
        sup_idx = np.asarray(sym.arrs[f"sup_idx_{lvl}"])
        X = np.asarray(Xs[lvl])
        for j in range(n_l):
            real = sup_idx[j] < sym.D
            ridx = sup_idx[j][real]
            blk = X[j][: len(sup_idx[j]), : len(sup_idx[j])][real][:, real]
            np.testing.assert_allclose(
                blk, Hinv[np.ix_(ridx, ridx)], rtol=0, atol=1e-8
            )


@pytest.mark.parametrize("schedule", ["host", "fused"])
def test_lm_ndchol_matches_dense32(schedule):
    """Full LM driver: linear='ndchol' reaches the same optimum as the
    dense path on a loopy graph."""
    fg_a, fg_b = _grid_graph(6, 6, seed=3), _grid_graph(6, 6, seed=3)
    opts = dict(
        max_iters=30, polish_tol=1e-8, polish_iters=40, lam0=1e-6,
        lam_down=0.1, lam_min=1e-12, chol_jitter=1e-7, ftol=1e-12,
        gtol=1e-10, nd_leaf=4,
    )
    res_nd = solve_graph_parametric(
        fg_a, init=False, options=GNOptions(linear="ndchol", **opts),
        chordal_init=True, schedule=schedule,
    )
    res_dn = solve_graph_parametric(
        fg_b, init=False, options=GNOptions(linear="dense32", **opts),
        chordal_init=True, schedule=schedule,
    )
    assert res_nd["stats"].converged
    assert res_dn["stats"].converged
    assert abs(res_nd["stats"].final_cost - res_dn["stats"].final_cost) <= (
        1e-6 * max(1.0, res_dn["stats"].final_cost)
    )
    for lbl in ["x5", "x17", "x35"]:
        np.testing.assert_allclose(
            fg_a.get_coords(lbl), fg_b.get_coords(lbl), atol=1e-4
        )


def test_marginal_covariances_takahashi_matches_dense():
    """Scalable covariance recovery (testParametricCovariances.jl contract):
    Takahashi selected inversion must reproduce the dense full-inverse
    marginals to 1e-6."""
    from rome_tpu.solvers.gauss_newton import marginal_covariances

    fg = _grid_graph(5, 5, seed=2)
    res = solve_graph_parametric(fg, init=False, chordal_init=True)
    assert res["stats"].converged
    ga = lower(fg, dtype=jnp.float64)
    covs_d = marginal_covariances(ga, ga.values0, method="dense")
    covs_t = marginal_covariances(ga, ga.values0, method="takahashi")
    for t in covs_d:
        np.testing.assert_allclose(
            np.asarray(covs_t[t]), np.asarray(covs_d[t]), rtol=0, atol=1e-6
        )


def test_ndchol_mixed_types_pose_landmark():
    """Mixed variable types (Pose2 dof-3 + Point2 dof-2) through the sparse
    solve: bearing-range SLAM structure (the reference's canonical
    pose+landmark graphs, e.g. testParametric.jl sightings)."""
    from rome_tpu import Normal, Point2, Pose2Point2BearingRange

    rng = np.random.default_rng(9)
    fg = FactorGraph()
    n = 40
    for i in range(n):
        fg.add_variable(f"x{i}", Pose2)
    for j in range(8):
        fg.add_variable(f"l{j}", Point2)
    fg.add_factor(["x0"], PriorPose2(MvNormal([0, 0, 0], [0.1, 0.1, 0.05])))
    for i in range(n - 1):
        fg.add_factor(
            [f"x{i}", f"x{i+1}"],
            Pose2Pose2(MvNormal([1, 0, rng.normal(0, 0.05)], [0.1, 0.1, 0.05])),
        )
    for i in range(0, n, 3):
        j = (i // 3) % 8
        fg.add_factor(
            [f"x{i}", f"l{j}"],
            Pose2Point2BearingRange(
                Normal(rng.uniform(-1, 1), 0.05), Normal(5.0, 0.3)
            ),
        )
    fg.init_all()
    ga, rt, sym = _symbolic_and_parts(fg, leaf=6)
    lam = jnp.asarray(1e-4, jnp.float64)
    lins, Hs, b = _scaled_system(ga, rt, lam)
    x_dense = jnp.linalg.solve(Hs, b)
    arrs, Linvs, L21s = _ndchol_factor(ga, rt, sym, lins, lam)
    x_nd = ndchol_solve(sym, arrs, Linvs, L21s, b)
    np.testing.assert_allclose(
        np.asarray(x_nd), np.asarray(x_dense), rtol=0, atol=1e-8
    )
    # full LM solve through the public API
    res = solve_graph_parametric(
        fg, init=False, options=GNOptions(linear="ndchol", nd_leaf=6),
        chordal_init=False,
    )
    assert res["stats"].converged


def test_symbolic_handles_disconnected_and_tiny():
    """Disconnected components and a graph smaller than the leaf size."""
    fg = FactorGraph()
    for i in range(3):
        fg.add_variable(f"x{i}", Pose2)
        fg.add_factor(
            [f"x{i}"], PriorPose2(MvNormal([i, 0, 0], [0.1, 0.1, 0.05]))
        )
    # two connected + one isolated
    fg.add_factor(
        ["x0", "x1"], Pose2Pose2(MvNormal([1, 0, 0], [0.1, 0.1, 0.1]))
    )
    fg.init_all()
    ga, rt, sym = _symbolic_and_parts(fg, leaf=1)
    lam = jnp.asarray(1e-3, jnp.float64)
    lins, Hs, b = _scaled_system(ga, rt, lam)
    arrs, Linvs, L21s = _ndchol_factor(ga, rt, sym, lins, lam)
    x_nd = ndchol_solve(sym, arrs, Linvs, L21s, b)
    np.testing.assert_allclose(
        np.asarray(x_nd), np.asarray(jnp.linalg.solve(Hs, b)),
        rtol=0, atol=1e-10,
    )


def _dot_generals(jaxpr):
    """Every dot_general equation in a closed jaxpr, sub-jaxprs included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for sub in jax.core.jaxprs_in_params(eqn.params):
            yield from _dot_generals(sub)


@pytest.mark.parametrize("blocked", [False, True])
def test_ndchol_f32_products_carry_highest_precision(blocked):
    """The f32 factor preconditions the solver's CG: its products must not be
    left to the backend's default precision (TF32 on a GPU), whatever the
    caller's jax_default_matmul_precision says."""
    fg = _grid_graph(6, 6)
    ga, rt, sym = _symbolic_and_parts(fg, leaf=2)
    arrs = sym.device_arrs()
    Ws = [
        jnp.broadcast_to(jnp.eye(sm + bm, dtype=jnp.float32), (n_l, sm + bm, sm + bm))
        for n_l, sm, bm in sym.plan
    ]
    b = jnp.ones((sym.D,), jnp.float32)

    def factor_and_solve(Ws, b):
        Linvs, L21s, _ = ndchol_factorize(sym, arrs, Ws, blocked=blocked)
        return ndchol_solve(sym, arrs, Linvs, L21s, b), ndchol_takahashi(
            sym, arrs, Linvs, L21s
        )

    with jax.default_matmul_precision("default"):
        jaxpr = jax.make_jaxpr(factor_and_solve)(Ws, b).jaxpr
    dots = [
        e for e in _dot_generals(jaxpr)
        if e.invars[0].aval.dtype == jnp.float32
    ]
    assert dots, "expected f32 products in the factorization"
    hi = jax.lax.Precision.HIGHEST
    assert all(e.params["precision"] == (hi, hi) for e in dots)
