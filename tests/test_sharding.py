"""Multi-device distributed solve tests on the 8-device virtual CPU mesh —
the analogue of the reference's multiprocess test (testBeehiveGrow.jl:7-28):
same solve single- and multi-device, results must match."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from rome_tpu import GNOptions
from rome_tpu.canonical.generators import generate_graph_circle
from rome_tpu.graph.lower import lower
from rome_tpu.parallel.sharding import (
    make_sharded_gn_step,
    pad_batches_for_mesh,
    solve_distributed,
)
from rome_tpu.solvers.gauss_newton import ParametricSolver


def _fixture():
    fg = generate_graph_circle(8)
    fg.init_all()
    ga = lower(fg)
    rng = np.random.default_rng(1)
    ga.values0 = {
        t: ga.manifolds[t].normalize(
            v + jnp.asarray(rng.normal(size=v.shape) * 0.2, dtype=ga.dtype)
        )
        for t, v in ga.values0.items()
    }
    return ga


def test_pad_batches():
    ga = _fixture()
    ga2 = pad_batches_for_mesh(ga, 8)
    for b, b2 in zip(ga.batches, ga2.batches):
        assert b2.n % 8 == 0
        assert b2.n >= b.n
        np.testing.assert_array_equal(np.asarray(b2.weight[b.n:]), 0.0)


@pytest.mark.slow
@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_sharded_step_matches_single(ndev):
    """One distributed GN step across N devices equals the single-device
    step (same cost trajectory)."""
    ga = _fixture()
    devices = np.array(jax.devices()[:ndev])
    mesh = Mesh(devices, ("f",))
    step, ga_p = make_sharded_gn_step(ga, mesh, pcg_iters=100, pcg_tol=1e-10)
    lam = jnp.asarray(1e-6, dtype=ga.dtype)
    v1, c0, c1, g, ok = step(ga_p.values0, lam)
    assert bool(ok)

    solver = ParametricSolver(ga, GNOptions(linear="pcg", pcg_iters=100, pcg_tol=1e-10))
    v2, lam2, c0s, c1s, gs, ds, oks, _ps, _exact, _cg = solver._step(
        ga.values0, lam, solver._rt0
    )
    assert abs(float(c0) - float(c0s)) < 1e-3 * max(1.0, abs(float(c0s)))
    assert abs(float(c1) - float(c1s)) < 2e-2 * max(1.0, abs(float(c1s)))
    for t in v1:
        np.testing.assert_allclose(np.asarray(v1[t]), np.asarray(v2[t]), atol=5e-3)


@pytest.mark.slow
def test_fused_solve_device_count_invariance():
    """The fused distributed LM must converge with the SAME reason code and
    nearly the same iteration count at every device count — psum reduction
    order must not flip a convergence signal (a 2-device 'stalled' drift
    was seen before the rejected-step ftol rule)."""
    import __graft_entry__ as ge

    ga = ge._build_chain_fixture(1024)
    results = {}
    for ndev in (1, 2, 4, 8):
        mesh = Mesh(np.array(jax.devices()[:ndev]).reshape(ndev), ("f",))
        step, ga_p = make_sharded_gn_step(ga, mesh, pcg_iters=100)
        lam = jnp.asarray(1e-4, dtype=ga_p.dtype)
        _v, it, code, fc = step.solve(ga_p.values0, lam)
        results[ndev] = (int(it), int(code), float(fc))
    codes = {r[1] for r in results.values()}
    assert codes == {3}, f"reason codes differ across device counts: {results}"
    iters = [r[0] for r in results.values()]
    assert max(iters) - min(iters) <= 4, results
    costs = [r[2] for r in results.values()]
    assert max(costs) <= min(costs) * 1.5 + 1e-12, results


@pytest.mark.slow
def test_solve_distributed_converges():
    ga = _fixture()
    from rome_tpu.solvers.linearize import cost_at

    cost0 = float(cost_at(ga, ga.values0))
    mesh = Mesh(np.array(jax.devices()[:8]), ("f",))
    values, stats = solve_distributed(ga, mesh, max_iters=25, pcg_iters=100)
    assert stats["final_cost"] < cost0 * 1e-3
    assert stats["iterations"] > 0


def test_multiproc_route_matches_single_device_solve():
    """SolverParams.multiproc sends solve_graph_parametric through the
    factor-sharded solve over every device (8 virtual here), from the same
    chordal init; it must land on the single-device optimum."""
    from rome_tpu import solve_graph_parametric

    def graph():
        fg = generate_graph_circle(24)
        fg.init_all()
        for lbl in fg.ls(r"^x\d+$")[1:]:  # push the init off the optimum
            fg.init_variable(lbl, fg.get_coords(lbl) + np.array([0.3, -0.2, 0.1]))
        return fg

    fg1 = graph()
    single = solve_graph_parametric(fg1, init=False)["stats"]
    fg8 = graph()
    fg8.params.multiproc = True
    res = solve_graph_parametric(fg8, init=False)
    assert res["mesh"] == (("f", len(jax.devices())),)
    assert res["stats"]["converged"]
    assert abs(res["stats"]["final_cost"] - single.final_cost) <= 1e-4 * max(
        1.0, single.final_cost
    )
    for lbl in fg1.ls(r"^x\d+$"):
        np.testing.assert_allclose(
            fg8.get_coords(lbl, "parametric"), fg1.get_coords(lbl, "parametric"),
            atol=1e-3,
        )
