"""Smoke run of both SLAM solve paths on one NVIDIA GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the distributed phase only

Phases (one process, one card):

1. device check: JAX's first device must be a GPU; there is no CPU fallback.
2. parametric batch: data/citygrid.g2o (10,000 poses + the x0 prior) through
   ``solve_graph_parametric`` with bench.py's ``big`` options (ndchol, fused
   chordal init), x64 on, the library's own matmul precision. Gate:
   converged, aligned ATE <= 1.0 m against data/citygrid_gt.npz, final cost
   <= ref * 1.002 + 1e-3.
3. covariance recovery: Takahashi selected inversion on the same graph, 32
   sampled poses against an exact f64 scipy solve. Gate: max rel err <= 1e-4.
4. multimodal: beehive-100 through ``solve_graph_nonparametric`` (3 sweeps,
   N=100, batched engine, points init). Gate: mean belief position error
   <= 0.5 m against the parametric optimum.
5. Gibbs scoring: the scoring path the sweep uses against the vmapped
   ``man.local`` reference (both f32 on the card) and against an f64 NumPy
   reference, for SE(2) and Point2 at N = Nj = 100 and 4096.

``--four-cards`` runs the multi-device paths over a 1-D mesh of four cards
and compares each with the same solve on one card: the factor-sharded
``SolverParams.multiproc`` solve of citygrid-10k, and the owner-computes
varpart solver on a 4096-pose corridor chain.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``; any failed phase
raises and the script exits non-zero without printing it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CITYGRID_GT = os.path.join(ROOT, "data", "citygrid_gt.npz")
CITYGRID_ATE_GATE_M = 1.0  # 0.1 m per metre of edge length, 10 m blocks
CHAIN_ATE_GATE_M = 0.1  # 1 m edges


class PhaseFailed(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise PhaseFailed(what)
    print(f"  gate ok: {what}", flush=True)


def require_gpu(count=1):
    """The device check: JAX's devices must be GPUs, at least ``count``.
    Exits non-zero otherwise."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < count:
        sys.exit(
            f"chip_smoke: needs {count} GPU(s); JAX found "
            f"{len(devs)} x {devs[0].platform} ({devs[0].device_kind})"
        )
    return devs


def gpu_name_and_power_limit():
    """The nvidia-smi line, read in a child process that does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def phase_parametric(card):
    import bench

    row = bench._solve_dataset(
        bench.CITYGRID, CITYGRID_GT, bench._opts()["big"],
        ate_gate=CITYGRID_ATE_GATE_M,
    )
    print(
        f"parametric citygrid-10k: {row['iterations']} LM iterations, "
        f"cost {row['final_cost']!r} (ref {row['ref_cost']!r}), aligned ATE "
        f"{row['ate_rmse_m']} m; cold {row['warmup_time_s']} s, warm "
        f"{row['solve_time_s']} s (runs {row['warm_runs_s']}) on {card}",
        flush=True,
    )
    check(row["converged"], "citygrid-10k converged")
    check(row["ate_rmse_m"] <= CITYGRID_ATE_GATE_M,
          f"aligned ATE {row['ate_rmse_m']} <= {CITYGRID_ATE_GATE_M} m")
    check(row["final_cost"] <= row["ref_cost"] * 1.002 + 1e-3,
          f"final cost {row['final_cost']!r} <= ref*1.002+1e-3")
    return row


def phase_covariance(card):
    import jax

    import bench
    from rome_tpu.graph.lower import lower
    from rome_tpu.solvers.gauss_newton import marginal_covariances

    ga = lower(bench._build_graph(bench.CITYGRID))
    t0 = time.perf_counter()
    covs = marginal_covariances(ga, ga.values0, method="takahashi")
    jax.block_until_ready(covs["Pose2"])
    dt = time.perf_counter() - t0
    xc = bench._covariance_crosscheck(ga, covs, k=32)
    print(
        f"covariance takahashi: {ga.counts['Pose2']} poses in {dt} s "
        f"(first call) on {card}; {xc}", flush=True,
    )
    check(bool(np.isfinite(np.asarray(covs["Pose2"])).all()), "covariances finite")
    check(xc["accuracy_ok"],
          f"max rel err {xc['max_rel_err_sampled']} <= {xc['rel_tol']}")
    return xc


def phase_multimodal(card):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import bench_multimodal

    row = bench_multimodal.bench_beehive()["points_init"]
    print(f"multimodal beehive-100: {row} on {card}", flush=True)
    check(row["mean_pos_err_vs_parametric_m"] <= 0.5,
          f"mean belief error {row['mean_pos_err_vs_parametric_m']} <= 0.5 m")
    return row


def _score_f64(kind, ref, mu, pts, inv_var):
    """Plain NumPy f64 Gibbs score, written independently of the package."""
    ref, mu, pts = (np.asarray(a, np.float64) for a in (ref, mu, pts))
    iv = np.asarray(inv_var, np.float64)
    d = pts[None, :, :] - ref[:, None, :]
    if kind == "se2":
        c, s = np.cos(ref[:, None, 2]), np.sin(ref[:, None, 2])
        th = np.mod(d[..., 2] + np.pi, 2 * np.pi) - np.pi
        d = np.stack([c * d[..., 0] + s * d[..., 1],
                      c * d[..., 1] - s * d[..., 0], th], axis=-1)
    return -0.5 * np.sum((d - mu[:, None, :]) ** 2 * iv, axis=-1)


def phase_scoring(card):
    """Scoring path vs the vmapped reference (f32, on the card) and vs an f64
    NumPy reference. Tolerance: 1e-5 of the largest |logw| against both, two
    orders of magnitude above f32 rounding of the rotated coordinates and two
    below what a TF32 product would leave."""
    import jax
    import jax.numpy as jnp

    from rome_tpu.manifolds.base import SE2, TranslationGroup
    from rome_tpu.ops.pairwise import pairwise_logw

    rng = np.random.default_rng(3)
    for kind, man in (("se2", SE2()), ("point2", TranslationGroup(2))):
        for n in (100, 4096):
            pdim = man.point_dim
            ref = rng.normal(0, 3, (n, pdim))
            pts = rng.normal(0, 3, (n, pdim))
            if kind == "se2":
                ref[:, 2] = rng.uniform(-np.pi, np.pi, n)
                pts[:, 2] = rng.uniform(-np.pi, np.pi, n)
            mu = rng.normal(0, 0.5, (n, man.dof))
            iv = 1.0 / rng.uniform(0.1, 1.0, man.dof)
            args = [jnp.asarray(a, jnp.float32) for a in (ref, mu, pts, iv)]

            @jax.jit
            def vmapped(ref, mu, pts, iv, man=man):
                def coords_for(r):
                    return man.local(jnp.broadcast_to(r, pts.shape), pts)

                C = jax.vmap(coords_for)(ref)
                return -0.5 * jnp.sum((C - mu[:, None, :]) ** 2 * iv, axis=-1)

            got = np.asarray(
                jax.jit(pairwise_logw, static_argnums=0)(man, *args)
            )
            want32 = np.asarray(vmapped(*args))
            want64 = _score_f64(kind, *(np.asarray(a) for a in args))
            scale = float(np.abs(want64).max())
            e32 = float(np.abs(got - want32).max()) / scale
            e64 = float(np.abs(got - want64).max()) / scale
            print(
                f"scoring {kind} N=Nj={n} f32 on {card}: rel err vs vmapped "
                f"{e32:.3g}, vs f64 NumPy {e64:.3g} (tol 1e-5 of max |logw|)",
                flush=True,
            )
            check(got.shape == (n, n) and np.isfinite(got).all(),
                  f"scoring {kind} {n}: finite ({n}, {n})")
            check(e32 <= 1e-5, f"scoring {kind} {n} vs vmapped")
            check(e64 <= 1e-5, f"scoring {kind} {n} vs f64")


def _cost_rel(a, b):
    """|a - b| relative to max(|b|, 1): the LM loop's own ftol scale guard,
    since a zero-residual fixture's optimum cost is ~0."""
    return abs(a - b) / max(abs(b), 1.0)


def _positions(fg):
    labels = sorted(fg.ls(r"^x\d+$"), key=lambda lbl: int(lbl[1:]))
    return np.array([fg.get_coords(lbl, "parametric")[:2] for lbl in labels])


def phase_four_cards(devs, card):
    """Distributed solves over four cards vs the same solve on one card:
    final cost within 1e-6 relative (``_cost_rel``), aligned ATE between the
    two solutions within the dataset's gate. The four-card runs go first, so
    each card's peak memory shows its own shard."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import __graft_entry__ as ge
    import bench
    from rome_tpu import solve_graph_parametric
    from rome_tpu.parallel.distributed import solve_graph_distributed
    from rome_tpu.parallel.varpart import make_varpart_solver

    # factor-sharded path over all four cards, reached the way users reach it
    fg4 = bench._build_graph(bench.CITYGRID)
    fg4.params.multiproc = True
    t0 = time.perf_counter()
    res4 = solve_graph_parametric(fg4, init=False)
    dt4 = time.perf_counter() - t0

    # owner-computes variable partition over four cards, then one
    ga = ge._build_chain_fixture(4096, "local", dtype=jnp.float64)
    vp = {}
    for tag, n in (("four", 4), ("one", 1)):
        solve, _plan = make_varpart_solver(
            ga, Mesh(np.array(devs[:n]), ("v",)), axis="v", max_iters=60
        )
        solve(ga.values0, lam0=1e-4)  # compile
        t0 = time.perf_counter()
        vals, st = solve(ga.values0, lam0=1e-4)
        jax.block_until_ready(vals)
        vp[tag] = (vals, st, time.perf_counter() - t0)
        if tag == "four":
            for d in devs[:4]:
                stats = d.memory_stats() or {}  # None on the CPU backend
                print(f"  {d}: peak_bytes_in_use "
                      f"{stats.get('peak_bytes_in_use')}", flush=True)

    fg1 = bench._build_graph(bench.CITYGRID)
    t0 = time.perf_counter()
    res1 = solve_graph_distributed(
        fg1, mesh=Mesh(np.array(devs[:1]), ("f",)), chordal_init=True
    )
    dt1 = time.perf_counter() - t0
    st4, st1 = res4["stats"], res1["stats"]
    rel = _cost_rel(st4["final_cost"], st1["final_cost"])
    ate = bench._aligned_ate(_positions(fg4), _positions(fg1))
    ate_gt, _raw = bench._ate_rmse(fg4, CITYGRID_GT)
    ref_cost = float(np.load(CITYGRID_GT)["final_cost"])
    print(
        f"multiproc citygrid-10k over mesh {res4['mesh']}: {st4} in {dt4} s; "
        f"one card: {st1} in {dt1} s; cost rel diff {rel!r}; aligned ATE "
        f"between them {ate} m; vs the f64 optimum: cost "
        f"{st4['final_cost'] / ref_cost - 1:+.3e} relative, aligned ATE "
        f"{ate_gt} m (on {card})",
        flush=True,
    )
    check(rel <= 1e-6, f"factor-sharded cost within 1e-6 of one card ({rel!r})")
    check(ate <= CITYGRID_ATE_GATE_M,
          f"factor-sharded aligned ATE vs one card {ate} <= {CITYGRID_ATE_GATE_M} m")

    (v4, s4, t4), (v1, s1, t1) = vp["four"], vp["one"]
    rel = _cost_rel(s4["final_cost"], s1["final_cost"])
    ate = bench._aligned_ate(np.asarray(v4["Pose2"])[:, :2],
                             np.asarray(v1["Pose2"])[:, :2])
    print(
        f"varpart chain-4096: four cards {s4['iterations']} it cost "
        f"{s4['final_cost']!r} in {t4} s; one card {s1['iterations']} it cost "
        f"{s1['final_cost']!r} in {t1} s; cost rel diff {rel!r}; aligned ATE "
        f"between them {ate} m (on {card})",
        flush=True,
    )
    check(s4["converged"] and s1["converged"], "varpart converged on 4 and 1 cards")
    check(rel <= 1e-6, f"varpart cost within 1e-6 of one card ({rel!r})")
    check(ate <= CHAIN_ATE_GATE_M,
          f"varpart aligned ATE vs one card {ate} <= {CHAIN_ATE_GATE_M} m")


def main(argv):
    four = "--four-cards" in argv
    devs = require_gpu(4 if four else 1)
    import jax

    sys.path.insert(0, ROOT)
    from rome_tpu.utils.compile_cache import enable

    enable()
    jax.config.update("jax_enable_x64", True)
    card = gpu_name_and_power_limit()
    print(f"jax {jax.__version__}, {len(devs)} x {devs[0].device_kind}", flush=True)
    t0 = time.perf_counter()
    if four:
        phase_four_cards(devs, card)
    else:
        phase_parametric(card)
        phase_covariance(card)
        phase_multimodal(card)
        phase_scoring(card)
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
