"""Multimodal (nonparametric) engine perf bench — accuracy-gated.

Applies the parametric bench's discipline to the nonparametric path: every
PUBLISHED row carries an acceptance check and every check counts in
all_gates_pass (no exclusions). Mirrors BASELINE.md's
multimodal measurement list (testMultimodalRangeBearing.jl:53-135 multihypo
config, testPose3Pose3NH.jl:118 nullhypo config, the beehive grow-and-solve
workload testBeehiveGrow.jl:18-28).

Rows:
- hexagonal_7pose: compiled batched engine vs the per-factor loop engine,
  gated on the mean symmetric KL between the two engines' posteriors.
- honeycomb_grow_default: the DEFAULT engine (graphinit + sequential GS
  passes + Jacobi sweeps) on the reference's actual beehive workload —
  grow 7->14->21 poses re-solving each step — gated at the reference's own
  landmark accuracy contract (testBeehiveGrow.jl:44-46, atol 4-6 m).
- beehive_100pose: point-seeded production configuration at 100-pose
  scale, tight 0.5 m gate vs the parametric optimum.
- bayes_tree_grow: solve_tree with clique recycling across growths.
- multihypo_range_bearing / pose3_nullhypo: approx_conv on the BASELINE
  multihypothesis configs, gated on posterior mode masses.

Usage: python tools/bench_multimodal.py [out.json] [cpu|device]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _hex():
    from rome_tpu.canonical.generators import generate_graph_hexagonal

    return generate_graph_hexagonal(N=100)


def _beehive():
    from rome_tpu.canonical.patterns import generate_graph_beehive

    return generate_graph_beehive(pose_count_target=100, graphinit=False)


def _solve(fg, engine, init=True):
    from rome_tpu.solvers.multimodal import solve_graph_nonparametric

    t0 = time.time()
    solve_graph_nonparametric(fg, sweeps=3, N=100, engine=engine, init=init)
    return time.time() - t0


def _beliefs_of(fg, labels, key="default"):
    return {l: np.asarray(fg.variables[l].beliefs[key]) for l in labels}


def _mean_sym_kl(fg_a, fg_b, labels):
    from rome_tpu.manifolds.base import SE2_
    from rome_tpu.solvers.multimodal.metrics import symmetric_kl_knn

    import jax.numpy as jnp

    vals = []
    for l in labels:
        P = jnp.asarray(fg_a.variables[l].beliefs["default"])
        Q = jnp.asarray(fg_b.variables[l].beliefs["default"])
        vals.append(float(symmetric_kl_knn(SE2_, P, Q)))
    return float(np.mean(vals))


def bench_hexagonal():
    fg_b = _hex()
    t_first = _solve(fg_b, "batched")
    fg_b = _hex()
    t0 = time.time()
    _solve(fg_b, "batched")
    t_steady = time.time() - t0
    fg_l = _hex()
    t_loop = _solve(fg_l, "loop")
    labels = [l for l in fg_b.ls(r"^x\d+$")]
    kl = _mean_sym_kl(fg_b, fg_l, labels)
    n = len(labels)
    return dict(
        batched_first_s=round(t_first, 2),
        batched_steady_s=round(t_steady, 2),
        loop_engine_s=round(t_loop, 2),
        speedup_steady_vs_loop=round(t_loop / max(t_steady, 1e-9), 1),
        poses_per_sec=round(n / max(t_steady, 1e-9), 2),
        mean_sym_kl_vs_loop=round(kl, 3),
        accuracy_ok=bool(kl < 1.0),
    )


def bench_beehive():
    from rome_tpu import solve_graph_parametric

    # parametric optimum as the accuracy anchor (beehive posteriors are
    # unimodal; belief means must sit on the parametric solution)
    fg_p = _beehive()
    fg_p.init_all()
    solve_graph_parametric(fg_p, init=False)
    truth = {
        l: fg_p.get_coords(l, "parametric") for l in fg_p.ls(r"^x\d+$")
    }

    rows = {}
    for tag, init in (("points_init", "points"),):
        fg = _beehive()
        t_first = _solve(fg, "batched", init=init)
        fg = _beehive()
        t0 = time.time()
        _solve(fg, "batched", init=init)
        t_steady = time.time() - t0
        errs = []
        for l in fg.ls(r"^x\d+$"):
            bel = np.asarray(fg.variables[l].beliefs["default"])
            errs.append(
                np.linalg.norm(np.mean(bel[:, :2], axis=0) - truth[l][:2])
            )
        err = float(np.mean(errs))
        n = len(errs)
        rows[tag] = dict(
            batched_first_s=round(t_first, 2),
            batched_steady_s=round(t_steady, 2),
            poses_per_sec=round(n / max(t_steady, 1e-9), 2),
            mean_pos_err_vs_parametric_m=round(err, 4),
            accuracy_ok=bool(err < 0.5),
        )
    rows["note"] = (
        "single-shot 100-pose from cold default init is NOT a reference "
        "workload (testBeehiveGrow.jl never solves past 21 poses cold and "
        "grows incrementally) — the default engine's contract row is "
        "honeycomb_grow_default below; points_init is the production "
        "configuration the incremental frontend uses"
    )
    return rows


def _grow_truth(fg):
    """Parametric optimum of the CURRENT graph as accuracy anchor."""
    import copy

    from rome_tpu import solve_graph_parametric

    fgp = copy.deepcopy(fg)
    fgp.init_all()
    solve_graph_parametric(fgp, init=False)
    return fgp


def bench_honeycomb_grow():
    """The reference's actual default-engine beehive workload
    (testBeehiveGrow.jl:18-28): grow the honeycomb 7 -> 14 -> 21 poses,
    re-solving with the DEFAULT engine (graphinit + sequential GS passes +
    Jacobi sweeps) after each growth. Gate: landmark position error vs the
    parametric optimum within the reference's own atol band
    (testBeehiveGrow.jl:44-46 uses atol 4-6 m and skips the pose check;
    we gate landmarks at 4 m AND poses at 4 m)."""
    from rome_tpu.canonical.patterns import generate_graph_honeycomb

    fg = None
    t_solves = []
    for target in (7, 14, 21):
        fg = generate_graph_honeycomb(
            pose_count_target=target, fg=fg, graphinit=True
        )
        t0 = time.time()
        _solve(fg, "batched", init=True)
        t_solves.append(round(time.time() - t0, 2))

    fgp = _grow_truth(fg)
    errs_l, errs_x = [], []
    for pat, acc in ((r"^l\d+$", errs_l), (r"^x\d+$", errs_x)):
        for l in fg.ls(pat):
            bel = fg.variables[l].beliefs.get("default")
            if bel is None:
                continue
            t = fgp.get_coords(l, "parametric")
            acc.append(
                float(np.linalg.norm(np.asarray(bel)[:, :2].mean(0) - t[:2]))
            )
    lmean, lmax = float(np.mean(errs_l)), float(np.max(errs_l))
    xmean, xmax = float(np.mean(errs_x)), float(np.max(errs_x))
    return dict(
        workload="honeycomb grow 7->14->21, default engine each step",
        solve_s=t_solves,
        landmark_err_m=dict(mean=round(lmean, 3), max=round(lmax, 3),
                            n=len(errs_l)),
        pose_err_m=dict(mean=round(xmean, 3), max=round(xmax, 3),
                        n=len(errs_x)),
        reference_gate="testBeehiveGrow.jl:44-46 landmark atol 4-6 m",
        accuracy_ok=bool(lmean < 4.0 and xmean < 4.0),
    )


def bench_tree_grow():
    """Bayes-tree engine on the same growing workload:
    solve_tree with clique recycling across growths — the reference's
    incremental nonparametric story (solveTree!(fg, tree))."""
    from rome_tpu.canonical.patterns import generate_graph_honeycomb
    from rome_tpu.solvers.multimodal.tree import (
        calc_cliques_recycled, solve_tree,
    )

    fg = None
    tree = None
    rows = []
    for target in (7, 14):
        fg = generate_graph_honeycomb(
            pose_count_target=target, fg=fg, graphinit=True
        )
        t0 = time.time()
        tree = solve_tree(fg, old_tree=tree, N=100)
        n_c, n_r = calc_cliques_recycled(tree)
        rows.append(dict(
            poses=target, solve_s=round(time.time() - t0, 2),
            cliques=n_c, recycled=n_r,
        ))

    fgp = _grow_truth(fg)
    errs = []
    for l in fg.ls(r"^l\d+$"):
        bel = fg.variables[l].beliefs.get("default")
        if bel is None:
            continue
        t = fgp.get_coords(l, "parametric")
        errs.append(
            float(np.linalg.norm(np.asarray(bel)[:, :2].mean(0) - t[:2]))
        )
    mean_err = float(np.mean(errs)) if errs else float("nan")
    return dict(
        workload="honeycomb grow 7->14, solve_tree with recycling",
        steps=rows,
        recycled_at_regrow=rows[-1]["recycled"],
        landmark_err_mean_m=round(mean_err, 3),
        accuracy_ok=bool(mean_err < 4.0),
    )


def bench_multihypo():
    """testMultimodalRangeBearing.jl:53-135 timing + mode-mass gate."""
    import jax
    import jax.numpy as jnp

    from rome_tpu import (
        FactorGraph, MvNormal, Normal, Point2, Pose2,
        Pose2Point2BearingRange, PriorPoint2, PriorPose2,
    )
    from rome_tpu.solvers.multimodal import approx_conv, init_all_beliefs

    def build():
        fg = FactorGraph()
        fg.params.graphinit = False
        fg.add_variable("x0", Pose2)
        fg.add_factor(
            ["x0"], PriorPose2(MvNormal([0, 0, 0], [4.0, 4.0, 4.0])),
            graphinit=True,
        )
        fg.add_variable("l1", Point2)
        fg.add_variable("l2", Point2)
        fg.add_factor(["l1"], PriorPoint2(MvNormal([20.0, 5.0], [0.01, 0.01])))
        fg.add_factor(["l2"], PriorPoint2(MvNormal([20.0, -5.0], [0.01, 0.01])))
        f = fg.add_factor(
            ["x0", "l1", "l2"],
            Pose2Point2BearingRange(Normal(0.0, 0.01), Normal(20.0, 0.05)),
            multihypo=[1.0, 0.5, 0.5],
        )
        return fg, f

    fg, f = build()
    init_all_beliefs(fg, N=400)
    t0 = time.time()
    pts = np.asarray(approx_conv(fg, f.label, "x0", N=400))
    t_first = time.time() - t0
    t0 = time.time()
    pts = np.asarray(
        approx_conv(fg, f.label, "x0", N=400, key=jax.random.PRNGKey(3))
    )
    t_steady = time.time() - t0
    r1 = np.abs(np.linalg.norm(pts[:, :2] - np.array([20.0, 5.0]), axis=1) - 20.0)
    r2 = np.abs(np.linalg.norm(pts[:, :2] - np.array([20.0, -5.0]), axis=1) - 20.0)
    m1 = float(np.mean((r1 < 1.0) & (r2 >= 1.0)))
    m2 = float(np.mean((r2 < 1.0) & (r1 >= 1.0)))
    balanced = m1 > 0.15 and m2 > 0.15 and 0.25 < m1 / (m1 + m2 + 1e-12) < 0.75
    return dict(
        config="MultimodalRangeBearing multihypo=[1,.5,.5], N=400",
        first_s=round(t_first, 3),
        steady_s=round(t_steady, 3),
        mode_mass=[round(m1, 3), round(m2, 3)],
        accuracy_ok=bool(balanced),
    )


def bench_nullhypo():
    """testPose3Pose3NH.jl:118 timing + null-mass gate."""
    import jax
    import jax.numpy as jnp

    from rome_tpu import FactorGraph, MvNormal, Pose3, Pose3Pose3, PriorPose3
    from rome_tpu.solvers.multimodal import approx_conv, init_all_beliefs

    fg = FactorGraph()
    fg.add_variable("x0", Pose3)
    fg.add_factor(["x0"], PriorPose3(MvNormal(np.zeros(6), np.full(6, 1e-4))))
    fg.add_variable("x1", Pose3)
    z = np.array([10.0, 0, 0, 0, 0, 0])
    f = fg.add_factor(
        ["x0", "x1"], Pose3Pose3(MvNormal(z, np.full(6, 1e-3))),
        nullhypo=0.5, graphinit=False,
    )
    rng = np.random.default_rng(5)
    wide = np.concatenate(
        [rng.normal(0, 8.0, size=(400, 3)), np.tile([1.0, 0, 0, 0], (400, 1))],
        axis=1,
    )
    import jax.numpy as jnp

    fg.variables["x1"].beliefs["default"] = jnp.asarray(wide)
    fg.variables["x1"].initialized["default"] = True
    init_all_beliefs(fg, N=400)
    t0 = time.time()
    pts = np.asarray(approx_conv(fg, f.label, "x1", N=400))
    t_first = time.time() - t0
    t0 = time.time()
    pts = np.asarray(
        approx_conv(fg, f.label, "x1", N=400, key=jax.random.PRNGKey(4))
    )
    t_steady = time.time() - t0
    at_meas = float(
        np.mean(np.linalg.norm(pts[:, :3] - np.array([10.0, 0, 0]), axis=1) < 1.0)
    )
    far = float(
        np.mean(np.linalg.norm(pts[:, :3] - np.array([10.0, 0, 0]), axis=1) > 3.0)
    )
    return dict(
        config="Pose3Pose3 nullhypo=0.5, N=400",
        first_s=round(t_first, 3),
        steady_s=round(t_steady, 3),
        mass_at_measurement=round(at_meas, 3),
        mass_spread=round(far, 3),
        accuracy_ok=bool(0.25 < at_meas < 0.75 and far > 0.15),
    )


def main(out="results/MULTIMODAL.json", platform="cpu"):
    import jax

    if platform == "cpu":
        jax.config.update("jax_platforms", "cpu")

    rows = {}
    rows["hexagonal_7pose"] = bench_hexagonal()
    print(json.dumps(rows["hexagonal_7pose"]), flush=True)
    rows["honeycomb_grow_default"] = bench_honeycomb_grow()
    print(json.dumps(rows["honeycomb_grow_default"]), flush=True)
    rows["beehive_100pose"] = bench_beehive()
    print(json.dumps(rows["beehive_100pose"]), flush=True)
    rows["bayes_tree_grow"] = bench_tree_grow()
    print(json.dumps(rows["bayes_tree_grow"]), flush=True)
    rows["multihypo_range_bearing"] = bench_multihypo()
    print(json.dumps(rows["multihypo_range_bearing"]), flush=True)
    rows["pose3_nullhypo"] = bench_nullhypo()
    print(json.dumps(rows["pose3_nullhypo"]), flush=True)

    # every published row gates; no exclusions
    gates = {
        k: v["accuracy_ok"] if "accuracy_ok" in v
        else v["points_init"]["accuracy_ok"]
        for k, v in rows.items()
    }
    doc = dict(
        device=str(jax.devices()[0]),
        N=100,
        sweeps=3,
        rows=rows,
        gates=gates,
        all_gates_pass=bool(all(gates.values())),
    )
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), out)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1)
    print(json.dumps(doc), flush=True)


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else "results/MULTIMODAL.json"
    platform = sys.argv[2] if len(sys.argv) > 2 else "cpu"
    main(out, platform)
