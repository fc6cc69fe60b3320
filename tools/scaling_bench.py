"""Varpart strong-scaling sweep over problem SIZE with a per-phase
decomposition.

On this host the 8 "devices" are virtual CPU devices sharing
``os.cpu_count()`` physical cores, so raw wall-clock cannot beat the
core count. Two efficiency columns are reported:

- efficiency_raw       = T1 / (N * TN)            (its ceiling on c cores
  is c/N)
- efficiency_core_norm = T1 / (min(N, c) * TN)    (ideal = 1.0: the
  partition is free and the virtual mesh saturates the physical cores)

The claim to check is that efficiency IMPROVES with problem size (the
separator/replicated-solve overhead amortizes), plus the per-phase table
(linearize+cost / Schur local elimination / fused psum / replicated
separator solve) that says what to fix next.

Usage: python tools/scaling_bench.py [out.json]
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _wall(fn, *a, reps=3):
    fn(*a)
    best = float("inf")
    for _ in range(reps):
        t0 = time.time()
        fn(*a)
        best = min(best, time.time() - t0)
    return best


def main(out="results/SCALING.json"):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp  # noqa: F401
    from jax.sharding import Mesh

    import __graft_entry__ as ge
    from rome_tpu.parallel.varpart import make_varpart_solver

    ncores = os.cpu_count() or 1
    # sizes bounded by the 1-device reference: varpart at 1 device makes
    # the WHOLE graph a single dense interior (O((3n)^3) per iteration),
    # so the strong-scaling reference is only computable up to ~4k poses
    # on this host. The trend across sizes is the claim. Two closure
    # regimes: "random" long-range links (worst case for any partition —
    # separator grows ~linearly with n) and "local" corridor-SLAM links
    # (the realistic regime — separator constant in n).
    sizes = [1024, 2048, 4096]
    ndevs = [1, 8]
    rows = []
    phase_rows = []
    for closures, n_poses in [
        (c, n) for c in ("local", "random") for n in sizes
    ]:
        ga = ge._build_chain_fixture(n_poses, closures=closures)
        walls = {}
        for nd in ndevs:
            mesh = Mesh(np.array(jax.devices()[:nd]).reshape(nd), ("v",))
            solve, plan = make_varpart_solver(ga, mesh, max_iters=60)
            solve(ga.values0, lam0=1e-4)  # compile
            best = float("inf")
            st = None
            for _ in range(3):
                t0 = time.time()
                _v, st = solve(ga.values0, lam0=1e-4)
                best = min(best, time.time() - t0)
            walls[nd] = (best, st)
            print(
                f"[{closures}] poses {n_poses} ndev {nd}: wall {best:.3f} s "
                f"iters {st['iterations']} reason {st['reason']}",
                flush=True,
            )
            if nd == max(ndevs):
                # per-phase decomposition at the widest mesh
                t_lin = _wall(lambda: solve.probe("lin_cost"), reps=5)
                t_full = _wall(lambda: solve.probe("schur_full"), reps=5)
                t_nops = _wall(lambda: solve.probe("schur_nopsum"), reps=5)
                t_nosep = _wall(lambda: solve.probe("schur_nosep"), reps=5)
                pr = dict(
                    closures=closures,
                    n_poses=n_poses,
                    n_devices=nd,
                    lin_cost_ms=round(t_lin * 1e3, 2),
                    schur_full_ms=round(t_full * 1e3, 2),
                    schur_local_ms=round((t_nops - t_lin) * 1e3, 2),
                    fused_psum_ms=round((t_full - t_nops) * 1e3, 2),
                    separator_solve_ms=round((t_full - t_nosep) * 1e3, 2),
                    separator_dofs=st["comms"]["separator_dofs"],
                )
                phase_rows.append(pr)
                print("phases:", pr, flush=True)
        t1, st1 = walls[1]
        tN, stN = walls[max(ndevs)]
        N = max(ndevs)
        # PER-ITERATION efficiency: the 1-device and 8-device topologies
        # follow different LM trajectories (no separators vs f32 Schur
        # rounding), so whole-solve walls compare different iteration
        # counts; per-iteration wall compares identical work units
        p1 = t1 / max(1, st1["iterations"])
        pN = tN / max(1, stN["iterations"])
        rows.append(
            dict(
                closures=closures,
                n_poses=n_poses,
                t1_s=round(t1, 3),
                t8_s=round(tN, 3),
                iters_1=st1["iterations"],
                iters_8=stN["iterations"],
                per_iter_1_s=round(p1, 4),
                per_iter_8_s=round(pN, 4),
                efficiency_raw=round(p1 / (pN * N), 3),
                efficiency_core_norm=round(p1 / (pN * min(N, ncores)), 3),
            )
        )
        print("row:", rows[-1], flush=True)

    doc = dict(
        workload="chain+loops fixture, varpart owner-computes fused LM",
        physical_cores=ncores,
        virtual_devices=max(ndevs),
        note=(
            "virtual CPU mesh: 8 devices share "
            f"{ncores} physical cores, so efficiency_raw is capped at "
            f"{ncores}/8 by the hardware; efficiency_core_norm=1.0 means "
            "the partition adds zero overhead beyond core saturation. The "
            "claim demonstrated is efficiency RISING with problem size as "
            "the separator overhead amortizes (BASELINE >=75%-at-2-hosts "
            "maps to efficiency_core_norm on real multi-host meshes where "
            "each process owns its silicon — tools/multiproc_solve.py runs "
            "the real 2-process case)."
        ),
        rows=rows,
        phase_decomposition=phase_rows,
    )
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), out)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1)
    print("wrote", out, flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "results/SCALING.json")
