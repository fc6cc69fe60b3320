"""Scaling sweep: fused distributed LM solve at 1/2/4/8 devices.

Writes results/MULTICHIP.json rows {n_devices, wall_s, iters, converged,
final_cost, efficiency}. On the CI/virtual CPU mesh the devices share
physical cores, so 'efficiency' there measures collective/partition
overhead, not speedup — real scaling needs real GPUs (noted in the output).

Usage: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       python tools/multichip_bench.py [n_poses] [out.json]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(n_poses: int = 1024, out: str = "results/MULTICHIP.json", platform: str = "cpu"):
    import jax

    # must run before any device query
    if platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import __graft_entry__ as ge
    from rome_tpu.parallel.sharding import make_sharded_gn_step
    from rome_tpu.solvers.gauss_newton import ParametricSolver
    from rome_tpu.solvers.linearize import cost_at

    from rome_tpu.parallel.varpart import make_varpart_solver

    ga = ge._build_chain_fixture(n_poses)
    cost_start = float(cost_at(ga, ga.values0))
    ndev_avail = len(jax.devices())
    rows = []
    vp_rows = []
    for nd in [n for n in (1, 2, 4, 8) if n <= ndev_avail]:
        # --- varpart (owner-computes, direct Schur on separators) ---------
        mesh = Mesh(np.array(jax.devices()[:nd]).reshape(nd), ("v",))
        solve, plan = make_varpart_solver(ga, mesh, max_iters=60)
        solve(ga.values0, lam0=1e-4)  # compile
        t0 = time.time()
        _v, st = solve(ga.values0, lam0=1e-4)
        dt = time.time() - t0
        comms = st["comms"]
        vp_rows.append(
            dict(
                n_devices=nd,
                wall_s=round(dt, 4),
                iters=st["iterations"],
                reason=st["reason"],
                converged=st["converged"],
                final_cost=st["final_cost"],
                collectives_total=st["collectives"],
                # payload of one separator exchange + one Schur reduction
                bytes_per_exchange=comms["bytes_per_exchange"],
                schur_psum_bytes=4 * (
                    comms["separator_dofs"] ** 2
                    + 2 * comms["separator_dofs"] + 1
                ),
                payload_ratio_vs_replicated=comms["payload_ratio"],
            )
        )
        print("varpart", vp_rows[-1], flush=True)

        # --- factor-sharded replicated path (round-2 design) --------------
        mesh = Mesh(np.array(jax.devices()[:nd]).reshape(nd), ("f",))
        step, ga_p = make_sharded_gn_step(ga, mesh, pcg_iters=100)
        lam = jnp.asarray(1e-4, dtype=ga_p.dtype)
        step.solve(ga_p.values0, lam)  # compile
        t0 = time.time()
        values, it, code, fc = step.solve(ga_p.values0, lam)
        fc = float(fc)
        dt = time.time() - t0
        rows.append(
            dict(
                n_devices=nd,
                wall_s=round(dt, 4),
                iters=int(it),
                reason=ParametricSolver._REASONS.get(int(code), "?"),
                converged=int(code) in (1, 3, 4)
                or (int(code) == 5 and int(it) > 3),
                final_cost=fc,
                # replicated exchange: full variable tangent per psum
                bytes_per_exchange=int(
                    4 * sum(
                        ga.counts[t] * ga.manifolds[t].dof
                        for t in ga.type_names
                    )
                ),
            )
        )
        print("factor-sharded", rows[-1], flush=True)
    for rset in (rows, vp_rows):
        base = rset[0]["wall_s"]
        for r in rset:
            r["efficiency"] = round(base / (r["wall_s"] * r["n_devices"]), 3)
    doc = dict(
        workload=f"chain+loops {n_poses} poses",
        cost_start=cost_start,
        device=str(jax.devices()[0]),
        virtual_cpu_mesh=jax.devices()[0].platform == "cpu",
        note=(
            "virtual CPU devices share physical cores: efficiency measures "
            "partition/collective overhead only, not real scaling. "
            "varpart_rows = owner-computes partition with ONE fused Schur "
            "psum per LM iteration; factor_sharded_rows = round-2 "
            "replicated-variable design (superseded)."
        ),
        varpart_rows=vp_rows,
        factor_sharded_rows=rows,
        rows=rows,
    )
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as fh:
        json.dump(doc, fh, indent=1)
    print("wrote", out)


if __name__ == "__main__":
    main(
        int(sys.argv[1]) if len(sys.argv) > 1 else 1024,
        sys.argv[2] if len(sys.argv) > 2 else "results/MULTICHIP.json",
        sys.argv[3] if len(sys.argv) > 3 else "cpu",
    )
