"""Kernel bench: Pose2Pose2 linearization, factor evals/s on one GPU.

Measures the pure batched linearization kernel — whitened residual + all
slot Jacobians for synthetic Pose2Pose2 batches (the M3500 hot kernel) at
sizes 1e4..1e6, for the closed-form fused kernel the production path uses
and for the generic jacfwd form the long tail of factor types takes.

The kernel is iterated K times INSIDE one jitted ``lax.scan`` with a data
dependency between iterations (the output feeds a tiny perturbation of the
next input, defeating CSE/DCE), so the timed region holds one dispatch.
Reports evals/s and the share of the card's HBM roofline: the kernel is
memory-bound (~156 B and ~150-525 flops per factor).

Usage: python tools/bench_kernels.py [--json out.json]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# per-factor analytic cost of Pose2Pose2 linearization
FLOPS_GENERIC = 525        # SE2 compose+log+whiten (~75) x 7 jacfwd tangents
FLOPS_FUSED = 150          # closed-form: ~8 transcendentals + whitening macs
BYTES_PER_EVAL = 156       # 2 poses + z + sqrt_info read, r0 + 2 J written

# Published peaks by jax device_kind (NVIDIA H100 SXM data sheet: 3.35 TB/s
# HBM3, 67 TFLOP/s f32 outside the tensor cores, at the 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(hbm_bytes_per_s=3.35e12, f32_flops=67e12),
}


def peaks_for(device):
    try:
        return PEAKS[device.device_kind]
    except KeyError:
        raise SystemExit(
            f"bench_kernels: no published peaks for device_kind "
            f"{device.device_kind!r}; add it to PEAKS"
        ) from None


def _make_batch(n: int, seed: int = 0):
    import jax.numpy as jnp

    from rome_tpu.factors.pose2 import POSE2POSE2
    from rome_tpu.graph.lower import FactorBatch

    rng = np.random.default_rng(seed)
    z = rng.normal([1.0, 0.0, 0.1], 0.05, size=(n, 3))
    sqrt_info = np.broadcast_to(np.eye(3) * 10.0, (n, 3, 3))
    vslots = np.stack(
        [np.arange(n, dtype=np.int32), (np.arange(n, dtype=np.int32) + 1)], axis=1
    )
    return FactorBatch(
        ftype=POSE2POSE2,
        n=n,
        vtypes=("Pose2", "Pose2"),
        vslots=jnp.asarray(vslots),
        params={"z": jnp.asarray(z, jnp.float32),
                "sqrt_info": jnp.asarray(sqrt_info, jnp.float32)},
        weight=jnp.ones(n, jnp.float32),
    )


def main(out_json=None):
    import jax
    import jax.numpy as jnp
    from jax import lax

    from rome_tpu.graph.lower import GraphArrays
    from rome_tpu.manifolds.base import SE2_
    from rome_tpu.solvers.linearize import batch_linearize

    dev = jax.devices()[0]
    peaks = peaks_for(dev)
    all_rows = {}
    for variant, fused, flops in (
        ("fused_analytic", True, FLOPS_FUSED),
        ("generic_jacfwd", False, FLOPS_GENERIC),
    ):
        rows = []
        for n, K in ((10_000, 400), (100_000, 100), (1_000_000, 20)):
            batch = _make_batch(n)
            rng = np.random.default_rng(1)
            values = {
                "Pose2": jnp.asarray(
                    rng.normal(0, 1.0, size=(n + 1, 3)), jnp.float32
                )
            }
            ga = GraphArrays(
                type_names=["Pose2"],
                manifolds={"Pose2": SE2_},
                counts={"Pose2": n + 1},
                values0=values,
                free={"Pose2": jnp.ones(n + 1, jnp.float32)},
                batches=[batch],
                var_labels={"Pose2": [f"x{i}" for i in range(n + 1)]},
            )

            def body(vals, _, ga=ga, batch=batch, fused=fused):
                r0, Js = batch_linearize(ga, batch, vals, fused=fused)
                # loop-carried dependency: a scalar distilled from this
                # iteration's outputs perturbs the next input, so XLA cannot
                # hoist or dedupe the kernel across scan steps
                upd = 1e-30 * (jnp.sum(r0) + sum(jnp.sum(J) for J in Js))
                return {"Pose2": vals["Pose2"] + upd}, ()

            f = jax.jit(
                lambda v, body=body, K=K: jnp.sum(
                    lax.scan(body, v, None, length=K)[0]["Pose2"]
                )
            )
            jax.block_until_ready(f(values))  # compile + warm
            t_best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                jax.block_until_ready(f(values))
                t_best = min(t_best, (time.perf_counter() - t0) / K)
            evals_s = n / t_best
            roofline_evals_s = peaks["hbm_bytes_per_s"] / BYTES_PER_EVAL
            rows.append(
                dict(
                    n=n,
                    us=t_best * 1e6,
                    evals_per_sec=evals_s,
                    gflops_est=evals_s * flops / 1e9,
                    pct_of_hbm_roofline=100.0 * evals_s / roofline_evals_s,
                )
            )
            print(variant, rows[-1], flush=True)
        all_rows[variant] = rows
    doc = dict(
        kernel="Pose2Pose2 linearize (residual + 2 Jacobians)",
        device=dict(platform=dev.platform, kind=dev.device_kind,
                    count=len(jax.devices())),
        methodology="K-deep on-device lax.scan with loop-carried dependency; one dispatch in the timed region",
        roofline=dict(
            bytes_per_eval=BYTES_PER_EVAL,
            flops_per_eval=FLOPS_FUSED,
            peaks=peaks,
            ceiling_evals_per_sec=peaks["hbm_bytes_per_s"] / BYTES_PER_EVAL,
        ),
        rows=all_rows["fused_analytic"],
        variants=all_rows,
    )
    if out_json:
        with open(out_json, "w") as fh:
            json.dump(doc, fh, indent=1)
    print(json.dumps(doc))
    return doc


if __name__ == "__main__":
    out = sys.argv[sys.argv.index("--json") + 1] if "--json" in sys.argv else None
    main(out)
