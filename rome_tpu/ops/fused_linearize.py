"""Hand-derived fused linearization kernels for the hot factor types.

The generic path (solvers/linearize.batch_linearize) computes residual +
Jacobians via vmapped ``jacfwd`` — fully general, but forward-mode evaluates
the residual once per tangent direction (7 evaluations for Pose2Pose2).
These kernels compute the SAME whitened residual/Jacobians in closed form
over (n,) coordinate planes: ~30 elementwise ops total, which XLA fuses.

Derivation (Pose2Pose2, hybrid SE(2) tangent — matches Pose2D.jl:48-67 and
manifolds.base.SE2 exactly):
  qhat = p ∘ exp(z);  r_raw = log(q'⁻¹ ∘ qhat) with q' = q ∘ exp(dq),
  p' = p ∘ exp(dp). At dp = dq = 0, writing θ1 = pθ - qθ, R = R(θ1):
    r_t = R(-qθ)(tp + R(pθ) z_t - tq),  r_θ = wrap(pθ + zθ - qθ)
    ∂r_t/∂dp_t = R(θ1)          ∂r_t/∂dpθ = R(θ1) J z_t
    ∂r_t/∂dq_t = -I             ∂r_t/∂dqθ = -J r_t
    ∂r_θ/∂dpθ = 1               ∂r_θ/∂dqθ = -1       (J = R(π/2))
Whitening multiplies rows by params["sqrt_info"]; weights multiply through.
"""

from __future__ import annotations

import jax.numpy as jnp

from rome_tpu.utils.math import sym_rem


def pose2pose2_linearize(params, p, q):
    """Whitened (r0, (J1, J2)) for a Pose2Pose2 batch.

    p, q: (n, 3) poses (x, y, theta); params["z"]: (n, 3);
    params["sqrt_info"]: (n, 3, 3). Caller applies the weight mask.
    """
    z = params["z"]
    S = params["sqrt_info"]
    px, py, pt = p[:, 0], p[:, 1], p[:, 2]
    qx, qy, qt = q[:, 0], q[:, 1], q[:, 2]
    zx, zy, zt = z[:, 0], z[:, 1], z[:, 2]

    cp, sp = jnp.cos(pt), jnp.sin(pt)
    cq, sq = jnp.cos(qt), jnp.sin(qt)
    # theta1 = pt - qt via angle-sum identities (one less transcendental
    # pair than cos(pt-qt) would need after the cp/sp/cq/sq are in hand)
    c1 = cp * cq + sp * sq
    s1 = sp * cq - cp * sq

    # qhat translation minus q translation, then rotate by R(-qt)
    dx = px + cp * zx - sp * zy - qx
    dy = py + sp * zx + cp * zy - qy
    r0x = cq * dx + sq * dy
    r0y = -sq * dx + cq * dy
    r0t = sym_rem(pt + zt - qt)

    # J1 columns: [R(θ1) | R(θ1) J z_t], J z_t = (-zy, zx)
    a = -c1 * zy - s1 * zx
    b = -s1 * zy + c1 * zx
    one = jnp.ones_like(c1)
    zero = jnp.zeros_like(c1)
    J1 = jnp.stack(
        [
            jnp.stack([c1, -s1, a], axis=-1),
            jnp.stack([s1, c1, b], axis=-1),
            jnp.stack([zero, zero, one], axis=-1),
        ],
        axis=-2,
    )  # (n, 3, 3)
    # J2: [-I | -J r_t]; -J r = (r_y, -r_x)
    J2 = jnp.stack(
        [
            jnp.stack([-one, zero, r0y], axis=-1),
            jnp.stack([zero, -one, -r0x], axis=-1),
            jnp.stack([zero, zero, -one], axis=-1),
        ],
        axis=-2,
    )
    r0 = jnp.stack([r0x, r0y, r0t], axis=-1)
    # whiten
    r0 = jnp.einsum("nij,nj->ni", S, r0)
    J1 = S @ J1
    J2 = S @ J2
    return r0, (J1, J2)


# factor-type name -> kernel(params, *points) -> (r0, Js)
FUSED_LINEARIZE = {
    "Pose2Pose2": pose2pose2_linearize,
    "MutablePose2Pose2Gaussian": pose2pose2_linearize,
}
