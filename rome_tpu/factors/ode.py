"""ODE-defined relative factors (DERelative) — inertial kinematic dynamics.

Reference: /root/reference/ext/RoMEDiffEqExt.jl:13-39 (InertialDynamic builds
an IIF DERelative with forward+backward ODEProblems over linearly
interpolated gyro/accel signals) and ext/factors/InertialDynamic.jl:14-37
(imuKinematic!: Rdot = R*Omega, Vdot = R*A - g, Pdot = V).

Design: the ODE integrates as a fixed-step RK4 lax.scan inside the
residual kernel — static step count, signals linearly interpolated from
dense (N, 3) device arrays, differentiable end-to-end so the parametric
solver gets exact sensitivities through the flow.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from rome_tpu.distributions import Distribution, MvNormal
from rome_tpu.factors.base import Factor, FactorType, gaussian_params, register_factor_type
from rome_tpu.manifolds import quat as Q
from rome_tpu.variables import RotVelPos

_RVP_M = RotVelPos.manifold

GRAVITY = (0.0, 0.0, 9.81)


def imu_kinematic(state, omega, accel, g):
    """du/dt of the (q, v, p) state (imuKinematic!, InertialDynamic.jl:14-37):
    qdot = 0.5 q x (0, w); vdot = R(q) a - g; pdot = v."""
    q, v = state[..., :4], state[..., 4:7]
    zw = jnp.zeros_like(omega[..., :1])
    qdot = 0.5 * Q.qmul(q, jnp.concatenate([zw, omega], axis=-1))
    vdot = Q.qrotate(q, accel) - g
    pdot = v
    return jnp.concatenate([qdot, vdot, pdot], axis=-1)


def _interp_signal(sig, t0, dt, t):
    """Linear interpolation of a (N, 3) signal sampled at t0 + k*dt."""
    f = jnp.clip((t - t0) / dt, 0.0, sig.shape[0] - 1.001)
    k = jnp.floor(f).astype(jnp.int32)
    w = f - k
    return sig[k] * (1 - w) + sig[k + 1] * w


def _integrate_rvp(params, x0_rvp, direction=1.0):
    """RK4 flow of the IMU kinematics from a RotVelPos point over the factor's
    timespan. ``direction``=-1 runs the backward problem (DiffEq ext's
    bproblem)."""
    gyros = params["gyros"]
    accels = params["accels"]
    t0 = params["t0"]
    dt = params["dt_step"] * direction
    # N samples cover N intervals of dt (each IMU reading integrates one dt,
    # as in preintegrateIMU); interpolation clamps at the signal edges
    n = gyros.shape[0]
    g = params["gravity"]

    state0 = x0_rvp  # (q, v, p) flat = RotVelPos layout
    start = t0 if direction > 0 else t0 + params["dt_step"] * n

    def rhs(t, s):
        w = _interp_signal(gyros, t0, params["dt_step"], t)
        a = _interp_signal(accels, t0, params["dt_step"], t)
        return imu_kinematic(s, w, a, g)

    def step(carry, k):
        t, s = carry
        k1 = rhs(t, s)
        k2 = rhs(t + 0.5 * dt, s + 0.5 * dt * k1)
        k3 = rhs(t + 0.5 * dt, s + 0.5 * dt * k2)
        k4 = rhs(t + dt, s + dt * k3)
        s = s + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        s = jnp.concatenate([Q.qnormalize(s[..., :4]), s[..., 4:]], axis=-1)
        return (t + dt, s), None

    (_, sT), _ = jax.lax.scan(step, (start, state0), jnp.arange(n))
    return sT


def _inertial_dynamic_res(params, xi, xj):
    xhat = _integrate_rvp(params, xi, direction=1.0)
    return params["z"] - _RVP_M.local(xhat, xj)


def _inertial_dynamic_init1(params, pts):
    xi = jnp.asarray(pts[0], jnp.float32)
    p = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    return _integrate_rvp(p, xi, direction=1.0)


def _inertial_dynamic_init0(params, pts):
    xj = jnp.asarray(pts[1], jnp.float32)
    p = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    return _integrate_rvp(p, xj, direction=-1.0)


INERTIAL_DYNAMIC = register_factor_type(
    FactorType(
        name="InertialDynamic",
        variable_types=(RotVelPos, RotVelPos),
        zdim=9,
        residual=_inertial_dynamic_res,
        initializers={1: _inertial_dynamic_init1, 0: _inertial_dynamic_init0},
        coord_types=("c",) * 3 + ("e",) * 6,
        doc="DERelative ODE factor on RotVelPos: RK4 flow of the IMU "
        "kinematics (RoMEDiffEqExt.jl:13-39; imuKinematic! "
        "InertialDynamic.jl:14-37). The backward problem is the same flow "
        "integrated with negative step.",
    )
)


def InertialDynamic(
    tspan,
    dt: float,
    gyros,
    accels,
    Z: Distribution = None,
    gravity=GRAVITY,
) -> Factor:
    """Build the ODE inertial factor from sampled gyro/accel signals
    (RoMEDiffEqExt.jl:14-39 signature)."""
    gyros = np.asarray(gyros, dtype=np.float64).reshape(-1, 3)
    accels = np.asarray(accels, dtype=np.float64).reshape(-1, 3)
    assert gyros.shape == accels.shape
    Z = Z or MvNormal(np.zeros(9), np.diag([1e-3] * 3 + [1e-2] * 6))
    params = gaussian_params(Z.mean(), Z.cov())
    params.update(
        gyros=gyros,
        accels=accels,
        t0=np.float64(tspan[0]),
        dt_step=np.float64(dt),
        gravity=np.asarray(gravity, dtype=np.float64),
    )
    return Factor(ftype=INERTIAL_DYNAMIC, variables=(), params=params, dists=(Z,))
