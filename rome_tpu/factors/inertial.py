"""Inertial factors — IMU preintegration on SGal(3) and support factors.

Re-design of the reference inertial stack
(/root/reference/src/factors/Inertial/IMUDeltaFactor.jl:293-496,
PriorIMUBias.jl:13-37, ../PriorVelPos3.jl:13-33, ../VelPosRotVelPos.jl:6-26,
../VelAlign.jl:6-42): preintegration runs as one ``lax.scan`` over the raw
IMU stream (covariance + bias-Jacobian propagation fused into the same scan),
and the factor residual is a pure SGal(3) kernel the solvers vmap over dense
factor batches.

Variable layouts (see rome_tpu.variables):
  RotVelPos = [q(4), v(3), p(3)]        (SO(3) x T(3) x T(3))
  VelPos3   = [v(3), p(3)]              (T(3) x T(3))
  IMUBias   = [b_a(3), b_w(3)]          (T(3) x T(3))
  Pose3     = [t(3), q(4)]              (SE(3))
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from rome_tpu.distributions import Distribution, MvNormal
from rome_tpu.factors.base import Factor, FactorType, make_gaussian_factor, register_factor_type
from rome_tpu.manifolds import quat as Q
from rome_tpu.manifolds import sgal3 as G
from rome_tpu.variables import IMUBias, Pose3, Rotation3, RotVelPos, VelPos3

_RVP_M = RotVelPos.manifold
_VP_M = VelPos3.manifold
_BIAS_M = IMUBias.manifold


# ---------------------------------------------------------------------------
# Preintegration (IMUDeltaFactor.jl:411-458) as a lax.scan
# ---------------------------------------------------------------------------

def _tau_dt(dt, dtype):
    """(10,6) map from (accel, gyro) noise to tangent coords: nu rows get
    dt*I from accel, theta rows get dt*I from gyro (IMUDeltaFactor.jl:403-409)."""
    eye = jnp.eye(3, dtype=dtype)
    z = jnp.zeros((3, 3), dtype=dtype)
    z1 = jnp.zeros((1, 6), dtype=dtype)
    return jnp.concatenate(
        [
            jnp.concatenate([z, z], axis=-1),            # rho rows
            jnp.concatenate([dt * eye, z], axis=-1),     # nu rows <- accel
            jnp.concatenate([z, dt * eye], axis=-1),     # theta rows <- gyro
            z1,                                          # dt row
        ],
        axis=0,
    )


def integrate_imu_delta(delta, Sigma, J_b, a, w, a_b, w_b, dt, Sigma_y):
    """One preintegration step with covariance + bias-Jacobian propagation
    (IMUDeltaFactor.jl:411-445)."""
    z3 = jnp.zeros(3, dtype=delta.dtype)
    Xc = jnp.concatenate([z3, (a - a_b) * dt, (w - w_b) * dt, dt[None]])
    djk = G.exp(Xc)
    delta_new = G.compose(delta, djk)

    tau = _tau_dt(dt, delta.dtype)
    Jr = G.right_jacobian(Xc)
    A = G.Adjoint_matrix(G.inverse(djk))  # jacobian of compose wrt delta
    Jy = Jr @ tau
    Sigma_new = A @ Sigma @ A.T + Jy @ Sigma_y @ Jy.T
    J_b_new = A @ J_b - Jy
    return delta_new, Sigma_new, J_b_new


def preintegrate_imu(accels, gyros, deltatimes, Sigma_y, a_b=None, w_b=None):
    """Preintegrate an IMU stream -> (delta point (11,), Sigma (10,10), J_b (10,6)).

    One fused lax.scan (IMUDeltaFactor.jl:448-458). Runs under an x64 scope on
    the host CPU backend: preintegration happens once per factor at
    graph-build time on a short stream, so it stays off the device and
    float64 accuracy wins over the graph dtype here; the solve-time residual
    kernels stay in the graph's (float32/bfloat16) dtype on the accelerator.
    """
    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(), jax.default_device(cpu):
        accels = jnp.asarray(np.asarray(accels, dtype=np.float64).reshape(-1, 3))
        gyros = jnp.asarray(np.asarray(gyros, dtype=np.float64).reshape(-1, 3))
        dts = jnp.asarray(np.asarray(deltatimes, dtype=np.float64).reshape(-1))
        Sigma_y = jnp.asarray(np.asarray(Sigma_y, dtype=np.float64))
        a_b = jnp.zeros(3, dtype=jnp.float64) if a_b is None else jnp.asarray(
            np.asarray(a_b, dtype=np.float64)
        )
        w_b = jnp.zeros(3, dtype=jnp.float64) if w_b is None else jnp.asarray(
            np.asarray(w_b, dtype=np.float64)
        )

        def step(carry, inp):
            delta, Sigma, J_b = carry
            a, w, dt = inp
            return (
                integrate_imu_delta(delta, Sigma, J_b, a, w, a_b, w_b, dt, Sigma_y),
                None,
            )

        init = (
            G.identity(jnp.float64),
            jnp.zeros((10, 10), dtype=jnp.float64),
            jnp.zeros((10, 6), dtype=jnp.float64),
        )
        (delta, Sigma, J_b), _ = jax.lax.scan(step, init, (accels, gyros, dts))
        return (
            np.asarray(delta, dtype=np.float64),
            np.asarray(Sigma, dtype=np.float64),
            np.asarray(J_b, dtype=np.float64),
        )


# ---------------------------------------------------------------------------
# IMUDeltaFactor residual kernels (IMUDeltaFactor.jl:342-401)
# ---------------------------------------------------------------------------

def _imu_residual(params, pi_pt, pj_pt, b):
    """Core 9-dof residual: vee(log(Δi⁻¹ ∘ (p ⊟ q)))[1:9] with first-order
    bias correction Δi = Δmeas ∘ exp(J_b (b - b̄)) (IMUDeltaFactor.jl:342-361)."""
    corr = G.exp(params["J_b"] @ (b - params["b0"]))
    Di = G.compose(params["delta"], corr)
    Dhat = G.boxminus(pi_pt, pj_pt, gravity=params["gravity"])
    return G.log(G.compose(G.inverse(Di), Dhat))[..., :9]


def _rvp_to_sgal(x, t):
    return G.make_point(x[..., :4], x[..., 4:7], x[..., 7:10], t)


def _imu_rvp_res(params, xi, xj):
    zero_t = jnp.zeros((), dtype=xi.dtype)
    return _imu_residual(
        params,
        _rvp_to_sgal(xi, zero_t),
        _rvp_to_sgal(xj, params["dt"]),
        params["b0"],
    )


def _imu_rvp_bias_res(params, xi, xj, b):
    zero_t = jnp.zeros((), dtype=xi.dtype)
    return _imu_residual(
        params, _rvp_to_sgal(xi, zero_t), _rvp_to_sgal(xj, params["dt"]), b
    )


def _pose3velpos_to_sgal(pose, velpos, t):
    # reference overload maps (Pose3, vel) -> (R, v, p) (IMUDeltaFactor.jl:390-401)
    return G.make_point(pose[..., 3:7], velpos[..., :3], pose[..., :3], t)


def _imu_p3vp_res(params, pose_i, vp_i, pose_j, vp_j):
    zero_t = jnp.zeros((), dtype=pose_i.dtype)
    return _imu_residual(
        params,
        _pose3velpos_to_sgal(pose_i, vp_i, zero_t),
        _pose3velpos_to_sgal(pose_j, vp_j, params["dt"]),
        params["b0"],
    )


def _imu_initializer(params, pts):
    """Init slot 1 by gravity-compensated forward propagation of slot 0."""
    # host init path hands float64 numpy; cast to f32 (also keeps the body
    # traceable under the FactorGraph jitted-initializer cache)
    xi = jnp.asarray(pts[0], jnp.float32)
    params = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    p = _rvp_to_sgal(xi, jnp.zeros((), dtype=xi.dtype))
    # q from boxminus inverse: given delta, solve q s.t. boxminus(p, q) = delta
    d = params["delta"]
    g = params["gravity"]
    dt = d[..., 10]
    qi, vi, pi = p[..., :4], p[..., 4:7], p[..., 7:10]
    qj = Q.qmul(qi, d[..., :4])
    vj = vi + Q.qrotate(qi, d[..., 4:7]) - g * dt[..., None]
    pj = pi + vi * dt[..., None] - 0.5 * g * (dt * dt)[..., None] + Q.qrotate(qi, d[..., 7:10])
    return jnp.concatenate([qj, vj, pj], axis=-1)


IMU_DELTA_RVP = register_factor_type(
    FactorType(
        name="IMUDeltaRotVelPos",
        variable_types=(RotVelPos, RotVelPos),
        zdim=9,
        residual=_imu_rvp_res,
        initializers={1: _imu_initializer},
        coord_types=("e",) * 6 + ("c",) * 3,
        doc="Preintegrated IMU odometry between RotVelPos states "
        "(IMUDeltaFactor.jl:342-361).",
    )
)

IMU_DELTA_RVP_BIAS = register_factor_type(
    FactorType(
        name="IMUDeltaRotVelPosBias",
        variable_types=(RotVelPos, RotVelPos, IMUBias),
        zdim=9,
        residual=_imu_rvp_bias_res,
        initializers={1: _imu_initializer},
        coord_types=("e",) * 6 + ("c",) * 3,
        doc="Preintegrated IMU odometry with first-order bias correction "
        "through an IMUBias variable (IMUDeltaFactor.jl:342-361).",
    )
)

IMU_DELTA_P3VP = register_factor_type(
    FactorType(
        name="IMUDeltaPose3VelPos3",
        variable_types=(Pose3, VelPos3, Pose3, VelPos3),
        zdim=9,
        residual=_imu_p3vp_res,
        coord_types=("e",) * 6 + ("c",) * 3,
        doc="Preintegrated IMU odometry on the Pose3 + VelPos3 variable split "
        "(IMUDeltaFactor.jl:390-401).",
    )
)


def IMUDeltaFactor(
    accels,
    gyros,
    deltatimes,
    Sigma_y,
    a_b=(0.0, 0.0, 0.0),
    w_b=(0.0, 0.0, 0.0),
    gravity=G.GRAVITY,
    signature: str = "RotVelPos",
) -> Factor:
    """Build the preintegrated IMU factor from a raw measurement stream
    (IMUDeltaFactor.jl:460-496): runs the preintegration scan, SPD-repairs
    the 9x9 covariance, and packs (delta, J_b, b0, dt, gravity) params.

    ``signature`` picks the variable split: "RotVelPos" (2 vars),
    "RotVelPosBias" (3 vars incl. IMUBias), "Pose3VelPos3" (4 vars).
    """
    delta, Sigma, J_b = preintegrate_imu(accels, gyros, deltatimes, Sigma_y, a_b, w_b)
    delta = np.asarray(delta, dtype=np.float64)
    Sigma = np.asarray(Sigma, dtype=np.float64)
    J_b = np.asarray(J_b, dtype=np.float64)

    S = Sigma[:9, :9]
    S = 0.5 * (S + S.T)
    # SPD repair as the reference does (IMUDeltaFactor.jl:476-483)
    S = S + np.diag((np.diag(S) == 0.0) * 1e-15)
    w = np.linalg.eigvalsh(S)
    if w.min() <= 0:
        S = S + (1e-12 - min(w.min(), 0.0)) * np.eye(9)

    with jax.enable_x64(), jax.default_device(jax.devices("cpu")[0]):
        Xc = np.asarray(G.log(jnp.asarray(delta)), dtype=np.float64)
    L = np.linalg.cholesky(S)
    sqrt_info = np.linalg.inv(L)

    ftype = {
        "RotVelPos": IMU_DELTA_RVP,
        "RotVelPosBias": IMU_DELTA_RVP_BIAS,
        "Pose3VelPos3": IMU_DELTA_P3VP,
    }[signature]

    b0 = np.concatenate([np.asarray(a_b, np.float64), np.asarray(w_b, np.float64)])
    params = {
        "z": Xc[:9],
        "sqrt_info": sqrt_info,
        "delta": delta,
        "J_b": J_b,
        "b0": b0,
        "dt": np.float64(delta[10]),
        "gravity": np.asarray(gravity, np.float64),
    }
    return Factor(
        ftype=ftype,
        variables=(),
        params=params,
        dists=(MvNormal(Xc[:9], S),),
    )


# ---------------------------------------------------------------------------
# Support factors
# ---------------------------------------------------------------------------

def _prior_rvp_res(params, x):
    m = _RVP_M.exp(params["z"])
    return _RVP_M.local(x, m)


PRIOR_ROTVELPOS = register_factor_type(
    FactorType(
        name="PriorRotVelPos",
        variable_types=(RotVelPos,),
        zdim=9,
        residual=_prior_rvp_res,
        initializers={0: lambda params, pts: _RVP_M.exp(params["z"])},
        coord_types=("c",) * 3 + ("e",) * 6,
        doc="Full prior on a RotVelPos state (cf. ManifoldPrior use in "
        "test/inertial/testIMUDeltaFactor.jl:237-251).",
    )
)


def PriorRotVelPos(Z: Distribution = None):
    return make_gaussian_factor(
        PRIOR_ROTVELPOS, (), Z or MvNormal(np.zeros(9), np.eye(9) * 1e-3)
    )


def _prior_velpos_res(params, x):
    m = _VP_M.exp(params["z"])
    return _VP_M.local(x, m)


PRIOR_VELPOS3 = register_factor_type(
    FactorType(
        name="PriorVelPos3",
        variable_types=(VelPos3,),
        zdim=6,
        residual=_prior_velpos_res,
        initializers={0: lambda params, pts: _VP_M.exp(params["z"])},
        coord_types=("e",) * 6,
        doc="Prior on a VelPos3 state (PriorVelPos3.jl:13-33).",
    )
)


def PriorVelPos3(Z: Distribution = None):
    return make_gaussian_factor(
        PRIOR_VELPOS3, (), Z or MvNormal(np.zeros(6), np.diag([1, 1, 0.1, 1, 1, 1.0]))
    )


def _prior_imubias_res(params, b):
    return params["z"] - b


PRIOR_IMUBIAS = register_factor_type(
    FactorType(
        name="PriorIMUBias",
        variable_types=(IMUBias,),
        zdim=6,
        residual=_prior_imubias_res,
        initializers={0: lambda params, pts: params["z"]},
        coord_types=("e",) * 6,
        doc="Prior on accelerometer+gyro bias (PriorIMUBias.jl:13-37: m .- p).",
    )
)


def PriorIMUBias(Z: Distribution = None):
    return make_gaussian_factor(
        PRIOR_IMUBIAS, (), Z or MvNormal(np.zeros(6), np.eye(6) * 0.5)
    )


def _velpos_rvp_res(params, p, q):
    # [z_v - (q.v - p.v); z_p - (q.p - p.p)] (VelPosRotVelPos.jl:20-30)
    dv = q[..., 4:7] - p[..., :3]
    dp = q[..., 7:10] - p[..., 3:6]
    return params["z"] - jnp.concatenate([dv, dp], axis=-1)


VELPOS_ROTVELPOS = register_factor_type(
    FactorType(
        name="VelPosRotVelPos",
        variable_types=(VelPos3, RotVelPos),
        zdim=6,
        residual=_velpos_rvp_res,
        coord_types=("e",) * 6,
        doc="Linear offset link VelPos3 <-> RotVelPos (VelPosRotVelPos.jl:6-26).",
    )
)


def VelPosRotVelPos(Z: Distribution = None):
    return make_gaussian_factor(
        VELPOS_ROTVELPOS, (), Z or MvNormal(np.zeros(6), np.eye(6) * 0.1)
    )


def _velalign_res(params, vp, rvp, rot):
    # p_V = |vp.vel| * z ; q_V = R(rvp)^T rvp.vel ; res = p_V - R(rot) q_V
    # (VelAlign.jl:30-42)
    speed = jnp.linalg.norm(vp[..., :3], axis=-1, keepdims=True)
    p_V = speed * params["z"]
    q_V = Q.qrotate(Q.qconj(rvp[..., :4]), rvp[..., 4:7])
    return p_V - Q.qrotate(rot, q_V)


VELALIGN = register_factor_type(
    FactorType(
        name="VelAlign",
        variable_types=(VelPos3, RotVelPos, Rotation3),
        zdim=3,
        residual=_velalign_res,
        coord_types=("e",) * 3,
        doc="Velocity-direction alignment across VelPos3/RotVelPos/Rotation3 "
        "(VelAlign.jl:6-42).",
    )
)


def VelAlign(Z: Distribution = None):
    return make_gaussian_factor(
        VELALIGN, (), Z or MvNormal([1.0, 0, 0], np.eye(3) * 0.1)
    )
