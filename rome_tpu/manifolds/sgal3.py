"""SGal(3) — the Special Galilean group for IMU preintegration.

Re-design of the reference's SpecialGalileanGroup
(/root/reference/src/factors/Inertial/IMUDeltaFactor.jl:9-291): a 10-dim Lie
group over (R, v, p, t) with closed-form ``_Q``/``_P`` rotation integrals,
small/big adjoints, truncated-series right Jacobian, and the
gravity-compensated ``boxminus`` expected delta.

Point storage (flat, batched over leading dims): 11 floats
    [q(4) unit quaternion, v(3) velocity delta, p(3) position delta, t(1)]
(the reference stores R as a 3x3 StaticArray; quaternions are 4 floats and
vectorize better on the VPU).

Tangent coordinates (vee order, matching the reference's
``vee``/``hat`` pair IMUDeltaFactor.jl:99-117): 10 floats
    [rho(3) = v*dt, nu(3) = a*dt, theta(3) = w*dt, dt(1)]

All functions are pure, jit/vmap-safe, and Taylor-guarded at theta -> 0 so
they are differentiable everywhere (no data-dependent branches).
"""

from __future__ import annotations

import jax.numpy as jnp

from rome_tpu.manifolds import quat as Q

_EPS = 1e-12

GRAVITY = (0.0, 0.0, 9.81)  # reference boxminus default g⃗ (IMUDeltaFactor.jl:214)


def identity(dtype=jnp.float32):
    return jnp.concatenate(
        [Q.qidentity(dtype), jnp.zeros(7, dtype=dtype)]
    )


def _split(pt):
    return pt[..., :4], pt[..., 4:7], pt[..., 7:10], pt[..., 10]


def make_point(q, v, p, t):
    t = jnp.broadcast_to(jnp.asarray(t, dtype=q.dtype), q[..., :1].shape)
    return jnp.concatenate([q, v, p, t], axis=-1)


def compose(a, b):
    """(R,v,p,t) ∘ (r,w,s,u) = (Rr, v+Rw, p+v·u+Rs, t+u) (IMUDeltaFactor.jl:80-97)."""
    qa, va, pa, ta = _split(a)
    qb, vb, pb, tb = _split(b)
    q = Q.qmul(qa, qb)
    v = va + Q.qrotate(qa, vb)
    p = pa + va * tb[..., None] + Q.qrotate(qa, pb)
    t = ta + tb
    return jnp.concatenate([q, v, p, t[..., None]], axis=-1)


def inverse(a):
    """(Rᵀ, -Rᵀv, -Rᵀ(p - v t), -t) (IMUDeltaFactor.jl:66-78)."""
    q, v, p, t = _split(a)
    qi = Q.qconj(q)
    vi = -Q.qrotate(qi, v)
    pi = -Q.qrotate(qi, p - v * t[..., None])
    return jnp.concatenate([qi, vi, pi, -t[..., None]], axis=-1)


def _theta_coeffs(theta_vec):
    """Taylor-guarded scalar coefficients of the _Q/_P rotation integrals.

    Q = I + c1·thx + c2·thx²   with c1=(1-cosθ)/θ², c2=(θ-sinθ)/θ³
    P = I/2 + c2·thx + c3·thx² with c3=(cosθ+θ²/2-1)/θ⁴
    (IMUDeltaFactor.jl:123-149, rewritten from the unit-axis form u_x = thx/θ.)
    """
    t2 = jnp.sum(theta_vec * theta_vec, axis=-1)
    t = jnp.sqrt(t2 + _EPS)
    small = t2 < 1e-8
    c1 = jnp.where(small, 0.5 - t2 / 24.0, (1.0 - jnp.cos(t)) / jnp.maximum(t2, _EPS))
    c2 = jnp.where(small, 1.0 / 6.0 - t2 / 120.0, (t - jnp.sin(t)) / jnp.maximum(t2 * t, _EPS))
    c3 = jnp.where(
        small,
        1.0 / 24.0 - t2 / 720.0,
        (jnp.cos(t) + 0.5 * t2 - 1.0) / jnp.maximum(t2 * t2, _EPS),
    )
    return c1, c2, c3


def skew(w):
    """(...,3) -> (...,3,3) cross-product matrix."""
    z = jnp.zeros_like(w[..., 0])
    return jnp.stack(
        [
            jnp.stack([z, -w[..., 2], w[..., 1]], -1),
            jnp.stack([w[..., 2], z, -w[..., 0]], -1),
            jnp.stack([-w[..., 1], w[..., 0], z], -1),
        ],
        -2,
    )


def _QP_mats(theta_vec):
    c1, c2, c3 = _theta_coeffs(theta_vec)
    thx = skew(theta_vec)
    thx2 = thx @ thx
    eye = jnp.eye(3, dtype=theta_vec.dtype)
    Qm = eye + c1[..., None, None] * thx + c2[..., None, None] * thx2
    Pm = 0.5 * eye + c2[..., None, None] * thx + c3[..., None, None] * thx2
    return Qm, Pm


def _inv3(A):
    """Closed-form 3x3 inverse (adjugate / det) — pure elementwise math that
    fuses with its neighbours; jnp.linalg.inv would lower to a batched LU
    call, which is serial work for tiny matrices."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    adj = jnp.stack(
        [
            jnp.stack([A11, A12, A13], -1),
            jnp.stack([A21, A22, A23], -1),
            jnp.stack([A31, A32, A33], -1),
        ],
        -2,
    )
    return adj / det[..., None, None]


def exp(xc):
    """Tangent coords [rho, nu, theta, dt] -> group point (IMUDeltaFactor.jl:153-175).

    R = Exp(theta); v = Q·nu; p = Q·rho + P·nu·dt; t = dt.
    """
    rho, nu, theta, dt = xc[..., 0:3], xc[..., 3:6], xc[..., 6:9], xc[..., 9]
    Qm, Pm = _QP_mats(theta)
    q = Q.qexp(theta)
    v = jnp.einsum("...ij,...j->...i", Qm, nu)
    p = jnp.einsum("...ij,...j->...i", Qm, rho) + dt[..., None] * jnp.einsum(
        "...ij,...j->...i", Pm, nu
    )
    return jnp.concatenate([q, v, p, dt[..., None]], axis=-1)


def log(pt):
    """Group point -> tangent coords [rho, nu, theta, dt] (IMUDeltaFactor.jl:184-203).

    nu = Q⁻¹ v; rho = Q⁻¹ (p - P·nu·t); dt = t.
    """
    q, v, p, t = _split(pt)
    theta = Q.qlog(q)
    Qm, Pm = _QP_mats(theta)
    iQ = _inv3(Qm)
    nu = jnp.einsum("...ij,...j->...i", iQ, v)
    rho = jnp.einsum(
        "...ij,...j->...i", iQ, p - t[..., None] * jnp.einsum("...ij,...j->...i", Pm, nu)
    )
    return jnp.concatenate([rho, nu, theta, t[..., None]], axis=-1)


def boxminus(p, q, gravity=GRAVITY):
    """Gravity-compensated expected delta from p to q (IMUDeltaFactor.jl:214-237).

    ΔR = Rᵢᵀ Rⱼ;  Δv = Rᵢᵀ (vⱼ - vᵢ + g Δt);  Δp = Rᵢᵀ (pⱼ - pᵢ - vᵢ Δt + ½ g Δt²).
    """
    qi, vi, pi, ti = _split(p)
    qj, vj, pj, tj = _split(q)
    g = jnp.asarray(gravity, dtype=p.dtype)
    dt = tj - ti
    qiT = Q.qconj(qi)
    dq = Q.qmul(qiT, qj)
    dv = Q.qrotate(qiT, vj - vi + g * dt[..., None])
    dp = Q.qrotate(
        qiT, pj - pi - vi * dt[..., None] + 0.5 * g * (dt * dt)[..., None]
    )
    return jnp.concatenate([dq, dv, dp, dt[..., None]], axis=-1)


def adjoint_matrix(xc):
    """Small adjoint ad(X), (…,10,10), coords [rho, nu, theta, dt]
    (IMUDeltaFactor.jl:240-260)."""
    rho, nu, theta, dt = xc[..., 0:3], xc[..., 3:6], xc[..., 6:9], xc[..., 9]
    thx = skew(theta)
    rx = skew(rho)
    nx = skew(nu)
    z33 = jnp.zeros_like(thx)
    eye = jnp.eye(3, dtype=xc.dtype)
    dtI = dt[..., None, None] * eye
    row0 = jnp.concatenate([thx, -dtI, rx, nu[..., None]], axis=-1)
    row1 = jnp.concatenate([z33, thx, nx, jnp.zeros_like(nu[..., None])], axis=-1)
    row2 = jnp.concatenate([z33, z33, thx, jnp.zeros_like(nu[..., None])], axis=-1)
    row3 = jnp.zeros_like(row0[..., :1, :])
    return jnp.concatenate([row0, row1, row2, row3], axis=-2)


def Adjoint_matrix(pt):
    """Big adjoint Ad(p), (…,10,10) (IMUDeltaFactor.jl:263-282)."""
    q, v, p, t = _split(pt)
    R = Q.qto_matrix(q)
    vx = skew(v)
    pmvtx = skew(p - v * t[..., None])
    z33 = jnp.zeros_like(R)
    z31 = jnp.zeros_like(v[..., None])
    row0 = jnp.concatenate([R, -t[..., None, None] * R, pmvtx @ R, v[..., None]], axis=-1)
    row1 = jnp.concatenate([z33, R, vx @ R, z31], axis=-1)
    row2 = jnp.concatenate([z33, z33, R, z31], axis=-1)
    last = jnp.concatenate(
        [jnp.zeros_like(row0[..., :1, :9]), jnp.ones_like(row0[..., :1, :1])], axis=-1
    )
    return jnp.concatenate([row0, row1, row2, last], axis=-2)


def right_jacobian(xc, order: int = 5):
    """Truncated-series right Jacobian Jr = Σ (-ad)^i / (i+1)!
    (IMUDeltaFactor.jl:286-291)."""
    nad = -adjoint_matrix(xc)
    eye = jnp.broadcast_to(jnp.eye(10, dtype=xc.dtype), nad.shape)
    out = eye
    term = eye
    fact = 1.0
    for i in range(1, order + 1):
        term = term @ nad
        fact *= i + 1
        out = out + term / fact
    return out
