"""Unit-quaternion kernels (w, x, y, z storage) — the SO(3) point type.

All functions operate on trailing-dim-4 arrays, are jit/vmap-safe, and use
Taylor-guarded branches (jnp.where, never Python conditionals) so they trace
once under XLA.

The reference stores SO(3) points as 3x3 StaticArrays matrices
(/root/reference/src/variables/VariableTypes.jl:47-50); we use unit
quaternions instead: 4 floats/point instead of 9, cheaper compose, and
renormalisation is a single rsqrt.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-12


def qidentity(dtype=jnp.float32):
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def qnormalize(q):
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def qmul(a, b):
    """Hamilton product a ⊗ b, (...,4)x(...,4)->(...,4)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def qconj(q):
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def qrotate(q, v):
    """Rotate vector(s) v by quaternion(s) q: R(q) @ v, (...,4),(...,3)->(...,3)."""
    qv = q[..., 1:]
    w = q[..., :1]
    t = 2.0 * jnp.cross(qv, v)
    return v + w * t + jnp.cross(qv, t)


def qexp(phi):
    """so(3) coords -> unit quaternion, exp map. (...,3)->(...,4)."""
    theta2 = jnp.sum(phi * phi, axis=-1, keepdims=True)
    theta = jnp.sqrt(theta2 + _EPS)
    half = 0.5 * theta
    # sin(t/2)/t with Taylor guard: 1/2 - t^2/48 for small t
    small = theta2 < 1e-8
    k = jnp.where(small, 0.5 - theta2 / 48.0, jnp.sin(half) / theta)
    w = jnp.where(small[..., 0], 1.0 - theta2[..., 0] / 8.0, jnp.cos(half[..., 0]))
    return jnp.concatenate([w[..., None], k * phi], axis=-1)


def qlog(q):
    """Unit quaternion -> so(3) coords (minimal rotation). (...,4)->(...,3)."""
    # canonicalize to w >= 0 so the log is the minimal-angle representative
    sign = jnp.where(q[..., :1] < 0.0, -1.0, 1.0)
    q = q * sign
    w = q[..., 0]
    v = q[..., 1:]
    n2 = jnp.sum(v * v, axis=-1)
    n = jnp.sqrt(n2 + _EPS)
    angle = 2.0 * jnp.arctan2(n, w)
    small = n2 < 1e-12
    k = jnp.where(small, 2.0 / jnp.maximum(w, 0.5) * (1.0 - n2 / (3.0 * jnp.maximum(w * w, 0.25))), angle / n)
    return k[..., None] * v


def qto_matrix(q):
    """(...,4) -> (...,3,3) rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = jnp.stack(
        [
            jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
            jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
            jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
        ],
        -2,
    )
    return r


def qfrom_matrix(R):
    """(...,3,3) -> (...,4) quaternion (w>=0). Shepperd's method, branch-free."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # four candidate constructions; pick the numerically best by max pivot
    qw0 = jnp.sqrt(jnp.maximum(1.0 + tr, _EPS)) / 2.0
    q0 = jnp.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0), (m10 - m01) / (4 * qw0)], -1)

    qx1 = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, _EPS)) / 2.0
    q1 = jnp.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1)], -1)

    qy2 = jnp.sqrt(jnp.maximum(1.0 - m00 + m11 - m22, _EPS)) / 2.0
    q2 = jnp.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2)], -1)

    qz3 = jnp.sqrt(jnp.maximum(1.0 - m00 - m11 + m22, _EPS)) / 2.0
    q3 = jnp.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3], -1)

    pivots = jnp.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], -1)
    best = jnp.argmax(pivots, axis=-1)
    qs = jnp.stack([q0, q1, q2, q3], -2)  # (...,4cand,4)
    q = jnp.take_along_axis(qs, best[..., None, None].astype(jnp.int32) * jnp.ones_like(qs[..., :1, :], dtype=jnp.int32), axis=-2)[..., 0, :]
    sign = jnp.where(q[..., :1] < 0.0, -1.0, 1.0)
    return qnormalize(q * sign)
