"""Small numerical utilities shared across the framework.

Every function here is shape-polymorphic, jit-safe and vmap-safe (no
data-dependent Python control flow).

Reference parity:
  - ``sym_rem`` mirrors ``Manifolds.sym_rem`` used throughout the reference
    residuals (e.g. /root/reference/src/factors/Bearing2D.jl:30).
  - ``spd_repair`` mirrors the Hermitian covariance repair in the g2o parser
    (/root/reference/src/services/g2oParser.jl:107-109) and the SPD repair in
    the IMU preintegration constructor (IMUDeltaFactor.jl:476-483).
  - ``cont2disc`` mirrors the continuous->discrete noise integration used by
    odometry accumulation (/root/reference/src/services/OdometryUtils.jl:24-51,
    via IncrementalInference.cont2disc).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


TWO_PI = 2.0 * jnp.pi


def full_f32_matmuls(fn):
    """Trace ``fn`` with every f32 matrix product at full f32 precision.

    At JAX's default precision a GPU may run an f32 product in TF32, which
    keeps about three decimal digits. The solvers' f32 factors and
    preconditioners then get weaker, and the LM iteration count moves with
    the caller's ``jax_default_matmul_precision``. The scope is entered while
    ``fn`` is traced, so each ``dot_general`` in its jaxpr carries
    ``Precision.HIGHEST`` whatever the global setting."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


def sym_rem(theta):
    """Symmetric remainder: wrap angle(s) to the interval [-pi, pi).

    Matches Manifolds.sym_rem semantics used by the reference residuals.
    """
    return jnp.mod(theta + jnp.pi, TWO_PI) - jnp.pi


def wrap_angle(theta):
    """Alias of :func:`sym_rem`."""
    return sym_rem(theta)


def spd_repair(mat, eps: float = 0.0):
    """Symmetrize a covariance and optionally inflate the diagonal.

    ``(M + M^T)/2 (+ eps*I)`` — the same Hermitian workaround the reference
    applies after inverting g2o information matrices
    (g2oParser.jl:107-109) and to preintegrated IMU covariances
    (IMUDeltaFactor.jl:476-483).
    """
    mat = 0.5 * (mat + jnp.swapaxes(mat, -1, -2))
    if eps:
        mat = mat + eps * jnp.eye(mat.shape[-1], dtype=mat.dtype)
    return mat


def sqrt_info_from_cov(cov):
    """Upper-triangular square-root information matrix from a covariance.

    Whitening convention: ``r_white = S @ r`` with ``S^T S = inv(cov)``.
    Computed as ``S = inv(chol(cov, lower).T)`` per batch element; shapes
    ``(..., d, d)``.
    """
    cov = spd_repair(cov)
    L = jnp.linalg.cholesky(cov)          # cov = L L^T
    eye = jnp.eye(cov.shape[-1], dtype=cov.dtype)
    eye = jnp.broadcast_to(eye, cov.shape)
    # Solve L S^T = I  => S = inv(L)^T is upper triangular, S^T S = inv(cov)
    Linv = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
    return Linv  # (S = Linv, and S^T S = inv(cov)); lower-triangular whitener


def cont2disc(F, G, Qc, dt):
    """First-order continuous-to-discrete noise integration.

    ``Phi = I + F dt``, ``Qd = Phi G Qc G^T Phi^T dt`` (matched to the
    first-order Van Loan discretisation the reference uses when accumulating
    odometry, OdometryUtils.jl:24-51).
    Returns ``(Phi, Qd)``.
    """
    d = F.shape[-1]
    Phi = jnp.eye(d, dtype=F.dtype) + F * dt
    M = G @ Qc @ jnp.swapaxes(G, -1, -2)
    Qd = Phi @ M @ jnp.swapaxes(Phi, -1, -2) * dt
    return Phi, spd_repair(Qd)


def skew2(omega):
    """so(2) hat map: scalar -> 2x2 skew matrix (batched over leading dims)."""
    z = jnp.zeros_like(omega)
    return jnp.stack(
        [jnp.stack([z, -omega], -1), jnp.stack([omega, z], -1)], -2
    )


def skew3(v):
    """so(3) hat map: (...,3) -> (...,3,3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([o, -z, y], -1),
            jnp.stack([z, o, -x], -1),
            jnp.stack([-y, x, o], -1),
        ],
        -2,
    )


def safe_norm(v, axis=-1, eps=1e-12):
    """Differentiable-at-zero Euclidean norm (norm grad at 0 is NaN in JAX;
    particles can legitimately land on top of each other in approxConv)."""
    return jnp.sqrt(jnp.sum(v * v, axis=axis) + eps)


def rot2(theta):
    """SO(2) rotation matrix from angle, (...,) -> (...,2,2)."""
    c, s = jnp.cos(theta), jnp.sin(theta)
    return jnp.stack([jnp.stack([c, -s], -1), jnp.stack([s, c], -1)], -2)


def sym_rem_np(theta):
    """Numpy twin of sym_rem for host-side code paths."""
    import numpy as _np

    return _np.arctan2(_np.sin(theta), _np.cos(theta))
