"""Lie-group manifold kernels — the foundation every factor vmaps over.

Design (not a port):
  The reference represents points as Julia ``ArrayPartition`` objects with
  per-type dynamic dispatch (/root/reference/src/variables/VariableTypes.jl).
  Here every manifold point is a flat fixed-width vector so variables of one
  type pack into a dense ``(n, point_dim)`` array that XLA can tile; all ops
  are pure functions over trailing dims, safe under jit/vmap/scan and under
  broadcasting of their leading dims.

Tangent convention ("hybrid", matching the reference):
  The reference uses Manifolds.jl ``SpecialEuclidean(n; vectors=
  HybridTangentRepresentation())`` (e.g. Pose2D.jl:107, PriorPose2.jl:18-25):
  translation tangents are plain body-frame vectors (no SE(n) V-matrix
  coupling) and rotation tangents are so(n) coordinates. Concretely:

    boxplus(p, xi) = compose(p, exp(xi))      right/body perturbation
    local(p, q)    = log(compose(inv(p), q))  body-frame difference
    SE(2): exp(v, w) = ((vx, vy), R(w)),  log(t, R) = (t, theta(R))

  which reproduces the reference residual math exactly (PriorPose2.jl:37-47:
  ``vee(log(M, p, m))``; Pose2D.jl:48-67: ``vee(log(M, q, p∘exp(X)))``).

Coordinate types:
  ``coord_types`` marks each tangent dim Euclidean ('e') or circular ('c'),
  mirroring the per-manifold tuples the reference keeps for its KDE layer
  (/root/reference/src/Deprecated.jl:64-73).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from rome_tpu.utils.math import sym_rem
from rome_tpu.manifolds import quat as Q


class Manifold:
    """A Lie group with flat-vector point storage.

    Subclasses define: name, point_dim, dof, coord_types, identity, compose,
    inverse, exp, log (all batched over leading dims).
    """

    name: str = "abstract"
    point_dim: int = 0
    dof: int = 0
    coord_types: tuple = ()

    # -- group ops -----------------------------------------------------------
    def identity(self, dtype=jnp.float32):
        raise NotImplementedError

    def compose(self, a, b):
        raise NotImplementedError

    def inverse(self, a):
        raise NotImplementedError

    def exp(self, xi):
        """Tangent coords (…, dof) -> group element (…, point_dim)."""
        raise NotImplementedError

    def log(self, p):
        """Group element (…, point_dim) -> tangent coords (…, dof)."""
        raise NotImplementedError

    def normalize(self, p):
        """Re-project onto the manifold (wrap angles / renormalise quats)."""
        return p

    # -- derived ops ---------------------------------------------------------
    def boxplus(self, p, xi):
        """Right (body-frame) retraction: p ∘ exp(xi)."""
        return self.compose(p, self.exp(xi))

    def local(self, p, q):
        """Coords of q relative to p: log(p⁻¹ ∘ q). boxplus(p, local(p,q)) == q."""
        return self.log(self.compose(self.inverse(p), q))

    def dist(self, p, q):
        return jnp.linalg.norm(self.local(p, q), axis=-1)

    def random_tangent_scale(self):
        """Per-dim scale hints for random sampling (1.0 everywhere)."""
        return np.ones(self.dof)

    def __repr__(self):
        return f"<{self.name}>"


class TranslationGroup(Manifold):
    """T(n) — Euclidean vector addition group.

    Reference: ``TranslationGroup(n)`` variables Point2/Point3/DynPoint2
    (VariableTypes.jl:13-27, 98).
    """

    def __init__(self, n: int):
        self.n = n
        self.name = f"TranslationGroup({n})"
        self.point_dim = n
        self.dof = n
        self.coord_types = ("e",) * n

    def identity(self, dtype=jnp.float32):
        return jnp.zeros(self.n, dtype=dtype)

    def compose(self, a, b):
        return a + b

    def inverse(self, a):
        return -a

    def exp(self, xi):
        return xi

    def log(self, p):
        return p


class SO2(Manifold):
    """SO(2), point stored as wrapped angle (…, 1).

    Reference: ``SpecialOrthogonal(2)`` / ``RealCircleGroup`` manifolds used by
    bearing factors (Bearing2D.jl:20) and PartialPriorYawPose2
    (PartialPriorPose2.jl:7-27).
    """

    name = "SpecialOrthogonal(2)"
    point_dim = 1
    dof = 1
    coord_types = ("c",)

    def identity(self, dtype=jnp.float32):
        return jnp.zeros(1, dtype=dtype)

    def compose(self, a, b):
        return sym_rem(a + b)

    def inverse(self, a):
        return -a

    def exp(self, xi):
        return sym_rem(xi)

    def log(self, p):
        return sym_rem(p)

    def normalize(self, p):
        return sym_rem(p)


class SO3(Manifold):
    """SO(3), point stored as unit quaternion (w,x,y,z) (…, 4).

    Reference: ``SpecialOrthogonal(3)`` / Rotation3 (VariableTypes.jl:50).
    """

    name = "SpecialOrthogonal(3)"
    point_dim = 4
    dof = 3
    coord_types = ("c", "c", "c")

    def identity(self, dtype=jnp.float32):
        return Q.qidentity(dtype)

    def compose(self, a, b):
        return Q.qmul(a, b)

    def inverse(self, a):
        return Q.qconj(a)

    def exp(self, xi):
        return Q.qexp(xi)

    def log(self, p):
        return Q.qlog(p)

    def normalize(self, p):
        return Q.qnormalize(p)


class SE2(Manifold):
    """SE(2), point stored as (x, y, theta) (…, 3); hybrid tangent (vx, vy, w).

    Reference: Pose2 on ``SpecialEuclidean(2; vectors=
    HybridTangentRepresentation())`` (VariableTypes.jl:35, PriorPose2.jl:18-25).
    """

    name = "SpecialEuclidean(2)"
    point_dim = 3
    dof = 3
    coord_types = ("e", "e", "c")

    def identity(self, dtype=jnp.float32):
        return jnp.zeros(3, dtype=dtype)

    # rotations written out elementwise, not as a 2x2 matmul: broadcasting
    # callers ((N, 1, 3) against (1, Nj, 3)) fuse into one loop, and no f32
    # product is left to the backend's default matmul precision
    def compose(self, a, b):
        c, s = jnp.cos(a[..., 2]), jnp.sin(a[..., 2])
        bx, by = b[..., 0], b[..., 1]
        x = a[..., 0] + c * bx - s * by
        y = a[..., 1] + s * bx + c * by
        th = sym_rem(a[..., 2] + b[..., 2])
        return jnp.stack([x, y, th], axis=-1)

    def inverse(self, a):
        c, s = jnp.cos(a[..., 2]), jnp.sin(a[..., 2])
        ax, ay = a[..., 0], a[..., 1]
        return jnp.stack([-(c * ax + s * ay), s * ax - c * ay, -a[..., 2]], axis=-1)

    def exp(self, xi):
        # hybrid: translation passes through linearly, angle wraps
        return jnp.concatenate([xi[..., :2], sym_rem(xi[..., 2:3])], axis=-1)

    def log(self, p):
        return jnp.concatenate([p[..., :2], sym_rem(p[..., 2:3])], axis=-1)

    def normalize(self, p):
        return jnp.concatenate([p[..., :2], sym_rem(p[..., 2:3])], axis=-1)


class SE3(Manifold):
    """SE(3), point stored as (t[3], q[4]) (…, 7); hybrid tangent (v[3], w[3]).

    Reference: Pose3 on ``SpecialEuclidean(3)`` (VariableTypes.jl:47); factor
    coords via ``get_coordinates(..., DefaultOrthogonalBasis())`` order
    (translation, rotation) (Pose3Pose3.jl:9-29).
    """

    name = "SpecialEuclidean(3)"
    point_dim = 7
    dof = 6
    coord_types = ("e", "e", "e", "c", "c", "c")

    def identity(self, dtype=jnp.float32):
        return jnp.concatenate([jnp.zeros(3, dtype=dtype), Q.qidentity(dtype)])

    def compose(self, a, b):
        t = a[..., :3] + Q.qrotate(a[..., 3:], b[..., :3])
        q = Q.qmul(a[..., 3:], b[..., 3:])
        return jnp.concatenate([t, q], axis=-1)

    def inverse(self, a):
        qi = Q.qconj(a[..., 3:])
        t = -Q.qrotate(qi, a[..., :3])
        return jnp.concatenate([t, qi], axis=-1)

    def exp(self, xi):
        return jnp.concatenate([xi[..., :3], Q.qexp(xi[..., 3:])], axis=-1)

    def log(self, p):
        return jnp.concatenate([p[..., :3], Q.qlog(p[..., 3:])], axis=-1)

    def normalize(self, p):
        return jnp.concatenate([p[..., :3], Q.qnormalize(p[..., 3:])], axis=-1)


class ProductGroup(Manifold):
    """Direct product of manifolds, points/tangents concatenated.

    Reference: ``ProductGroup`` variables RotVelPos, VelPos3, DynPose2
    (VariableTypes.jl:53-116) and custom SE2E2/BearingRange manifolds
    (FixmeManifolds.jl:14-77).
    """

    def __init__(self, parts, name=None):
        self.parts = tuple(parts)
        self.name = name or ("ProductGroup(" + "x".join(p.name for p in self.parts) + ")")
        self.point_dim = sum(p.point_dim for p in self.parts)
        self.dof = sum(p.dof for p in self.parts)
        self.coord_types = tuple(c for p in self.parts for c in p.coord_types)
        # slices into point / tangent storage
        self._pslices, self._tslices = [], []
        po = to = 0
        for p in self.parts:
            self._pslices.append(slice(po, po + p.point_dim))
            self._tslices.append(slice(to, to + p.dof))
            po += p.point_dim
            to += p.dof

    def _map2(self, fn_name, a, b, slices):
        outs = [getattr(p, fn_name)(a[..., s], b[..., s]) for p, s in zip(self.parts, slices)]
        return jnp.concatenate(outs, axis=-1)

    def identity(self, dtype=jnp.float32):
        return jnp.concatenate([p.identity(dtype) for p in self.parts])

    def compose(self, a, b):
        return self._map2("compose", a, b, self._pslices)

    def inverse(self, a):
        return jnp.concatenate(
            [p.inverse(a[..., s]) for p, s in zip(self.parts, self._pslices)], axis=-1
        )

    def exp(self, xi):
        return jnp.concatenate(
            [p.exp(xi[..., s]) for p, s in zip(self.parts, self._tslices)], axis=-1
        )

    def log(self, pt):
        return jnp.concatenate(
            [p.log(pt[..., s]) for p, s in zip(self.parts, self._pslices)], axis=-1
        )

    def normalize(self, pt):
        return jnp.concatenate(
            [p.normalize(pt[..., s]) for p, s in zip(self.parts, self._pslices)], axis=-1
        )


# ---------------------------------------------------------------------------
# Canonical instances (the variable-type manifolds of SURVEY.md §2.1)
# ---------------------------------------------------------------------------

T1 = TranslationGroup(1)
T2 = TranslationGroup(2)
T3 = TranslationGroup(3)
T4 = TranslationGroup(4)
SO2_ = SO2()
SO3_ = SO3()
SE2_ = SE2()
SE3_ = SE3()
