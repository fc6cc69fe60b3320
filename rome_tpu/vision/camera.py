"""Camera models and projection factors.

Reference: /root/reference/ext/RoMECameraModelsExt.jl (GenericProjection
residual :33-60, solveMultiviewLandmark! :77-167), ext/factors/
GenericProjection.jl:24-33, and src/legacy/CameraModel.jl:3-48 (legacy
pinhole intrinsic/extrinsic + cameraResidual!).

Design: the projection residual is a pure jnp kernel the solvers vmap;
the multiview triangulation is a vmapped multi-restart Gauss-Newton over
random initializations — all restarts solved in ONE batched device call
instead of the reference's serial Optim retry loop.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp

from rome_tpu.distributions import Distribution, MvNormal
from rome_tpu.factors.base import Factor, FactorType, gaussian_params, register_factor_type
from rome_tpu.manifolds import quat as Q
from rome_tpu.variables import Point3, Pose3


# ------------------------------ camera models -------------------------------

@dataclass
class CameraCalibration:
    """Pinhole calibration (CameraModels.CameraCalibration analogue)."""

    height: int = 480
    width: int = 640
    fx: float = 510.0
    fy: float = 510.0
    cx: float = 320.0
    cy: float = 240.0
    skew: float = 0.0
    kc: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)  # radial/tangential distortion

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [
                [self.fx, self.skew, self.cx],
                [0.0, self.fy, self.cy],
                [0.0, 0.0, 1.0],
            ]
        )

    @classmethod
    def from_dict(cls, d: dict):
        """convert(CameraCalibration, dict) analogue
        (RoMECameraModelsExt.jl:18-26)."""
        K = np.asarray(d["K"], dtype=np.float64).reshape(3, 3)
        return cls(
            height=int(d.get("height", 480)),
            width=int(d.get("width", 640)),
            fx=K[0, 0],
            fy=K[1, 1],
            cx=K[0, 2],
            cy=K[1, 2],
            skew=K[0, 1],
            kc=tuple(d.get("kc", (0.0,) * 5)),
        )

    def undistort_point(self, px):
        """Iterative radial/tangential undistortion (identity for kc=0)."""
        px = np.asarray(px, dtype=np.float64).reshape(2)
        if not any(self.kc):
            return px
        k1, k2, p1, p2, k3 = self.kc
        x = (px[0] - self.cx) / self.fx
        y = (px[1] - self.cy) / self.fy
        x0, y0 = x, y
        for _ in range(8):
            r2 = x * x + y * y
            ic = 1.0 / (1 + r2 * (k1 + r2 * (k2 + r2 * k3)))
            dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
            dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
            x = (x0 - dx) * ic
            y = (y0 - dy) * ic
        return np.array([x * self.fx + self.cx, y * self.fy + self.cy])


# legacy pinhole API (CameraModel.jl:3-48)

@dataclass
class CameraIntrinsic:
    K: np.ndarray = field(
        default_factory=lambda: np.array(
            [[510.0, 0.0, 320.0], [0.0, 510.0, 240.0], [0.0, 0.0, 1.0]]
        )
    )


@dataclass
class CameraExtrinsic:
    """World in camera frame (cRw, ct)."""

    R: np.ndarray = field(default_factory=lambda: np.eye(3))
    t: np.ndarray = field(default_factory=lambda: np.zeros(3))


@dataclass
class CameraModelFull:
    ci: CameraIntrinsic = field(default_factory=CameraIntrinsic)
    ce: CameraExtrinsic = field(default_factory=CameraExtrinsic)


def project(cm: CameraModelFull, pt) -> np.ndarray:
    """Legacy pinhole projection (CameraModel.jl:22-33)."""
    res = cm.ci.K @ (cm.ce.R @ np.asarray(pt, dtype=np.float64) + cm.ce.t)
    return res[:2] / res[2]


def camera_residual(z, ci: CameraIntrinsic, ce: CameraExtrinsic, pt) -> np.ndarray:
    """cameraResidual! (CameraModel.jl:37-48): z - project(pt)."""
    return np.asarray(z, dtype=np.float64)[:2] - project(
        CameraModelFull(ci, ce), pt
    )


# --------------------------- projection factor ------------------------------

def _project_kernel(Kmat, pose, point):
    """Pixel projection + depth of a world point seen from a Pose3 camera.

    pose = (t[3], q[4]) world-from-camera; c_P = R^T (w_P - t).
    """
    c_P = Q.qrotate(Q.qconj(pose[..., 3:7]), point - pose[..., :3])
    depth = c_P[..., 2]
    uvw = jnp.einsum("ij,...j->...i", Kmat, c_P)
    px = uvw[..., :2] / jnp.where(
        jnp.abs(uvw[..., 2:3]) < 1e-9, 1e-9, uvw[..., 2:3]
    )
    return px, depth


def _generic_projection_res(params, pose, point):
    # front-of-camera penalty + pixel error (RoMECameraModelsExt.jl:38-60)
    kappa = 0.001
    px, depth = _project_kernel(params["K"], pose, point)
    front = kappa * (jnp.abs(depth) - depth) ** 2
    return params["z"] - px + front[..., None]


GENERIC_PROJECTION = register_factor_type(
    FactorType(
        name="GenericProjection",
        variable_types=(Pose3, Point3),
        zdim=2,
        residual=_generic_projection_res,
        coord_types=("e", "e"),
        doc="Pinhole camera reprojection factor Pose3 -> Point3 with "
        "front-of-camera penalty (RoMECameraModelsExt.jl:33-60).",
    )
)


def GenericProjection(cam: CameraCalibration = None, Z: Distribution = None) -> Factor:
    cam = cam or CameraCalibration()
    Z = Z or MvNormal(np.zeros(2), np.eye(2) * 10.0)
    params = gaussian_params(Z.mean(), Z.cov())
    params["K"] = cam.K
    return Factor(ftype=GENERIC_PROJECTION, variables=(), params=params, dists=(Z,))


# ------------------------- multiview triangulation --------------------------

def solve_multiview_landmark(
    fg,
    lmlb: str,
    cam: CameraCalibration = None,
    retry: int = 100,
    iters: int = 50,
    solve_key: str = "parametric",
    seed: int = 0,
):
    """solveMultiviewLandmark! analogue (RoMECameraModelsExt.jl:77-167):
    triangulate a landmark from all its GenericProjection sightings.

    All ``retry`` random restarts run as ONE vmapped batched GN solve; the
    best depth-feasible minimizer wins. Writes the result into the landmark's
    solve data and returns it.
    """
    lmlb = str(lmlb)
    cam = cam or CameraCalibration()
    Kmat = jnp.asarray(cam.K, dtype=jnp.float32)

    poses, pixels, sqinfos = [], [], []
    for flb in fg.neighbors(lmlb):
        f = fg.factors[flb]
        if f.ftype.name != "GenericProjection":
            continue
        vl = [v for v in f.variables if v != lmlb][0]
        poses.append(np.asarray(fg.variables[vl].points[solve_key], np.float32))
        pixels.append(cam.undistort_point(f.params["z"]).astype(np.float32))
        sqinfos.append(np.asarray(f.params["sqrt_info"], np.float32))
    if not poses:
        raise ValueError(f"{lmlb} has no GenericProjection factors")
    poses = jnp.asarray(np.stack(poses))
    pixels = jnp.asarray(np.stack(pixels))

    def cost(w_P):
        def one(pose, pixel):
            px, depth = _project_kernel(Kmat, pose, w_P)
            kappa = 1000.0
            return kappa * (jnp.abs(depth) - depth) ** 2 + jnp.sum(
                (pixel - px) ** 2
            )

        return jnp.sum(jax.vmap(one)(poses, pixels))

    def depths(w_P):
        return jax.vmap(lambda pose: _project_kernel(Kmat, pose, w_P)[1])(poses)

    grad = jax.grad(cost)

    def gn_one(x0):
        # damped Newton with accept/reject per restart (the reference leans
        # on LBFGS + retry; undamped Newton diverges from wild inits)
        def body(_, carry):
            x, lam = carry
            g = grad(x)
            H = jax.hessian(cost)(x)
            scale = jnp.abs(jnp.trace(H)) / 3.0 + 1e-6
            Hd = H + lam * scale * jnp.eye(3)
            x_new = x - jnp.linalg.solve(Hd, g)
            better = cost(x_new) < cost(x)
            x = jnp.where(better, x_new, x)
            lam = jnp.where(better, jnp.maximum(lam * 0.5, 1e-9), lam * 4.0)
            return x, lam

        x, _ = jax.lax.fori_loop(
            0, iters, body, (x0, jnp.asarray(1e-2, dtype=x0.dtype))
        )
        return x, cost(x), jnp.min(depths(x))

    rec = fg.variables[lmlb]
    base = jnp.asarray(
        np.asarray(
            rec.points.get(solve_key, np.asarray(rec.manifold.identity())),
            np.float32,
        )
    )
    key = jax.random.PRNGKey(seed)
    inits = base + float(retry) * jax.random.normal(key, (retry, 3))
    xs, costs, mindepth = jax.vmap(gn_one)(inits)
    feasible = mindepth > 0
    penalized = jnp.where(feasible, costs, jnp.inf)
    best = jnp.argmin(penalized)
    if not bool(feasible[best]):
        raise ValueError("Unable to converge projection solution")
    w_P3 = np.asarray(xs[best], dtype=np.float64)
    fg.set_point(lmlb, w_P3, solve_key)
    return w_P3


# reference-style alias
solveMultiviewLandmark = solve_multiview_landmark
