"""Neural-network mixture odometry factor (MixtureFluxPose2Pose2).

Reference: /root/reference/ext/RoMEFluxExt.jl:18-141 — a mixture of a Flux
MLP odometry predictor and a conventional MvNormal, with lazy ΔT caching and
velocity feature construction (calcVelocityInterPose2!), plus the
Pose2OdoNN_01 model builder (ext/services/Pose2OdoNN_01.jl:7-41). The legacy
alias FluxModelsPose2Pose2 maps to the same factor (RoMEFluxExt.jl:153-169).

Design: the network is a pure-JAX forward (weights live in the factor's
parameter arrays), sampled predictions for all particles come from ONE
batched forward pass, and the residual is the standard Pose2Pose2 kernel.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from rome_tpu.distributions import Distribution, MvNormal
from rome_tpu.factors.base import Factor, gaussian_params
from rome_tpu.factors.pose2 import POSE2POSE2


# ------------------------- Pose2OdoNN_01 model ------------------------------

def build_pose2_odo_nn_01(W1=None, b1=None, W2=None, b2=None, W3=None, b3=None):
    """buildPose2OdoNN_01_FromElements (Pose2OdoNN_01.jl:7-41): weights dict
    for the (25, 4) joystick+velocity window -> 2D odometry-delta MLP.

    Architecture: x(25,4) @ W1(4,8) + b1 -> relu -> maxpool(window 4 along
    time) -> flatten(48) -> dense(48->8, relu) -> dense(8->2) -> pad to 3.
    """
    return {
        "W1": np.zeros((4, 8)) if W1 is None else np.asarray(W1, np.float64),
        "b1": np.zeros(8) if b1 is None else np.asarray(b1, np.float64).reshape(-1),
        "W2": np.zeros((8, 48)) if W2 is None else np.asarray(W2, np.float64),
        "b2": np.zeros(8) if b2 is None else np.asarray(b2, np.float64).reshape(-1),
        "W3": np.zeros((2, 8)) if W3 is None else np.asarray(W3, np.float64),
        "b3": np.zeros(2) if b3 is None else np.asarray(b3, np.float64).reshape(-1),
    }


def build_pose2_odo_nn_01_from_weights(weights):
    """buildPose2OdoNN_01_FromWeights (Pose2OdoNN_01.jl:44-47): tensorflow
    get_weights layout."""
    w = [np.asarray(a, dtype=np.float64) for a in weights]
    return build_pose2_odo_nn_01(w[0], w[1], w[2].T, w[3], w[4].T, w[5])


def pose2_odo_nn_forward(nn, data):
    """One forward pass: data (25, 4) -> (3,) odometry delta (dtheta = 0)."""
    h = jnp.maximum(data @ nn["W1"] + nn["b1"], 0.0)          # (25, 8)
    h = h[:24].reshape(6, 4, 8).max(axis=1)                    # pool window 4
    h = h.reshape(-1)                                          # (48,)
    h = jnp.maximum(nn["W2"] @ h + nn["b2"], 0.0)              # (8,)
    out = nn["W3"] @ h + nn["b3"]                              # (2,)
    return jnp.concatenate([out, jnp.zeros_like(out[:1])])


class NNOdoPredictor(Distribution):
    """Measurement belief whose samples are network predictions over the
    joystick+velocity feature window (the fluxnn mixture component)."""

    def __init__(self, nn: dict, data, jitter: float = 1e-3):
        self.nn = {k: np.asarray(v, dtype=np.float64) for k, v in nn.items()}
        self.data = np.asarray(data, dtype=np.float64)
        self.jitter = float(jitter)
        self.dim = 3

    def _predict(self):
        nn = {k: jnp.asarray(v, dtype=jnp.float32) for k, v in self.nn.items()}
        return pose2_odo_nn_forward(nn, jnp.asarray(self.data, dtype=jnp.float32))

    def mean(self):
        return np.asarray(self._predict(), dtype=np.float64)

    def cov(self):
        return np.eye(3) * self.jitter**2

    def sample(self, key, n):
        pred = self._predict()
        eps = jax.random.normal(key, (n, 3)) * self.jitter
        return pred[None, :] + eps

    def __repr__(self):
        return "NNOdoPredictor(Pose2OdoNN_01)"


# --------------------------- the mixture factor -----------------------------

def calc_velocity_inter_pose2(factor: Factor, xi, xj):
    """calcVelocityInterPose2! (RoMEFluxExt.jl:81-103): fill the feature
    window's velocity columns (3:4) with the body-frame velocity implied by
    the two pose estimates and the cached ΔT."""
    xi = np.asarray(xi, dtype=np.float64)
    xj = np.asarray(xj, dtype=np.float64)
    DT = float(factor.params["DT"])
    nn_dist = factor.dists[0].components[0]
    d = (xj[:2] - xi[:2]) / max(DT, 1e-9)
    c, s = np.cos(xi[2]), np.sin(xi[2])
    body = np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1]])
    if not np.all(np.isfinite(body)):
        body = np.zeros(2)
    nn_dist.data[:, 2:4] = body
    return factor


def MixtureFluxPose2Pose2(
    fluxmodels=None,
    data=None,
    other_components=None,
    diversity=(0.5, 0.5),
    DT: float = 0.0,
    naive: Distribution = None,
) -> Factor:
    """Mixture of NN odometry prediction(s) and conventional belief(s)
    (RoMEFluxExt.jl:39-60). ``fluxmodels`` is one weights dict or a list of
    them (multiple prediction models average into one component here);
    ``data`` is the (25, 4) feature window."""
    from rome_tpu.distributions import Mixture

    nn = (
        fluxmodels[0]
        if isinstance(fluxmodels, (list, tuple)) and fluxmodels
        else (fluxmodels or build_pose2_odo_nn_01())
    )
    data = np.zeros((25, 4)) if data is None else np.asarray(data, np.float64)
    other = (
        list(other_components)
        if other_components is not None
        else [naive or MvNormal(np.zeros(3), np.eye(3))]
    )
    comps = [NNOdoPredictor(nn, data)] + other
    weights = np.asarray(diversity, dtype=np.float64)[: len(comps)]
    mix = Mixture(comps, weights)
    params = gaussian_params(mix.mean(), mix.cov())
    params["DT"] = np.float64(DT)
    return Factor(ftype=POSE2POSE2, variables=(), params=params, dists=(mix,))


# legacy alias (RoMEFluxExt.jl:153-169)
FluxModelsPose2Pose2 = MixtureFluxPose2Pose2
