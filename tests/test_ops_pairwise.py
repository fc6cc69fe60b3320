"""Gibbs conditional scoring (ops/pairwise.py) vs the vmapped reference.

The sampler consumes these log-weights directly (reference hot loop: KDE
prodAppxMSGibbsS, BayesTracker.jl usage), so the scoring path must match the
vmapped ``man.local`` form to f32 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rome_tpu.manifolds.base import SE2, SO2, ProductGroup, TranslationGroup
from rome_tpu.ops.pairwise import pairwise_logw
from rome_tpu.solvers.multimodal.kde import ManifoldKernelDensity, gibbs_product

MANIFOLDS = {
    "se2": SE2(),
    "point2": TranslationGroup(2),
    "point3": TranslationGroup(3),
    "circle_x_r": ProductGroup([SO2(), TranslationGroup(1)], name="BearingRange"),
}


def _generic_logw(man, ref, mu, pts, var):
    def coords_for(ref_k):
        return man.local(jnp.broadcast_to(ref_k, pts.shape), pts)

    C = jax.vmap(coords_for)(ref)
    return -0.5 * jnp.sum((C - mu[:, None, :]) ** 2 / var, axis=-1)


def _points(man, n, rng):
    """n points, the circular coordinates within 1e-3 of the +-pi wrap for
    a third of them."""
    p = rng.normal(size=(n, man.point_dim)) * 3.0
    for d, c in enumerate(man.coord_types):
        if c == "c":
            p[:, d] = rng.uniform(-np.pi, np.pi, n)
            near = rng.random(n) < 1 / 3
            p[near, d] = np.sign(rng.normal(size=near.sum())) * (
                np.pi - rng.uniform(1e-4, 1e-3, near.sum())
            )
    return jnp.asarray(p, jnp.float32)


def _case(man, N, Nj, rng):
    ref, pts = _points(man, N, rng), _points(man, Nj, rng)
    mu = jnp.asarray(rng.normal(size=(N, man.dof)) * 0.5, jnp.float32)
    var = jnp.asarray(rng.uniform(0.1, 1.0, man.dof), jnp.float32)
    return ref, mu, pts, var


def _close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("N", [1, 37, 257])
@pytest.mark.parametrize("name", sorted(MANIFOLDS))
def test_scoring_matches_vmapped_local(name, N, rng):
    man = MANIFOLDS[name]
    Nj = N + 3  # N != Nj
    ref, mu, pts, var = _case(man, N, Nj, rng)
    got = pairwise_logw(man, ref, mu, pts, 1.0 / var)
    assert got.shape == (N, Nj)
    _close(got, _generic_logw(man, ref, mu, pts, var))


def test_se2_kernel_matches_generic(rng):
    """SE(2) scoring off any tile boundary, angles near the wrap included."""
    man = SE2()
    ref, mu, pts, var = _case(man, 37, 101, rng)
    _close(pairwise_logw(man, ref, mu, pts, 1.0 / var),
           _generic_logw(man, ref, mu, pts, var))


def test_euclid_kernel_matches_generic_with_wrap(rng):
    """BearingRange-style Circle x R: only the circular dim wraps."""
    man = MANIFOLDS["circle_x_r"]
    ref, mu, pts, var = _case(man, 50, 64, rng)
    _close(pairwise_logw(man, ref, mu, pts, 1.0 / var),
           _generic_logw(man, ref, mu, pts, var))


@pytest.mark.parametrize("man_points", ["se2", "point2"])
def test_gibbs_product_fused_statistics(man_points, rng):
    """The product must still contract two offset beliefs to the
    precision-weighted mean."""
    if man_points == "se2":
        man = SE2()
        mk = lambda c: np.c_[rng.normal(c, 0.1, (150, 2)), rng.normal(0, 0.05, 150)]
        a, b = mk(1.0), mk(1.4)
    else:
        man = TranslationGroup(2)
        a = rng.normal(1.0, 0.1, (150, 2))
        b = rng.normal(1.4, 0.1, (150, 2))
    da = ManifoldKernelDensity.from_points(man, a)
    db = ManifoldKernelDensity.from_points(man, b)
    out = gibbs_product(jax.random.PRNGKey(0), [da, db], n_out=150)
    m = np.asarray(out).mean(axis=0)
    assert abs(m[0] - 1.2) < 0.1 and abs(m[1] - 1.2) < 0.1
