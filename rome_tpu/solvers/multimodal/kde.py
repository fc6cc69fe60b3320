"""Manifold kernel-density estimation + belief products.

Re-designs the reference's AMP/KDE layer (ApproxManifoldProducts
ManifoldKernelDensity / manikde!, KernelDensityEstimate prodAppxMSGibbsS —
SURVEY.md §0 table) as batched JAX kernels:

- a belief is a dense particle array ``(N, point_dim)`` + per-dof bandwidth;
- kernel evaluations between particle sets are N x N batched ops (vmapped
  manifold ``local`` + Gaussian kernels);
- the multi-density product is a parallel Gibbs label sampler over kernel
  selections (the prodAppxMSGibbsS analogue), fully vectorized over output
  particles — no sequential per-sample loop.

Circular dims are handled through the manifold ``local`` map (angle wrap).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from rome_tpu.manifolds.base import Manifold
from rome_tpu.ops.pairwise import pairwise_logw


# Jitted-kernel cache keyed by the manifold's STRUCTURAL signature (type,
# name, dof, point_dim) — not id(): dynamically constructed ProductGroup
# manifolds (custom variable types built per graph) would otherwise pin a
# fresh compiled program per instance for the process lifetime. Structural
# equality is sound because a manifold's kernels are fully determined by its
# structure (ProductGroup names encode their parts). The eager fori_loop
# versions re-traced AND re-compiled a throwaway scan per call — graph init
# on a 100-pose beehive spent 35 s in XLA compiles on them.
_KDE_JIT_CACHE: dict = {}
_KDE_TOKEN = 0  # monotonic token source for non-core manifold signatures


def _man_signature(man: Manifold):
    from rome_tpu.manifolds.base import ProductGroup

    # ProductGroup: recurse over parts and IGNORE the display name — a
    # user-supplied name override must not let two structurally different
    # products share kernels compiled for the wrong manifold. Unknown
    # parameterized Manifold subclasses fall back to id() (correct, merely
    # uncached across instances).
    if isinstance(man, ProductGroup):
        return ("ProductGroup",) + tuple(
            _man_signature(p) for p in man.parts
        )
    base = (type(man).__name__, man.name, man.dof, man.point_dim)
    core = type(man).__module__.startswith("rome_tpu.manifolds")
    if core:
        return base
    # non-core subclasses: a per-instance monotonic token, NOT id() —
    # CPython reuses ids after GC, which would alias cache entries of a
    # dead manifold onto a structurally different new one
    tok = getattr(man, "_kde_cache_token", None)
    if tok is None:
        global _KDE_TOKEN
        tok = _KDE_TOKEN = _KDE_TOKEN + 1
        try:
            man._kde_cache_token = tok
        except Exception:
            pass  # frozen instance: uncached (correct, just slower)
    return base + (tok,)


def _cached_kernel(man: Manifold, name: str, build):
    key = (_man_signature(man), name)
    fn = _KDE_JIT_CACHE.get(key)
    if fn is None:
        fn = jax.jit(build(man))
        _KDE_JIT_CACHE[key] = fn
    return fn


def silverman_bandwidth(man: Manifold, points) -> jnp.ndarray:
    """Per-dof rule-of-thumb bandwidth from tangent spread about the mean.

    Traceable (pure jnp); when called eagerly it dispatches through a cached
    jit so repeated per-factor calls share one compiled program.
    """
    if isinstance(points, jax.core.Tracer):
        return _silverman_impl(man, points)
    return _cached_kernel(
        man, "silverman", lambda m: lambda p: _silverman_impl(m, p)
    )(points)


def _silverman_impl(man: Manifold, points) -> jnp.ndarray:
    n = points.shape[0]
    mu = _mean_impl(man, points, 3)
    loc = man.local(mu[None, :], points)  # (N, dof)
    std = jnp.std(loc, axis=0) + 1e-6
    return std * (4.0 / (loc.shape[-1] + 2.0) / max(n, 2)) ** (1.0 / (loc.shape[-1] + 4.0))


def manifold_mean(man: Manifold, points, iters: int = 3) -> jnp.ndarray:
    """Karcher-style mean: iterate mu <- mu ⊕ mean(local(mu, p))."""
    if isinstance(points, jax.core.Tracer):
        return _mean_impl(man, points, iters)
    return _cached_kernel(
        man, ("mean", iters), lambda m: lambda p: _mean_impl(m, p, iters)
    )(points)


def _mean_impl(man: Manifold, points, iters: int) -> jnp.ndarray:
    mu = points[0]

    def body(_, mu):
        d = man.local(mu[None, :], points)
        return man.normalize(man.boxplus(mu, jnp.mean(d, axis=0)))

    return jax.lax.fori_loop(0, iters, body, mu)


@dataclass
class ManifoldKernelDensity:
    """manikde! analogue: particle kernel density on a manifold."""

    manifold: Manifold
    points: jnp.ndarray          # (N, point_dim)
    bandwidth: jnp.ndarray       # (dof,) kernel std-devs

    @classmethod
    def from_points(cls, man: Manifold, points, bandwidth=None):
        points = jnp.asarray(points)
        bw = (
            jnp.asarray(bandwidth)
            if bandwidth is not None
            else silverman_bandwidth(man, points)
        )
        return cls(man, points, jnp.maximum(bw, 1e-5))

    @property
    def N(self):
        return self.points.shape[0]

    def mean(self):
        return manifold_mean(self.manifold, self.points)

    def logpdf(self, x):
        """Log density at point(s) x (…, point_dim)."""
        man, bw = self.manifold, self.bandwidth

        def one(xp):
            d = man.local(self.points, jnp.broadcast_to(xp, self.points.shape))
            q = -0.5 * jnp.sum((d / bw) ** 2, axis=-1)
            logz = jnp.sum(jnp.log(bw)) + 0.5 * d.shape[-1] * jnp.log(2 * jnp.pi)
            return jax.scipy.special.logsumexp(q) - jnp.log(self.N) - logz

        if x.ndim == 1:
            return one(x)
        return jax.vmap(one)(x)

    def sample(self, key, n: int):
        """Draw n samples: pick kernels uniformly, perturb in tangent."""
        k1, k2 = jax.random.split(key)
        idx = jax.random.randint(k1, (n,), 0, self.N)
        eps = jax.random.normal(k2, (n, self.bandwidth.shape[0])) * self.bandwidth
        base = self.points[idx]
        return self.manifold.normalize(self.manifold.boxplus(base, eps))

    def max_point(self):
        """getKDEMax analogue: particle with highest density."""
        lp = self.logpdf(self.points)
        return self.points[jnp.argmax(lp)]


def gibbs_product(
    key,
    densities,
    n_out: int = None,
    sweeps: int = 3,
):
    """Product of kernel densities on a shared manifold — the
    ``prodAppxMSGibbsS`` analogue (BayesTracker.jl:260-285 usage).

    Parallel Gibbs over kernel-label assignments: every output particle
    holds one selected kernel per input density; sweeps resample each
    density's label from the Gaussian-product conditional given the other
    selections; the output particle is the tangent-space Gaussian-product
    mean of its selected kernels (plus product-covariance noise).
    """
    man = densities[0].manifold
    N = n_out or densities[0].N
    m = len(densities)
    if m == 1:
        return densities[0].sample(key, N)

    keys = jax.random.split(key, m * (sweeps + 1) + 2)

    # initial labels: uniform per density
    labels = [
        jax.random.randint(keys[j], (N,), 0, densities[j].N) for j in range(m)
    ]

    lam = [1.0 / (d.bandwidth**2) for d in densities]  # (dof,) precisions

    def selected_means(labels):
        return [d.points[l] for d, l in zip(densities, labels)]  # list (N, pdim)

    def product_estimate(sel, exclude=None):
        """Tangent-space precision-weighted mean of selected kernels,
        linearized at the first included selection. Returns (ref_pt (N,pdim),
        mean_coords (N,dof), total precision (dof,))."""
        include = [j for j in range(m) if j != exclude]
        ref = sel[include[0]]
        num = jnp.zeros((N, densities[0].bandwidth.shape[0]))
        den = jnp.zeros((densities[0].bandwidth.shape[0],))
        for j in include:
            c = man.local(ref, sel[j])  # (N, dof)
            num = num + lam[j] * c
            den = den + lam[j]
        return ref, num / den, den

    ki = m
    for s in range(sweeps):
        for j in range(m):
            sel = selected_means(labels)
            ref, mu_c, prec = product_estimate(sel, exclude=j)
            # conditional weight of every kernel i of density j against the
            # product-of-others Gaussian: N(local(ref, p_i); mu_c, 1/prec + bw_j^2)
            var = 1.0 / prec + densities[j].bandwidth**2  # (dof,)
            logw = pairwise_logw(man, ref, mu_c, densities[j].points, 1.0 / var)
            labels[j] = jax.random.categorical(keys[ki], logw, axis=-1)
            ki += 1

    # final product sample
    sel = selected_means(labels)
    ref, mu_c, prec = product_estimate(sel)
    std = jnp.sqrt(1.0 / prec)
    eps = jax.random.normal(keys[-1], mu_c.shape) * std
    out = man.boxplus(ref, mu_c + eps)
    return man.normalize(out)
