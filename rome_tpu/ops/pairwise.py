"""Gibbs conditional scoring for the multimodal belief product.

The Gibbs kernel-label sampler (rome_tpu.solvers.multimodal.kde.gibbs_product
and the batched engine's ``_masked_gibbs``, the ``prodAppxMSGibbsS`` analogue
of KernelDensityEstimate.jl used at reference BayesTracker.jl:260-285) scores
every kernel of one density against the Gaussian product-of-others
conditional of every output particle:

    logw[n, i] = -0.5 * sum_d inv_var[d] * (local(ref[n], pts[i])[d] - mu[n, d])**2

``pairwise_logw`` is the plain form: ``man.local`` broadcast over an
(N, 1) x (1, Nj) pair of point sets. XLA fuses the local map, the
Mahalanobis score and the sum over dof into one loop, so the (N, Nj, dof)
tangent tensor is never written out.

A hand-written Triton kernel of the same score was measured against this on
an H100 and was no faster end to end, so XLA's fusion is the only path.
"""

from __future__ import annotations

import jax.numpy as jnp


def pairwise_logw(man, ref, mu, pts, inv_var):
    """Gibbs conditional log-weights, (N, Nj).

    ref (N, point_dim) reference points, mu (N, dof) product-conditional
    means in the tangent at ref, pts (Nj, point_dim) candidate kernel
    centres, inv_var (dof,) inverse variances."""
    C = man.local(ref[:, None, :], pts[None, :, :])  # (N, Nj, dof), fused
    return -0.5 * jnp.sum((C - mu[:, None, :]) ** 2 * inv_var, axis=-1)
