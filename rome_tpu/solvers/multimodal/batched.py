"""Compiled nonparametric solve — the MM-iSAM hot loop as batched XLA.

Rather than driving approxConv/Gibbs from Python per factor per variable per
sweep, this module lowers the whole belief-propagation sweep to two jitted
programs over the same structure-of-arrays batches the parametric path uses
(graph/lower.py):

1. **Messages**: for every (factor-batch, target-slot) pair, ONE vmapped
   kernel samples measurements for all factors of the type at once and
   solves residual=0 per (factor, particle) — the approxConv hot loop of
   SURVEY.md §3.2 as a dense (n_factors, N) grid.
2. **Products**: messages scatter into a padded (n_vars, K_max, N, pdim)
   tensor per variable type; a masked parallel-Gibbs KDE product (the
   prodAppxMSGibbsS analogue) runs vmapped over ALL variables of the type.

Sweeps are Jacobi (all messages from the previous sweep's beliefs) rather
than the reference's Gauss-Seidel clique order — the fixpoint is the same
and every kernel is batched. Factors the lowering can't batch (multihypo
data association, non-Gaussian measurement mixtures) fall back to the
per-factor approx_conv path and are spliced into the same product tensors.

Compiled programs are cached per graph structure: batch shapes + routing
are static; params/beliefs are traced, so growing measurements re-use the
compiled sweep as long as shapes match (see the shape-bucketing in
graph/lower.py:69-199 used by the incremental path).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from rome_tpu.graph.graph import FactorGraph
from rome_tpu.graph.lower import GraphArrays, lower
from rome_tpu.solvers.multimodal.convolve import _gn_solve_target, approx_conv
from rome_tpu.solvers.multimodal.kde import manifold_mean, silverman_bandwidth


def _batch_is_gaussian(fg: FactorGraph, batch) -> bool:
    """A batch is SoA-sampleable when every factor's measurement is (a stack
    of) Gaussians whose joint covariance matches params['sqrt_info']."""
    from rome_tpu.distributions import MvNormal, Normal

    if "sqrt_info" not in batch.params or "z" not in batch.params:
        return False
    zdim = batch.params["z"].shape[-1]
    if batch.params["sqrt_info"].shape[-2:] != (zdim, zdim):
        return False
    for lbl in batch.labels:
        f = fg.factors[lbl]
        if not all(isinstance(d, (Normal, MvNormal)) for d in f.dists):
            return False
    return True


@dataclass
class _Source:
    """One message stream: factor batch `b`, target slot `s`."""

    b: int
    s: int
    ttype: str                 # target variable type name
    dest_var: np.ndarray       # (n,) variable slot per factor row
    dest_k: np.ndarray         # (n,) position among the variable's messages


@dataclass
class BeliefPropagator:
    """Compiled belief-propagation sweeps bound to one graph structure."""

    ga: GraphArrays
    N: int
    sources: list
    fallback: list             # (factor_label, var_label, ttype, dest_var, dest_k)
    kmax: dict                 # type -> K_max
    has_msg: dict              # type -> (n,) bool — any incoming message
    msg_factor: dict = None    # type -> (V, K) str array of factor labels ('' = none)
    _sweep = None              # jitted when no fallback factors
    _messages = None
    _products = None
    _gs_routing = None         # Gauss-Seidel scan routing (lazy; False = n/a)
    _gs_fwd = None             # jitted up-only (filtering) pass
    _gs_all = None             # jitted all-messages (smoothing) pass


def _structure_signature(ga: GraphArrays, N: int, gibbs_sweeps: int):
    """Hashable key identifying everything the compiled sweep bakes in:
    batch shapes + index routing + free masks (params/beliefs are traced)."""
    parts = [N, gibbs_sweeps, tuple(ga.type_names)]
    for t in ga.type_names:
        parts.append((t, ga.counts[t], np.asarray(ga.free[t]).tobytes()))
    for b in ga.batches:
        parts.append(
            (
                b.ftype.name,
                b.n,
                b.vtypes,
                np.asarray(b.vslots).tobytes(),
                tuple(sorted(b.params)),
                tuple(b.labels),  # fallback routing references factor labels
            )
        )
    parts.append(tuple(ga.excluded_factors))
    return tuple(parts)


_PROPAGATOR_CACHE: dict = {}


def get_propagator(
    fg: FactorGraph, ga: GraphArrays, N: int, gibbs_sweeps: int = 3
) -> BeliefPropagator:
    """Structure-cached propagator: graphs with identical lowered structure
    (shapes + routing) share ONE compiled sweep — repeated solves and
    same-shape re-solves skip XLA entirely."""
    sig = _structure_signature(ga, N, gibbs_sweeps)
    bp = _PROPAGATOR_CACHE.get(sig)
    if bp is None:
        bp = build_propagator(fg, ga, N, gibbs_sweeps)
        _PROPAGATOR_CACHE[sig] = bp
    return bp


def build_propagator(
    fg: FactorGraph, ga: GraphArrays, N: int, gibbs_sweeps: int = 3
) -> BeliefPropagator:
    """Host-side routing: assign every factor→variable message a (variable,
    k) slot in the per-type padded product tensor."""
    counters = {t: np.zeros(ga.counts[t], dtype=np.int64) for t in ga.type_names}
    sources, fallback = [], []

    batchable = [
        (bi, b) for bi, b in enumerate(ga.batches) if _batch_is_gaussian(fg, b)
    ]
    unbatchable = [
        b for b in ga.batches if not _batch_is_gaussian(fg, b)
    ]
    for bi, b in batchable:
        vsl = np.asarray(b.vslots)
        for s, t in enumerate(b.vtypes):
            dest_var = vsl[:, s].astype(np.int64)
            dest_k = np.empty_like(dest_var)
            for i, v in enumerate(dest_var):
                dest_k[i] = counters[t][v]
                counters[t][v] += 1
            sources.append(_Source(bi, s, t, dest_var, dest_k))

    # fallback per-factor messages (multihypo / non-Gaussian batches)
    fb_factors = list(ga.excluded_factors) + [
        lbl for b in unbatchable for lbl in b.labels
    ]
    for lbl in fb_factors:
        f = fg.factors[lbl]
        for v in f.variables:
            rec = fg.variables[v]
            t = rec.vtype.name
            k = counters[t][rec.slot]
            counters[t][rec.slot] += 1
            fallback.append((lbl, v, t, rec.slot, int(k)))

    kmax = {t: max(1, int(c.max()) if len(c) else 1) for t, c in counters.items()}
    has_msg = {t: counters[t] > 0 for t in ga.type_names}

    # (var, k) -> factor label map so tree schedules can mask message
    # subsets (subtree-restricted upsolve messages)
    msg_factor = {
        t: np.full((ga.counts[t], kmax[t]), "", dtype=object)
        for t in ga.type_names
    }
    for src in sources:
        b = ga.batches[src.b]
        for i in range(b.n):
            lbl = b.labels[i] if i < len(b.labels) else None
            if lbl:
                msg_factor[src.ttype][src.dest_var[i], src.dest_k[i]] = lbl
    for lbl, _v, t, vslot, k in fallback:
        msg_factor[t][vslot, k] = lbl

    bp = BeliefPropagator(
        ga=ga, N=N, sources=sources, fallback=fallback, kmax=kmax,
        has_msg=has_msg, msg_factor=msg_factor,
    )
    bp._messages = jax.jit(_make_messages_fn(bp))
    bp._products = jax.jit(
        _make_products_fn(bp, gibbs_sweeps), static_argnames=()
    )
    if not bp.fallback:
        # the common case (no multihypo/mixture host-spliced messages):
        # messages + padding glue + Gibbs products as ONE jitted program —
        # the split path pays ~15 eager dispatches of glue per sweep
        messages_fn = _make_messages_fn(bp)
        products_fn = _make_products_fn(bp, gibbs_sweeps)

        def full_sweep(beliefs, params_all, key):
            msgs = messages_fn(beliefs, params_all, key)
            padded, masks = _pad_messages(bp, beliefs, msgs)
            var_masks = {
                t: jnp.ones((ga.counts[t],), ga.dtype) for t in padded
            }
            return products_fn(
                beliefs, padded, masks, var_masks, jax.random.fold_in(key, 99)
            )

        bp._sweep = jax.jit(full_sweep)
    return bp


def _pad_messages(bp: BeliefPropagator, beliefs, msgs):
    """Scatter per-source message streams into the per-type padded product
    tensors (pure jnp — traced inside the fused sweep)."""
    ga = bp.ga
    padded, masks = {}, {}
    for t in ga.type_names:
        if not bp.has_msg[t].any():
            continue
        man = ga.manifolds[t]
        pdim = beliefs[t].shape[-1]
        # padding rows hold the manifold identity (a VALID point): masked
        # densities still flow through local(); 0*finite=0, 0*nan=nan
        ident = jnp.asarray(man.identity(), dtype=ga.dtype)
        padded[t] = jnp.broadcast_to(
            ident, (ga.counts[t], bp.kmax[t], bp.N, pdim)
        )
        masks[t] = jnp.zeros((ga.counts[t], bp.kmax[t]), dtype=ga.dtype)
    for src, m in zip(bp.sources, msgs):
        t = src.ttype
        padded[t] = padded[t].at[src.dest_var, src.dest_k].set(m)
        masks[t] = masks[t].at[src.dest_var, src.dest_k].set(1.0)
    return padded, masks


def _sample_z(params, L, key, N):
    """(n, N, zdim) Gaussian measurement samples: z + L @ eps with
    L = inv(sqrt_info) (cov = L L^T, factors/base.py gaussian_params)."""
    z = params["z"]
    n, zdim = z.shape
    eps = jax.random.normal(key, (n, N, zdim), dtype=z.dtype)
    return z[:, None, :] + jnp.einsum("nij,nkj->nki", L, eps)


def _make_messages_fn(bp: BeliefPropagator):
    """One jitted program computing EVERY batchable message stream."""
    ga, N = bp.ga, bp.N

    def messages(beliefs, params_all, key):
        out = []
        for si, src in enumerate(bp.sources):
            b = ga.batches[src.b]
            params = params_all[src.b]
            mans = [ga.manifolds[vt] for vt in b.vtypes]
            tman = mans[src.s]
            kk = jax.random.fold_in(key, si)
            k_z, k_infl, k_null = jax.random.split(kk, 3)

            pts = [
                beliefs[vt][jnp.asarray(b.vslots)[:, k]]
                for k, vt in enumerate(b.vtypes)
            ]  # each (n, N, pdim)
            x0 = pts[src.s]
            # inflation noise around the current target belief
            bw = jax.vmap(lambda p: silverman_bandwidth(tman, p))(x0)  # (n, dof)
            scale = jnp.maximum(bw, 1e-2) * params["__inflation"][:, None]
            noise = (
                jax.random.normal(k_infl, (b.n, N, tman.dof), dtype=x0.dtype)
                * scale[:, None, :]
            )
            x0_infl = tman.normalize(tman.boxplus(x0, noise))

            z = _sample_z(params, params["__L"], k_z, N)
            init_fn = b.ftype.initializers.get(src.s)

            def one_particle(params_f, z_i, x0_i, other_i, _s=src.s,
                             _ft=b.ftype, _mans=mans, _init=init_fn):
                if _init is not None:
                    p = dict(params_f)
                    p["z"] = z_i
                    x_init = _init(p, list(other_i))
                else:
                    x_init = x0_i
                return _gn_solve_target(
                    _ft, _s, _mans, z_i, params_f, list(other_i), x_init
                )

            def one_factor(params_f, z_f, x0_f, other_f, _fn=one_particle):
                return jax.vmap(_fn, in_axes=(None, 0, 0, 0))(
                    params_f, z_f, x0_f, other_f
                )

            core = {
                k: v for k, v in params.items() if not k.startswith("__")
            }
            solved = jax.vmap(one_factor)(core, z, x0_infl, tuple(pts))
            # nullhypo: particle keeps its inflated prior with prob eta
            eta = params["__nullhypo"]
            keep = (
                jax.random.uniform(k_null, (b.n, N), dtype=x0.dtype)
                < eta[:, None]
            )
            solved = jnp.where(keep[..., None], x0_infl, solved)
            out.append(tman.normalize(solved))
        return out

    return messages


def _masked_gibbs(man, K, N, gibbs_sweeps):
    """Product of up to K kernel densities (msgs (K, N, pdim), mask (K,)) —
    the prodAppxMSGibbsS analogue with static shapes, vmapped per variable.

    The Gibbs label sweep is a lax.fori_loop over the flattened
    (sweep, density) index with stacked-array state, so the compiled program
    size is O(1) in K — a high-degree landmark (K ~ 20+) would otherwise
    unroll O(sweeps*K^2) blocks and blow up XLA/LLVM compile memory."""

    def product(key, msgs, mask):
        bw = jax.vmap(lambda p: silverman_bandwidth(man, p))(msgs)  # (K, dof)
        bw = jnp.maximum(bw, 1e-5)
        lam = mask[:, None] / (bw * bw)  # (K, dof) masked precisions

        k_init, k_sweep, k_out = jax.random.split(key, 3)
        labels = jax.random.randint(k_init, (K, N), 0, N)

        def selected(labels):
            # (K, N, pdim): each density's chosen kernel per output particle
            return jnp.take_along_axis(msgs, labels[:, :, None], axis=1)

        def estimate(sel, inc):
            """Precision-weighted tangent mean of the included selections,
            linearized at the first included density's selection."""
            ref_k = jnp.argmax(inc)  # first included (mask row 0 is real)
            ref = sel[ref_k]  # (N, pdim)
            c = man.local(jnp.broadcast_to(ref, sel.shape), sel)  # (K, N, dof)
            w = (inc[:, None] * lam)[:, None, :]  # (K, 1, dof)
            num = jnp.sum(w * c, axis=0)  # (N, dof)
            den = jnp.sum(inc[:, None] * lam, axis=0)  # (dof,)
            return ref, num / jnp.maximum(den, 1e-12), den

        from rome_tpu.ops.pairwise import pairwise_logw

        def body(i, labels):
            j = i % K
            sel = selected(labels)
            inc = mask.at[j].set(0.0)
            # exclude j from the ref choice too: argmax(inc) skips it
            ref, mu_c, prec = estimate(sel, inc)
            var = 1.0 / jnp.maximum(prec, 1e-12) + bw[j] * bw[j]
            logw = pairwise_logw(man, ref, mu_c, msgs[j], 1.0 / var)
            new_j = jax.random.categorical(
                jax.random.fold_in(k_sweep, i), logw, axis=-1
            )
            # keep padded densities' labels untouched (they're unused)
            return labels.at[j].set(
                jnp.where(mask[j] > 0, new_j, labels[j])
            )

        if K > 1:
            labels = jax.lax.fori_loop(0, gibbs_sweeps * K, body, labels)

        sel = selected(labels)
        ref, mu_c, prec = estimate(sel, mask)
        std = jnp.sqrt(1.0 / jnp.maximum(prec, 1e-12))
        eps = jax.random.normal(k_out, mu_c.shape, dtype=msgs.dtype) * std
        return man.normalize(man.boxplus(ref, mu_c + eps))

    return product


def _make_products_fn(bp: BeliefPropagator, gibbs_sweeps: int):
    ga, N = bp.ga, bp.N

    def products(beliefs, padded, masks, var_masks, key):
        new_beliefs = dict(beliefs)
        for ti, t in enumerate(ga.type_names):
            if t not in padded:
                continue
            man = ga.manifolds[t]
            K = bp.kmax[t]
            V = ga.counts[t]
            prod = _masked_gibbs(man, K, N, gibbs_sweeps)
            keys = jax.random.split(jax.random.fold_in(key, ti), V)
            out = jax.vmap(prod)(keys, padded[t], masks[t])
            # a variable updates only when it has >=1 unmasked message, is
            # free, and is selected by the schedule's var mask; otherwise its
            # belief passes through BIT-IDENTICAL (tree recycling contract)
            any_msg = jnp.max(masks[t], axis=1)
            upd = (
                any_msg
                * jnp.asarray(bp.has_msg[t], dtype=beliefs[t].dtype)
                * ga.free[t]
                * var_masks[t]
            )[:, None, None]
            new_beliefs[t] = jnp.where(upd > 0, out, beliefs[t])
        return new_beliefs

    return products


# ---------------- sequential (Gauss-Seidel) scan sweep ----------------------
# The reference's solveTree! is clique-by-clique belief propagation in
# elimination order (up) + back-substitution (down) — sequential, so
# loop-closure information crosses the whole graph in one round trip.
# The Jacobi sweep above moves information ONE hop per sweep (3 sweeps
# cannot undo 17 m of accumulated odometry drift on a 100-pose loop with
# the default init). This scan sweep is the chain-ordered
# flattening of the reference's up/down pass (Slam.jl:236-261 contract):
#
# - forward pass, ``up_only=True``: each variable's belief is rebuilt from
#   messages whose OTHER variables are all chronologically earlier — i.e.
#   filtering; corrections (loop closures via re-sighted landmarks) enter
#   the state the moment they are reached in the order.
# - backward pass, ``up_only=False`` over the reversed order: smoothing —
#   every variable re-products ALL messages with its successors already
#   corrected.
#
# One lax.scan over the global creation order; each step lax.switches on the
# variable's type and on each incoming message's source stream, so the whole
# pass is ONE compiled program with O(types * K * streams) traced kernels.


def _make_row_message(bp: BeliefPropagator, src: _Source):
    """Single-factor-row approxConv message (the scan-step analogue of one
    row of _make_messages_fn): (row r, beliefs, batch params, key) ->
    (N, pdim) particles for the target slot."""
    ga, N = bp.ga, bp.N
    b = ga.batches[src.b]
    mans = [ga.manifolds[vt] for vt in b.vtypes]
    tman = mans[src.s]
    vsl_host = np.asarray(b.vslots)
    init_fn = b.ftype.initializers.get(src.s)
    zdim = np.asarray(b.params["z"]).shape[-1]

    def msg(r, beliefs, params, key):
        row = {k: v[r] for k, v in params.items()}
        slots = jnp.asarray(vsl_host)[r]
        pts = [
            beliefs[vt][slots[k]] for k, vt in enumerate(b.vtypes)
        ]  # each (N, pdim)
        x0 = pts[src.s]
        k_z, k_infl, k_null = jax.random.split(key, 3)
        bw = silverman_bandwidth(tman, x0)
        scale = jnp.maximum(bw, 1e-2) * row["__inflation"]
        noise = (
            jax.random.normal(k_infl, (N, tman.dof), dtype=x0.dtype) * scale
        )
        x0_infl = tman.normalize(tman.boxplus(x0, noise))
        eps = jax.random.normal(k_z, (N, zdim), dtype=x0.dtype)
        z = row["z"][None, :] + eps @ row["__L"].T
        core = {k: v for k, v in row.items() if not k.startswith("__")}

        def one(z_i, x0_i, other_i):
            if init_fn is not None:
                p = dict(core)
                p["z"] = z_i
                x_init = init_fn(p, list(other_i))
            else:
                x_init = x0_i
            return _gn_solve_target(
                b.ftype, src.s, mans, z_i, core, list(other_i), x_init
            )

        solved = jax.vmap(one, in_axes=(0, 0, 0))(z, x0_infl, tuple(pts))
        keep = (
            jax.random.uniform(k_null, (N,), dtype=x0.dtype)
            < row["__nullhypo"]
        )
        return tman.normalize(jnp.where(keep[:, None], x0_infl, solved))

    return msg


def _build_gs_routing(bp: BeliefPropagator, fg: FactorGraph):
    """Host routing for the Gauss-Seidel scan: global chronological variable
    order + per-type (V, K) maps from product slot k to (source stream, row)
    plus the up-message mask. Returns None when the graph has fallback
    (multihypo / non-Gaussian) factors — those splice messages host-side and
    cannot ride inside one compiled scan."""
    ga = bp.ga
    if bp.fallback:
        return None
    if not bp.sources:
        return None
    tid_of = {t: i for i, t in enumerate(ga.type_names)}
    created = {lbl: i for i, lbl in enumerate(fg._var_order)}
    gidx = {t: np.zeros(ga.counts[t], np.int64) for t in ga.type_names}
    entries = []
    for t in ga.type_names:
        for slot, lbl in enumerate(ga.var_labels[t]):
            c = created.get(lbl)
            if c is None:
                return None
            gidx[t][slot] = c
            entries.append((c, tid_of[t], slot))
    entries.sort()
    order = np.array([(tid, slot) for _c, tid, slot in entries], np.int32)

    S = {t: [] for t in ga.type_names}      # per-type global source indices
    src_of = {
        t: np.full((ga.counts[t], bp.kmax[t]), -1, np.int32)
        for t in ga.type_names
    }
    row_of = {
        t: np.zeros((ga.counts[t], bp.kmax[t]), np.int32)
        for t in ga.type_names
    }
    up_of = {
        t: np.zeros((ga.counts[t], bp.kmax[t]), np.float32)
        for t in ga.type_names
    }
    for si_g, src in enumerate(bp.sources):
        t = src.ttype
        sidx = len(S[t])
        S[t].append(si_g)
        b = ga.batches[src.b]
        vsl = np.asarray(b.vslots)
        for i in range(b.n):
            v, k = int(src.dest_var[i]), int(src.dest_k[i])
            src_of[t][v, k] = sidx
            row_of[t][v, k] = i
            tg = gidx[t][v]
            up = all(
                gidx[b.vtypes[s2]][vsl[i, s2]] < tg
                for s2 in range(len(b.vtypes))
                if s2 != src.s
            )
            up_of[t][v, k] = 1.0 if up else 0.0
    return dict(order=order, S=S, src_of=src_of, row_of=row_of, up_of=up_of)


def _make_gs_sweep_fn(bp: BeliefPropagator, routing, gibbs_sweeps: int,
                      up_only: bool):
    """One Gauss-Seidel pass as a single traced function:
    gs(beliefs, params_all, order, key) with ``order`` a traced (V, 2)
    [type_id, slot] array (forward and reversed orders share the program)."""
    ga, N = bp.ga, bp.N
    type_names = list(ga.type_names)
    branch_fns = {
        t: [_make_row_message(bp, bp.sources[si]) for si in routing["S"][t]]
        for t in type_names
    }
    src_of = {t: jnp.asarray(routing["src_of"][t]) for t in type_names}
    row_of = {t: jnp.asarray(routing["row_of"][t]) for t in type_names}
    up_of = {t: jnp.asarray(routing["up_of"][t]) for t in type_names}

    def gs(beliefs, params_all, order, key):
        keys = jax.random.split(key, order.shape[0])

        def upd_type(t, v, beliefs, kk):
            man = ga.manifolds[t]
            K = bp.kmax[t]
            pdim = beliefs[t].shape[-1]
            fns = branch_fns[t]
            if not fns:
                return beliefs
            sw = [
                (lambda r, bel, k2, _f=f, _b=bp.sources[si].b: _f(
                    r, bel, params_all[_b], k2
                ))
                for f, si in zip(fns, routing["S"][t])
            ]
            msgs = []
            mvals = []
            for k in range(K):
                si = src_of[t][v, k]
                r = row_of[t][v, k]
                m = jax.lax.switch(
                    jnp.clip(si, 0, len(sw) - 1), sw, r, beliefs,
                    jax.random.fold_in(kk, k),
                )
                msgs.append(m)
                valid = (si >= 0).astype(beliefs[t].dtype)
                if up_only:
                    valid = valid * up_of[t][v, k]
                mvals.append(valid)
            msgs = jnp.stack(msgs)          # (K, N, pdim)
            mask = jnp.stack(mvals)         # (K,)
            prod = _masked_gibbs(man, K, N, gibbs_sweeps)
            bel_v = prod(jax.random.fold_in(kk, 10_001), msgs, mask)
            upd = (jnp.max(mask) > 0) & (ga.free[t][v] > 0)
            new_v = jnp.where(upd, bel_v, beliefs[t][v])
            return {**beliefs, t: beliefs[t].at[v].set(new_v)}

        def step(beliefs, xs):
            tv, kk = xs
            tid, v = tv[0], tv[1]
            branches = [
                (lambda vv, bel, k2, _t=t: upd_type(_t, vv, bel, k2))
                for t in type_names
            ]
            beliefs = jax.lax.switch(tid, branches, v, beliefs, kk)
            return beliefs, None

        beliefs, _ = jax.lax.scan(step, beliefs, (order, keys))
        return beliefs

    return gs


class BatchedNonparametricSolver:
    """solveTree!-capability driver over the compiled sweep kernels."""

    def __init__(
        self,
        fg: FactorGraph,
        solve_key: str = "default",
        N: Optional[int] = None,
        gibbs_sweeps: int = 3,
    ):
        self.fg = fg
        self.solve_key = solve_key
        self.N = N or fg.params.N
        self.ga = lower(fg, solve_key)
        self.bp = get_propagator(fg, self.ga, self.N, gibbs_sweeps)
        # traced per-batch params: core params + routing extras
        self._params_all = []
        for b in self.ga.batches:
            p = {k: jnp.asarray(v, self.ga.dtype) for k, v in b.params.items()}
            if "sqrt_info" in b.params:
                p["__L"] = jnp.linalg.inv(jnp.asarray(b.params["sqrt_info"], self.ga.dtype))
            p["__nullhypo"] = jnp.asarray(b.nullhypo, self.ga.dtype)
            p["__inflation"] = jnp.asarray(b.inflation, self.ga.dtype)
            self._params_all.append(p)

    # -- beliefs <-> dense arrays -------------------------------------------
    # Assembled IN NUMPY with one device transfer per type, not one
    # device op (row slicing / stacking) per variable.
    def gather_beliefs(self):
        out = {}
        for t in self.ga.type_names:
            man = self.ga.manifolds[t]
            pdim = man.point_dim
            buf = np.zeros((self.ga.counts[t], self.N, pdim), dtype=np.float64)
            for slot, lbl in enumerate(self.ga.var_labels[t]):
                rec = self.fg.variables[lbl]
                pts = rec.beliefs.get(self.solve_key)
                if pts is None:
                    p = rec.points.get(self.solve_key, rec.points.get("parametric"))
                    base = (
                        np.asarray(p, dtype=np.float64)
                        if p is not None
                        else np.asarray(man.identity(), dtype=np.float64)
                    )
                    buf[slot] = np.broadcast_to(base, (self.N, pdim))
                else:
                    pts = np.asarray(pts, dtype=np.float64)
                    if pts.shape[0] != self.N:
                        pts = pts[np.resize(np.arange(pts.shape[0]), self.N)]
                    buf[slot] = pts
            out[t] = jnp.asarray(buf, self.ga.dtype)
        return out

    def scatter_beliefs(self, beliefs):
        for t in self.ga.type_names:
            arr = np.asarray(beliefs[t])  # ONE device fetch for the type
            free = np.asarray(self.ga.free[t])
            for slot, lbl in enumerate(self.ga.var_labels[t]):
                if free[slot] == 0.0:
                    continue  # fixed-lag freeze: beliefs stay bit-identical
                rec = self.fg.variables[lbl]
                rec.beliefs[self.solve_key] = arr[slot]
                rec.initialized[self.solve_key] = True

    # -- one Jacobi sweep ----------------------------------------------------
    def sweep(self, beliefs, key, var_masks=None, msg_masks=None):
        """One belief-propagation sweep. ``var_masks``/``msg_masks``
        (optional {type: (V,)} / {type: (V, K)} float arrays) let a tree
        schedule update only selected frontal variables from a restricted
        (e.g. subtree-assigned) message set — traced, so masked calls reuse
        the same compiled programs."""
        bp, ga = self.bp, self.ga
        if (
            bp._sweep is not None
            and var_masks is None
            and msg_masks is None
        ):
            # fused single-program sweep (no eager glue dispatches)
            return bp._sweep(beliefs, self._params_all, key)
        msgs = bp._messages(beliefs, self._params_all, key)
        padded, masks = _pad_messages(bp, beliefs, msgs)

        # splice per-factor fallback messages (multihypo / mixtures)
        if bp.fallback:
            self.scatter_beliefs(beliefs)  # fallback reads fg records
            for i, (flbl, vlbl, t, vslot, k) in enumerate(bp.fallback):
                kk = jax.random.fold_in(key, 7_000_000 + i)
                m = approx_conv(
                    self.fg, flbl, vlbl, self.solve_key, key=kk, N=self.N
                )
                padded[t] = padded[t].at[vslot, k].set(m.astype(ga.dtype))
                masks[t] = masks[t].at[vslot, k].set(1.0)

        if msg_masks is not None:
            masks = {
                t: masks[t] * jnp.asarray(msg_masks[t], ga.dtype) for t in masks
            }
        if var_masks is None:
            var_masks = {
                t: jnp.ones((ga.counts[t],), ga.dtype) for t in padded
            }
        else:
            var_masks = {
                t: jnp.asarray(var_masks[t], ga.dtype) for t in padded
            }
        return bp._products(
            beliefs, padded, masks, var_masks, jax.random.fold_in(key, 99)
        )

    # -- Gauss-Seidel scan passes (the up/down analogue) ---------------------
    def _gs_programs(self):
        """Lazily built + structure-cached (on the shared propagator) GS
        scan programs; returns None when the graph can't ride in one scan
        (fallback factors present)."""
        bp = self.bp
        if bp._gs_routing is None:
            routing = _build_gs_routing(bp, self.fg)
            bp._gs_routing = routing if routing is not None else False
            if routing is not None:
                bp._gs_fwd = jax.jit(
                    _make_gs_sweep_fn(bp, routing, 3, up_only=True)
                )
                bp._gs_all = jax.jit(
                    _make_gs_sweep_fn(bp, routing, 3, up_only=False)
                )
        if bp._gs_routing is False:
            return None
        return bp._gs_routing, bp._gs_fwd, bp._gs_all

    def gs_pass(self, beliefs, key, up_only: bool = False,
                reverse: bool = False):
        """One sequential Gauss-Seidel sweep over the chronological variable
        order (reversed when ``reverse``); ``up_only`` restricts each
        variable's product to messages from chronologically earlier
        variables (filtering). Returns None if unsupported for this graph."""
        progs = self._gs_programs()
        if progs is None:
            return None
        routing, fwd, allp = progs
        order = routing["order"]
        if reverse:
            order = order[::-1].copy()
        fn = fwd if up_only else allp
        return fn(beliefs, self._params_all, jnp.asarray(order), key)

    def init_beliefs_from_points(self, key, sigma: float = None):
        """Fast batched belief seeding: one device program per type forms
        beliefs = point-estimate ⊞ kernel noise from the (cheap, host-side)
        graphinit point solution, replacing the per-factor approxConv init
        chain (whose O(V) eager dispatches dominate init wall time). The
        Gibbs sweeps that follow rebuild the local
        uncertainty structure; accuracy is gated by the same KL tests as
        the default init (tests/test_multimodal_kl.py)."""
        self.fg.init_all(self.solve_key)
        ga = self.ga
        sigma = float(
            sigma if sigma is not None else self.fg.params.inflation * 0.1
        )
        for ti, t in enumerate(ga.type_names):
            man = ga.manifolds[t]
            # read refreshed point estimates straight off the records (a
            # second full lower() here cost ~1-2 s of host time on beehive)
            buf = np.stack(
                [
                    np.asarray(
                        self.fg.variables[lbl].points.get(
                            self.solve_key,
                            np.asarray(man.identity(), dtype=np.float64),
                        ),
                        dtype=np.float64,
                    )
                    for lbl in ga.var_labels[t]
                ]
            )
            pts = jnp.asarray(buf, ga.dtype)  # (V, pdim)
            eps = (
                jax.random.normal(
                    jax.random.fold_in(key, ti), (ga.counts[t], self.N, man.dof)
                )
                * sigma
                * jnp.asarray(man.random_tangent_scale(), ga.dtype)
            )
            bel = man.normalize(man.boxplus(pts[:, None, :], eps))
            arr = np.asarray(bel)
            for slot, lbl in enumerate(ga.var_labels[t]):
                rec = self.fg.variables[lbl]
                rec.beliefs[self.solve_key] = arr[slot]
                rec.initialized[self.solve_key] = True

    def solve(self, sweeps: int = 3, key=None, init: bool = True):
        from rome_tpu.solvers.multimodal.solve import init_all_beliefs

        key = key if key is not None else jax.random.PRNGKey(2024)
        if init == "points":
            self.init_beliefs_from_points(jax.random.fold_in(key, 0))
        elif init:
            init_all_beliefs(
                self.fg, self.solve_key, N=self.N, key=jax.random.fold_in(key, 0)
            )
        beliefs = self.gather_beliefs()
        if init is True:
            # default init leaves accumulated odometry drift (approxConv
            # propagates noise forward); run sequential all-message
            # (smoothing) Gauss-Seidel passes so loop-closure corrections
            # cross the whole graph before the Jacobi refinement sweeps
            # (which only move info one hop each). Measured on beehive-30:
            # init 2.57 m -> 1.31 m after these passes (the up-only
            # filtering variant re-rolls odometry noise particle-wise and
            # DEGRADES good inits — gs_pass(up_only=True) stays available
            # but is not part of the default schedule).
            for p, rev in enumerate((False, True, False)):
                out = self.gs_pass(
                    beliefs, jax.random.fold_in(key, 500 + p), reverse=rev,
                )
                if out is None:
                    break
                beliefs = out
        for s in range(sweeps):
            beliefs = self.sweep(beliefs, jax.random.fold_in(key, s + 1))
        self.scatter_beliefs(beliefs)
        # surface means as point estimates for PPE queries
        for t in self.ga.type_names:
            man = self.ga.manifolds[t]
            mus = jax.vmap(lambda p: manifold_mean(man, p))(beliefs[t])
            mus = np.asarray(mus, dtype=np.float64)
            free = np.asarray(self.ga.free[t])
            for slot, lbl in enumerate(self.ga.var_labels[t]):
                if free[slot] == 0.0:
                    continue
                rec = self.fg.variables[lbl]
                rec.points[self.solve_key] = mus[slot]
                rec.initialized[self.solve_key] = True
        return self.fg
