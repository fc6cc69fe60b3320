"""Batched residual / Jacobian evaluation — THE hot loop of the framework.

Reference analogue: the per-factor residual functors invoked inside IIF's
approxConv and parametric solve (SURVEY.md §3.2-3.3). Here every factor type
linearizes as ONE vmapped jacfwd over its dense batch: gathers from per-type
variable arrays, small-dof forward-mode Jacobians on the VPU, scatter-adds
(segment sums) back into per-type tangent arrays. No indirection survives
into XLA — just gathers, batched small matmuls, and scatters.

Runtime/structure split: everything *shape-defining* (type names, counts,
batch sizes, manifolds) is static and closed over; everything *value-like*
(params, vslots index routing, weights, free masks) is threaded through as
traced arguments via ``runtime_state`` so one compiled solver serves every
graph with the same (padded) structure — the no-recompile contract the
incremental path relies on. ``lins`` entries are ``(batch, r0, Js, vslots)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rome_tpu.graph.lower import FactorBatch, GraphArrays


def runtime_state(ga: GraphArrays):
    """The traced half of a lowered graph: a pytree the compiled solver
    takes as an argument (params/vslots/weight/free), letting graphs that
    share a structure signature reuse one XLA program."""
    return {
        "params": tuple(
            {k: jnp.asarray(v) for k, v in b.params.items()} for b in ga.batches
        ),
        "vslots": tuple(jnp.asarray(b.vslots) for b in ga.batches),
        "weight": tuple(jnp.asarray(b.weight, ga.dtype) for b in ga.batches),
        "free": {t: jnp.asarray(ga.free[t], ga.dtype) for t in ga.type_names},
    }


def structure_signature(ga: GraphArrays):
    """Hashable key of everything a compiled solver bakes in (shapes +
    dtypes + manifold structure); runtime_state carries the rest."""
    return (
        str(ga.dtype),
        tuple((t, ga.counts[t]) for t in ga.type_names),
        tuple(
            (b.ftype.name, b.n, b.vtypes, tuple(sorted(b.params)))
            for b in ga.batches
        ),
    )


def _whitened_residual_fn(ga: GraphArrays, batch: FactorBatch):
    mans = [ga.manifolds[t] for t in batch.vtypes]
    resid = batch.ftype.residual

    def f(deltas, params, pts):
        newpts = tuple(m.boxplus(p, d) for m, p, d in zip(mans, pts, deltas))
        raw = resid(params, *newpts)
        return params["sqrt_info"] @ raw

    return f


def _gather_points(values, batch: FactorBatch, vslots):
    return tuple(
        values[t][vslots[:, k]] for k, t in enumerate(batch.vtypes)
    )


def batch_residual(ga: GraphArrays, batch: FactorBatch, values,
                   params=None, vslots=None, weight=None):
    """Whitened residuals at the current values: (n, zdim)."""
    params = batch.params if params is None else params
    vslots = batch.vslots if vslots is None else vslots
    weight = batch.weight if weight is None else weight
    f = _whitened_residual_fn(ga, batch)
    pts = _gather_points(values, batch, vslots)
    mans = [ga.manifolds[t] for t in batch.vtypes]
    zeros = tuple(
        jnp.zeros((batch.n, m.dof), dtype=ga.dtype) for m in mans
    )
    r = jax.vmap(f)(zeros, params, pts)
    return r * weight[:, None]


def batch_linearize(ga: GraphArrays, batch: FactorBatch, values,
                    params=None, vslots=None, weight=None, fused=True):
    """Whitened residuals and per-slot Jacobians wrt local tangent deltas.

    Returns (r0 (n, zdim), Js tuple of (n, zdim, dof_k)).
    """
    params = batch.params if params is None else params
    vslots = batch.vslots if vslots is None else vslots
    weight = batch.weight if weight is None else weight
    pts = _gather_points(values, batch, vslots)

    # hand-derived fused kernels for the hot factor families: closed-form
    # Jacobians over (n,) coordinate planes instead of 7 forward-mode
    # residual evaluations (see ops/fused_linearize.py derivation)
    from rome_tpu.ops.fused_linearize import FUSED_LINEARIZE

    kern = FUSED_LINEARIZE.get(batch.ftype.name) if fused else None
    if kern is not None:
        r0, Js = kern(params, *pts)
    else:
        f = _whitened_residual_fn(ga, batch)
        mans = [ga.manifolds[t] for t in batch.vtypes]
        zeros = tuple(
            jnp.zeros((batch.n, m.dof), dtype=ga.dtype) for m in mans
        )

        def f_and_jac(deltas, params, p):
            r = f(deltas, params, p)
            J = jax.jacfwd(f, argnums=0)(deltas, params, p)
            return r, J

        r0, Js = jax.vmap(f_and_jac)(zeros, params, pts)
    w = weight
    r0 = r0 * w[:, None]
    Js = tuple(J * w[:, None, None] for J in Js)
    return r0, Js


def linearize_all(ga: GraphArrays, values, rt=None):
    """Linearize every batch. Returns list of (batch, r0, Js, vslots)."""
    out = []
    for i, b in enumerate(ga.batches):
        if rt is None:
            r0, Js = batch_linearize(ga, b, values)
            out.append((b, r0, Js, b.vslots))
        else:
            r0, Js = batch_linearize(
                ga, b, values, rt["params"][i], rt["vslots"][i], rt["weight"][i]
            )
            out.append((b, r0, Js, rt["vslots"][i]))
    return out


def linearize_all_mixed_j(ga64, ga32, values, rt):
    """f64 residuals + f32 Jacobians, per batch.

    The Jacobian entries are ~4/5 of the linearize flops, and every
    downstream consumer of J in the ndchol path casts to f32 anyway
    (normal-equation assembly, the factorization, the loose-polish Hvp).
    Only the residual r feeds the f64-critical quantities (cost, gradient
    RHS), so r is evaluated at f64 and J at f32.
    """
    v32 = {t: jnp.asarray(v, jnp.float32) for t, v in values.items()}
    out = []
    for i, b in enumerate(ga64.batches):
        p, vs, w = rt["params"][i], rt["vslots"][i], rt["weight"][i]
        r64 = batch_residual(ga64, b, values, p, vs, w)
        p32 = {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}
        _r32, Js32 = batch_linearize(
            ga32, b, v32, p32, vs, jnp.asarray(w, jnp.float32)
        )
        out.append((b, r64, Js32, vs))
    return out


def cost_at(ga: GraphArrays, values, rt=None, accum_dtype=None):
    """0.5 * sum of squared whitened residuals (the LM objective).

    ``accum_dtype``: accumulate the sum of squares in this dtype (cheap —
    O(nnz) casts). An f32 accumulation over ~16k squared residuals carries
    ~1e-4 relative noise at M3500 cost scale, which is enough to keep a
    tight ftol from ever firing; the solvers accumulate in f64 when x64 is
    live. The returned scalar is cast back to ``ga.dtype``-compatible
    ``accum_dtype`` (caller casts further if needed)."""
    adt = accum_dtype or ga.dtype
    c = jnp.zeros((), dtype=adt)
    for i, b in enumerate(ga.batches):
        if rt is None:
            r = batch_residual(ga, b, values)
        else:
            r = batch_residual(
                ga, b, values, rt["params"][i], rt["vslots"][i], rt["weight"][i]
            )
        r = r.astype(adt)
        c = c + 0.5 * jnp.sum(r * r)
    return c


def _free_of(ga: GraphArrays, rt):
    return ga.free if rt is None else rt["free"]


def gradient_from_lins(ga: GraphArrays, lins, rt=None):
    """g = J^T r as a per-type tangent pytree, masked by free."""
    free = _free_of(ga, rt)
    g = ga.tangent_zeros()
    for batch, r0, Js, vslots in lins:
        for k, t in enumerate(batch.vtypes):
            contrib = jnp.einsum("nij,ni->nj", Js[k], r0)
            g[t] = g[t].at[vslots[:, k]].add(contrib)
    return {t: g[t] * free[t][:, None] for t in g}


def hvp_from_lins(ga: GraphArrays, lins, v, rt=None):
    """(J^T J) v as a tangent pytree (Gauss-Newton Hessian-vector product)."""
    free = _free_of(ga, rt)
    out = ga.tangent_zeros()
    for batch, _r0, Js, vslots in lins:
        u = jnp.zeros((batch.n, batch.ftype.zdim), dtype=ga.dtype)
        for k, t in enumerate(batch.vtypes):
            vk = v[t][vslots[:, k]] * free[t][vslots[:, k], None]
            u = u + jnp.einsum("nij,nj->ni", Js[k], vk)
        for k, t in enumerate(batch.vtypes):
            out[t] = out[t].at[vslots[:, k]].add(
                jnp.einsum("nij,ni->nj", Js[k], u)
            )
    return {t: out[t] * free[t][:, None] for t in out}


def block_diag_from_lins(ga: GraphArrays, lins):
    """Per-variable dof x dof diagonal blocks of J^T J (block-Jacobi)."""
    D = {
        t: jnp.zeros((ga.counts[t], ga.manifolds[t].dof, ga.manifolds[t].dof), dtype=ga.dtype)
        for t in ga.type_names
    }
    for batch, _r0, Js, vslots in lins:
        for k, t in enumerate(batch.vtypes):
            blk = jnp.einsum("nij,nik->njk", Js[k], Js[k])
            D[t] = D[t].at[vslots[:, k]].add(blk)
    return D


# ---------------------------------------------------------------------------
# dense assembly (small graphs + covariance recovery)
# ---------------------------------------------------------------------------

def tangent_offsets(ga: GraphArrays):
    """Global dense offsets: type -> base offset; total dof D."""
    base, off = {}, 0
    for t in ga.type_names:
        base[t] = off
        off += ga.counts[t] * ga.manifolds[t].dof
    return base, off


def flatten_tangent(ga: GraphArrays, v):
    return jnp.concatenate([v[t].reshape(-1) for t in ga.type_names])


def unflatten_tangent(ga: GraphArrays, x):
    out, off = {}, 0
    for t in ga.type_names:
        n, d = ga.counts[t], ga.manifolds[t].dof
        out[t] = x[off : off + n * d].reshape(n, d)
        off += n * d
    return out


def free_vector(ga: GraphArrays, rt=None):
    free = _free_of(ga, rt)
    return jnp.concatenate(
        [
            jnp.repeat(free[t], ga.manifolds[t].dof)
            for t in ga.type_names
        ]
    )


def normal_eq_entry_values(ga: GraphArrays, lins, dtype=None):
    """Flat vector of every J^T J entry contribution, in the fixed order the
    sparse symbolic phase indexes (sparse/symbolic.py entry_coords): per
    batch, per (k, l) slot pair, the (n, dk, dl) block row-major. The ndchol
    solver scatters these straight into multifrontal fronts — no dense H."""
    dtype = dtype or ga.dtype
    vals = []
    for batch, _r0, Js, _vslots in lins:
        Jd = tuple(J.astype(dtype) for J in Js)
        for k in range(len(batch.vtypes)):
            for l in range(len(batch.vtypes)):
                vals.append(
                    jnp.einsum("nij,nik->njk", Jd[k], Jd[l]).reshape(-1)
                )
    return jnp.concatenate(vals)


def dense_normal_eqs(ga: GraphArrays, lins, dtype=None, rt=None):
    """Assemble dense H = J^T J and g = J^T r over the global tangent.

    Frozen (free=0) dims get an identity row/col so H stays invertible and
    their update is exactly zero — this is how fixed-lag freezing
    (testFixedLagFG.jl bit-stability) is realized in the parametric path.

    All block contributions are flattened into ONE scatter-add per output
    (H and g): each sequential ``.at[].add`` may re-materialize the whole
    dense H (441 MB at M3500), so the 4+ per-batch slot-pair scatters go
    into a single call.

    ``dtype``: assembly precision. At M3500 scale cond(H) ~ 1e8, so an H
    *stored* in f32 is perturbed by eps32*cond ~ O(1) in its raw solution —
    callers either assemble in f64 (covariance recovery) or repair the f32
    solve with matrix-free f64 refinement (the dense32 solver).
    """
    dtype = dtype or ga.dtype
    base, D = tangent_offsets(ga)
    rows_all, cols_all, vals_all = [], [], []
    g_idx_all, g_val_all = [], []
    for batch, r0, Js, vslots in lins:
        r0 = r0.astype(dtype)
        Js = tuple(J.astype(dtype) for J in Js)
        offs = []
        for k, t in enumerate(batch.vtypes):
            d = ga.manifolds[t].dof
            o = base[t] + vslots[:, k] * d  # (n,)
            offs.append(o[:, None] + jnp.arange(d)[None, :])  # (n, d)
        for k in range(len(batch.vtypes)):
            g_idx_all.append(offs[k].reshape(-1))
            g_val_all.append(
                jnp.einsum("nij,ni->nj", Js[k], r0).reshape(-1)
            )
            for l in range(len(batch.vtypes)):
                blk = jnp.einsum("nij,nik->njk", Js[k], Js[l])
                dk, dl = blk.shape[1], blk.shape[2]
                rows_all.append(
                    jnp.broadcast_to(offs[k][:, :, None], (batch.n, dk, dl)).reshape(-1)
                )
                cols_all.append(
                    jnp.broadcast_to(offs[l][:, None, :], (batch.n, dk, dl)).reshape(-1)
                )
                vals_all.append(blk.reshape(-1))
    H = jnp.zeros((D, D), dtype=dtype)
    H = H.at[jnp.concatenate(rows_all), jnp.concatenate(cols_all)].add(
        jnp.concatenate(vals_all)
    )
    g = jnp.zeros((D,), dtype=dtype)
    g = g.at[jnp.concatenate(g_idx_all)].add(jnp.concatenate(g_val_all))
    f = free_vector(ga, rt).astype(dtype)
    H = H * (f[:, None] * f[None, :]) + jnp.diag(1.0 - f)
    g = g * f
    return H, g
