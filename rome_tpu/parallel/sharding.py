"""Multi-device distributed solving via jax.sharding + shard_map.

Re-expression of the reference's parallelism (SURVEY.md §2.7):
where IIF dispatches clique solves to Julia worker processes, we partition
the *factor batches* across a device mesh; every device owns a slice of each
batch, computes its local residual/Jacobian products, and the global
gradient / Hessian-vector products are formed with ``psum`` over the mesh.
Variable state (small for SLAM graphs) is
replicated; this is the separator-marginal exchange of the north star in its
exact linear-algebra form (distributing J^T r and J^T J v term sums).

The entire damped-GN step, including the PCG loop, lives inside ONE
``shard_map`` region — PCG's dot products reduce with a single psum per
iteration, everything else is device-local.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rome_tpu.graph.lower import FactorBatch, GraphArrays


def pad_batches_for_mesh(ga: GraphArrays, n_shards: int) -> GraphArrays:
    """Pad every factor batch to a multiple of ``n_shards`` with weight-0
    rows (vslots 0 is always a valid gather index)."""
    new_batches = []
    for b in ga.batches:
        n = b.n
        pad = (-n) % n_shards
        if pad == 0:
            new_batches.append(b)
            continue
        vslots = jnp.concatenate(
            [b.vslots, jnp.zeros((pad, b.vslots.shape[1]), dtype=b.vslots.dtype)]
        )
        params = {
            k: jnp.concatenate([v, jnp.zeros((pad,) + v.shape[1:], dtype=v.dtype)])
            for k, v in b.params.items()
        }
        # padded rows need a usable sqrt_info for linearization; identity is
        # harmless because weight=0 zeroes the contribution.
        if "sqrt_info" in params:
            eye = jnp.eye(b.params["sqrt_info"].shape[-1], dtype=ga.dtype)
            params["sqrt_info"] = params["sqrt_info"].at[n:].set(eye)
        weight = jnp.concatenate([b.weight, jnp.zeros((pad,), dtype=ga.dtype)])
        new_batches.append(
            FactorBatch(
                ftype=b.ftype, n=n + pad, vtypes=b.vtypes, vslots=vslots,
                params=params, weight=weight, labels=list(b.labels),
            )
        )
    out = GraphArrays(
        type_names=ga.type_names, manifolds=ga.manifolds, counts=ga.counts,
        values0=ga.values0, free=ga.free, batches=new_batches,
        var_labels=ga.var_labels, dtype=ga.dtype,
    )
    return out


def _batch_arrays(ga: GraphArrays):
    """Pytree view of the batch numeric data (vslots/weight/params)."""
    return [
        dict(vslots=b.vslots, weight=b.weight, **b.params) for b in ga.batches
    ]


def make_sharded_gn_step(
    ga: GraphArrays,
    mesh: Mesh,
    axis: str = "f",
    pcg_iters: int = 100,
    pcg_tol: float = 1e-8,
):
    """Build a jitted distributed damped-GN step: (values, lam) ->
    (new_values, cost0, cost1, gnorm, accepted).

    Factor batches are sharded along the factor axis; variables replicated.
    """
    ga = pad_batches_for_mesh(ga, int(np.prod([mesh.shape[a] for a in mesh.axis_names])))
    statics = [(b.ftype, b.vtypes) for b in ga.batches]
    manifolds = ga.manifolds
    type_names = ga.type_names
    free = ga.free
    counts = ga.counts
    dtype = ga.dtype

    def tangent_zeros():
        return {
            t: jnp.zeros((counts[t], manifolds[t].dof), dtype=dtype)
            for t in type_names
        }

    def tdot(a, b):
        return sum(jnp.vdot(a[t], b[t]) for t in a)

    def linearize_local(values, barrs):
        """Local (shard) linearization of every batch."""
        lins = []
        for (ftype, vtypes), arr in zip(statics, barrs):
            mans = [manifolds[t] for t in vtypes]
            vslots = arr["vslots"]
            weight = arr["weight"]
            params = {k: v for k, v in arr.items() if k not in ("vslots", "weight")}
            pts = tuple(values[t][vslots[:, k]] for k, t in enumerate(vtypes))

            def f(deltas, prow, p, _resid=ftype.residual, _mans=mans):
                newpts = tuple(m.boxplus(pp, d) for m, pp, d in zip(_mans, p, deltas))
                return prow["sqrt_info"] @ _resid(prow, *newpts)

            zeros = tuple(jnp.zeros((vslots.shape[0], m.dof), dtype=dtype) for m in mans)

            def f_and_jac(deltas, prow, p, _f=f):
                return _f(deltas, prow, p), jax.jacfwd(_f, argnums=0)(deltas, prow, p)

            r0, Js = jax.vmap(f_and_jac)(zeros, params, pts)
            r0 = r0 * weight[:, None]
            Js = tuple(J * weight[:, None, None] for J in Js)
            lins.append((vtypes, vslots, r0, Js))
        return lins

    def _psum_f64(x):
        """Element-wise psum accumulated in f64 when x64 is live: the 8-way
        f32 reduction's order differs between intra-process and
        cross-process collective implementations, and the ~1e-7 relative
        perturbation is enough to drift the LM trajectory between
        topologies (same fix as parallel.varpart)."""
        if jax.config.jax_enable_x64:
            return jax.tree_util.tree_map(
                lambda v: jax.lax.psum(
                    v.astype(jnp.float64), axis
                ).astype(v.dtype),
                x,
            )
        return jax.lax.psum(x, axis)

    def grad_of(lins):
        g = tangent_zeros()
        for vtypes, vslots, r0, Js in lins:
            for k, t in enumerate(vtypes):
                g[t] = g[t].at[vslots[:, k]].add(jnp.einsum("nij,ni->nj", Js[k], r0))
        g = _psum_f64(g)
        return {t: g[t] * free[t][:, None] for t in g}

    def hvp_of(lins, v):
        out = tangent_zeros()
        for vtypes, vslots, r0, Js in lins:
            u = None
            for k, t in enumerate(vtypes):
                vk = v[t][vslots[:, k]] * free[t][vslots[:, k], None]
                uk = jnp.einsum("nij,nj->ni", Js[k], vk)
                u = uk if u is None else u + uk
            for k, t in enumerate(vtypes):
                out[t] = out[t].at[vslots[:, k]].add(jnp.einsum("nij,ni->nj", Js[k], u))
        out = _psum_f64(out)
        return {t: out[t] * free[t][:, None] for t in out}

    def block_diag_of(lins):
        D = {
            t: jnp.zeros((counts[t], manifolds[t].dof, manifolds[t].dof), dtype=dtype)
            for t in type_names
        }
        for vtypes, vslots, r0, Js in lins:
            for k, t in enumerate(vtypes):
                D[t] = D[t].at[vslots[:, k]].add(jnp.einsum("nij,nik->njk", Js[k], Js[k]))
        return _psum_f64(D)

    def cost_of(values, barrs):
        lins = linearize_local(values, barrs)
        # f64 accumulation + psum (when x64 is live): an f32 cross-device
        # reduction's order perturbs the cost at ~1e-7 relative, enough to
        # flip LM accept decisions between device/process topologies (see
        # parallel.varpart.cost_of — same fix, measured drift 11-vs-18 ->
        # 0 there)
        cdt = jnp.float64 if jax.config.jax_enable_x64 else ga.dtype
        c = sum(
            0.5 * jnp.sum(r0.astype(cdt) * r0.astype(cdt))
            for _vt, _vs, r0, _J in lins
        )
        return jax.lax.psum(c, axis).astype(ga.dtype), lins

    def boxplus_all(values, delta):
        out = {}
        for t in type_names:
            man = manifolds[t]
            out[t] = man.normalize(man.boxplus(values[t], delta[t] * free[t][:, None]))
        return out

    def step_shard_core(values, lam, barrs):
        cost0, lins = cost_of(values, barrs)
        g = grad_of(lins)
        D = block_diag_of(lins)

        Pinv = {}
        for t in type_names:
            dof = manifolds[t].dof
            eye = jnp.eye(dof, dtype=dtype)
            dd = jnp.maximum(jnp.diagonal(D[t], axis1=-2, axis2=-1), 1e-8)
            blk = D[t] + lam * dd[..., None] * eye + 1e-8 * eye
            fm = free[t][:, None, None]
            blk = blk * fm + eye * (1.0 - fm)
            Pinv[t] = jnp.linalg.inv(blk)

        def precond(r):
            return {
                t: jnp.einsum("nij,nj->ni", Pinv[t], r[t]) * free[t][:, None]
                for t in r
            }

        def hvp_damped(v):
            out = hvp_of(lins, v)
            for t in out:
                dd = jnp.maximum(jnp.diagonal(D[t], axis1=-2, axis2=-1), 1e-8)
                out[t] = (out[t] + lam * dd * v[t]) * free[t][:, None]
            return out

        b = {t: -g[t] for t in g}
        x0 = {t: jnp.zeros_like(b[t]) for t in b}
        z0 = precond(b)
        bnorm = jnp.sqrt(tdot(b, b)) + 1e-30

        def cond(s):
            x, r, z, p, rz, k = s
            return jnp.logical_and(k < pcg_iters, jnp.sqrt(tdot(r, r)) > pcg_tol * bnorm)

        def body(s):
            x, r, z, p, rz, k = s
            Hp = hvp_damped(p)
            alpha = rz / jnp.maximum(tdot(p, Hp), 1e-30)
            x = {t: x[t] + alpha * p[t] for t in x}
            r = {t: r[t] - alpha * Hp[t] for t in r}
            z = precond(r)
            rz2 = tdot(r, z)
            beta = rz2 / jnp.maximum(rz, 1e-30)
            p = {t: z[t] + beta * p[t] for t in p}
            return (x, r, z, p, rz2, k + 1)

        delta, *_ = jax.lax.while_loop(
            cond, body, (x0, b, z0, z0, tdot(b, z0), jnp.zeros((), jnp.int32))
        )

        trial = boxplus_all(values, delta)
        cost1, _ = cost_of(trial, barrs)
        ok = jnp.logical_and(jnp.isfinite(cost1), cost1 < cost0)
        new_values = jax.tree_util.tree_map(
            lambda a, b_: jnp.where(ok, a, b_), trial, values
        )
        gnorm = jnp.sqrt(tdot(g, g))
        dnorm = jnp.sqrt(tdot(delta, delta))
        return new_values, cost0, cost1, gnorm, dnorm, ok

    def step_shard(values, lam, barrs):
        new_values, cost0, cost1, gnorm, _dn, ok = step_shard_core(
            values, lam, barrs
        )
        return new_values, cost0, cost1, gnorm, ok

    def solve_shard(values, lam, barrs):
        """FUSED distributed LM: the whole solve is one XLA program per
        device — lax.while_loop over LM iterations with the Marquardt
        schedule and convergence logic in-graph; the only collectives are
        the psums inside the step. No host sync per iteration (the round-1
        host loop cost one device round-trip per LM step)."""
        max_iters = 100

        def cond(state):
            _v, _lam, it, _cp, _nr, code = state
            return jnp.logical_and(it < max_iters, code == 0)

        def body(state):
            values, lam, it, cost_prev, n_rej, code = state
            new_values, cost0, cost1, gnorm, dnorm, ok = step_shard_core(
                values, lam, barrs
            )
            new_lam = jnp.where(
                ok,
                jnp.maximum(lam * 0.25, 1e-12),
                jnp.minimum(lam * 8.0, 1e8),
            )
            ftol_hit = jnp.abs(cost_prev - cost1) <= 1e-8 * jnp.maximum(
                1.0, jnp.abs(cost_prev)
            )
            acc_code = jnp.where(
                gnorm < 1e-8,
                1,
                jnp.where(
                    jnp.logical_and(jnp.isfinite(cost_prev), ftol_hit), 3, 0
                ),
            )
            n_rej_new = jnp.where(ok, 0, n_rej + 1)
            # rejected-branch convergence. At an f32 cost plateau whether a
            # trial "improves" is an ulp coin-flip that depends on the psum
            # reduction order, so the SAME solve can read accept (ftol) on
            # one device count and reject-cascade ("stalled") on another.
            # Fix: a REJECTED step whose
            # cost is within ftol of the plateau is the same convergence
            # signal as an accepted one — fire code 3 on it. Rejections far
            # from convergence overshoot by >> ftol and are unaffected;
            # still, a SINGLE symmetric overshoot (undamped step landing at
            # the mirror point of a quadratic valley, cost1 ~ cost_prev with
            # |g| large) must not read as converged, so require two
            # consecutive near-plateau rejections — the damped retry after a
            # true overshoot descends and resets the counter.
            rej_ftol = jnp.logical_and(
                n_rej_new >= 2,
                jnp.logical_and(
                    jnp.isfinite(cost_prev),
                    jnp.logical_and(
                        jnp.isfinite(cost1),
                        jnp.abs(cost_prev - cost1)
                        <= 1e-8 * jnp.maximum(1.0, jnp.abs(cost_prev)),
                    ),
                ),
            )
            rej_code = jnp.where(
                rej_ftol,
                3,
                jnp.where(dnorm < 1e-4, 4, jnp.where(n_rej_new >= 8, 5, 0)),
            )
            new_code = jnp.where(ok, acc_code, rej_code).astype(jnp.int32)
            new_cost_prev = jnp.where(ok, cost1, cost_prev)
            return (new_values, new_lam, it + 1, new_cost_prev,
                    n_rej_new, new_code)

        init = (
            values, lam, jnp.zeros((), jnp.int32),
            jnp.asarray(jnp.inf, dtype=dtype),
            jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
        )
        values, lam, it, cost_prev, _nr, code = jax.lax.while_loop(
            cond, body, init
        )
        final_cost, _ = cost_of(values, barrs)
        return values, it, code, final_cost

    barrs = _batch_arrays(ga)
    vspec = {t: P() for t in type_names}
    bspec = [{k: P(axis) for k in d} for d in barrs]

    from jax import shard_map

    sharded = shard_map(
        step_shard,
        mesh=mesh,
        in_specs=(vspec, P(), bspec),
        out_specs=(vspec, P(), P(), P(), P()),
        check_vma=False,
    )
    jitted = jax.jit(sharded)
    solve_sharded = jax.jit(
        shard_map(
            solve_shard,
            mesh=mesh,
            in_specs=(vspec, P(), bspec),
            out_specs=(vspec, P(), P(), P()),
            check_vma=False,
        )
    )

    # device-put the batch arrays with the factor-axis sharding so the jit
    # does not re-shard on every call
    sharding = [
        {k: NamedSharding(mesh, P(axis)) for k in d} for d in barrs
    ]
    barrs = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, s), barrs, sharding,
        is_leaf=lambda x: isinstance(x, jnp.ndarray),
    )

    def step(values, lam):
        return jitted(values, lam, barrs)

    def solve(values, lam):
        return solve_sharded(values, lam, barrs)

    step.solve = solve
    return step, ga


def solve_distributed(ga: GraphArrays, mesh: Mesh, max_iters: int = 100,
                      lam0: float = 1e-4, values=None, **kw):
    """Distributed LM solve: the FUSED on-device loop (one XLA dispatch for
    the entire solve; psum collectives only). Returns (values, stats dict)."""
    step, ga = make_sharded_gn_step(ga, mesh, **kw)
    values = values if values is not None else ga.values0
    lam = jnp.asarray(lam0, dtype=ga.dtype)
    values, it, code, final_cost = step.solve(values, lam)
    stats = dict(
        iterations=int(it),
        reason={
            0: "max_iters", 1: "gtol", 3: "ftol", 4: "step_floor",
            5: "stalled",
        }.get(int(code), "?"),
        converged=int(code) in (1, 3, 4)
        or (int(code) == 5 and int(it) > 3),
        final_cost=float(final_cost),
    )
    return values, stats
