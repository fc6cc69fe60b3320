"""Batched Levenberg-Marquardt / Gauss-Newton over factor batches.

Reference contract: IIF.solveGraphParametric! (SURVEY.md §3.3) — minimize
sum r(x)^T inv(S) r(x) over the product manifold of all variables. Here the
normal equations are solved either densely (blocked Cholesky — small graphs,
covariance recovery) or matrix-free via preconditioned CG with a block-Jacobi
preconditioner (large graphs; all gathers/scatters + small batched
matmuls). One LM iteration is a single jitted XLA program, traced with f32
matrix products at full precision (``full_f32_matmuls``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from rome_tpu.graph.lower import GraphArrays
from rome_tpu.solvers.linearize import (
    block_diag_from_lins,
    cost_at,
    dense_normal_eqs,
    flatten_tangent,
    free_vector,
    gradient_from_lins,
    hvp_from_lins,
    linearize_all,
    linearize_all_mixed_j,
    normal_eq_entry_values,
    runtime_state,
    structure_signature,
    tangent_offsets,
    unflatten_tangent,
)
from rome_tpu.utils.math import full_f32_matmuls

# ----------------------------- pytree helpers ------------------------------

def _tdot(a, b):
    return sum(jnp.vdot(a[t], b[t]) for t in a)


def _taxpy(alpha, x, y):
    return {t: y[t] + alpha * x[t] for t in x}


def _tscale(alpha, x):
    return {t: alpha * x[t] for t in x}


# ----------------------------- PCG -----------------------------------------

def pcg(hvp, b, precond, tol, maxiter, dtype=jnp.float32):
    """Solve H x = b with preconditioned conjugate gradients (pytree state).

    Returns ``(x, iters, converged)`` — ``converged`` is the explicit
    residual test (|r| <= tol*|b|), which feeds both the mixed solver's
    lazy-preconditioner refresh (not converged => refactorize) and the LM
    loop's convergence gating (a truncated step must not fire ftol/xtol)."""
    x0 = {t: jnp.zeros_like(b[t]) for t in b}
    r0 = b
    z0 = precond(r0)
    rz0 = _tdot(r0, z0)
    bnorm = jnp.sqrt(_tdot(b, b)) + 1e-30

    def cond(state):
        _x, r, _z, _p, _rz, k = state
        return jnp.logical_and(k < maxiter, jnp.sqrt(_tdot(r, r)) > tol * bnorm)

    def body(state):
        x, r, z, p, rz, k = state
        Hp = hvp(p)
        denom = _tdot(p, Hp)
        alpha = rz / jnp.where(jnp.abs(denom) < 1e-30, 1e-30, denom)
        x = _taxpy(alpha, p, x)
        r = _taxpy(-alpha, Hp, r)
        z = precond(r)
        rz_new = _tdot(r, z)
        beta = rz_new / jnp.where(jnp.abs(rz) < 1e-30, 1e-30, rz)
        p = _taxpy(beta, p, z)
        return (x, r, z, p, rz_new, k + 1)

    state = (x0, r0, z0, r0 if False else z0, rz0, jnp.zeros((), jnp.int32))
    x, r, _z, _p, _rz, k = jax.lax.while_loop(cond, body, state)
    converged = jnp.sqrt(_tdot(r, r)) <= tol * bnorm
    return x, k, converged


# ----------------------------- options -------------------------------------

@dataclass
class GNOptions:
    max_iters: int = 100
    lam0: float = 1e-6
    lam_min: float = 1e-12
    lam_max: float = 1e8
    lam_down: float = 0.25
    lam_up: float = 8.0
    gtol: float = 1e-8
    # ftol=None -> dtype-aware: 1e-10 when values are carried in f64,
    # 3e-7 (just above f32 cost-accumulation noise) when they are f32 —
    # a relative ftol below the working dtype's resolution can NEVER fire,
    # so a warm-started solve grinds to max_iters on noise-level
    # "improvements" and reports converged=false
    ftol: float = None
    xtol: float = 1e-10
    linear: str = "auto"  # "dense"|"dense32"|"ndchol"|"pcg"|"mixed"|"auto"
    dense_threshold: int = 3000   # total dof below which dense Cholesky wins
    pcg_iters: int = 250
    pcg_tol: float = 1e-8
    ir_rounds: int = 2            # f64 iterative-refinement rounds (dense)
    mixed_cg_iters: int = 50      # f64 CG iterations (mixed)
    polish_tol: float = 1e-6      # dense32 f64-CG relative residual tol
    polish_iters: int = 40        # dense32 f64-CG iteration cap
    # step-size convergence: stop when an ACCEPTED step has |dx| < dtol and
    # the damping is at/below lam0 (i.e. the quadratic model is trusted).
    # Unlike xtol/ftol this is NOT gated on CG exactness: near a flat-valley
    # optimum every accepted inexact-Newton step shrinks geometrically, so a
    # small accepted step is itself the stop signal — ftol gated on `exact`
    # can never fire when CG hits its cap at tiny damping (measured on
    # M3500: 15 extra reject-churn iterations). 0 disables.
    dtol: float = 0.0
    # dtol_auto: interpret dtol as a PER-DOF RMS threshold in units of the
    # dataset's metric scale — effective total-norm threshold is
    # dtol * median_odometry_edge_length * sqrt(total_dof). An absolute
    # meters dtol tuned on one dataset silently never fires on a dataset
    # at a different scale (the M3500-tuned 0.25 left the 10 m-block
    # city grid grinding to its iteration cap). dtol=0.0025 with auto
    # reproduces the tuned M3500 behavior (0.0025 * 1 m * sqrt(10503) ~
    # 0.256) and scales to any dataset.
    dtol_auto: bool = False
    # diagonal jitter added to the Jacobi-scaled (unit-diagonal) matrix
    # before the f32 Cholesky (dense32). Must be big enough that f32 pivots
    # never go negative at cond ~ 1e8, but every decade above the scaled
    # lambda_min costs CG contraction: the preconditioned system's kappa is
    # ~ 1 + jitter/lambda_min (measured on M3500: 2e-6 -> cg ~ 50+ per LM
    # iter, 3e-7 -> ~25, 1e-7 -> ~20, 3e-8 -> NaN pivots; the LM loop
    # rejects NaN steps and regrows lam, so even a too-small jitter only
    # costs iterations, not correctness).
    chol_jitter: float = 3e-7
    # ndchol: leaf-region size (variables) of the nested-dissection tree —
    # smaller leaves = less densification fill, more tree levels
    nd_leaf: int = 16
    # run the chordal (rotation-relaxation) init INSIDE the fused solve
    # program: chordal + whole LM loop = ONE dispatch, with no host
    # round-trip between the stages. Only the fused :meth:`ParametricSolver.solve`
    # loop honors this (solve_host ignores it); requires a Pose2 odometry
    # structure. Safe to combine with an already-initialized start: the
    # chordal stages are exact linear solves whose result is independent of
    # the incoming rotations/translations (idempotent).
    fused_chordal: bool = False
    # ndchol: evaluate residuals in f64 but Jacobians in native f32
    # (linearize_all_mixed_j) — J feeds only f32 consumers in this path
    # (assembly, factorization, loose-polish Hvp); r alone carries the
    # f64-critical cost/gradient information. Measured ATE-neutral on
    # M3500/MIT at ~1/3 less per-iteration wall.
    mixed_jacobians: bool = True
    # ndchol fused loop: linearize at the trial point (residuals double as
    # the trial cost; accepted steps hand the linearization straight to the
    # next iteration) — removes the separate cost_at(trial) pass and the
    # final cost eval. A rejected step wastes one linearize (same price as
    # the pass it replaced).
    speculative: bool = True
    # ndchol: reuse the multifrontal factorization across LM iterations,
    # rebuilding only when the previous CG ran past precond_cg_cap
    # iterations (the staleness signal — same lazy policy as the mixed
    # solver's dense preconditioner). Default OFF: it was wall-neutral on
    # M3500, where the level-batched factorize is not the per-iteration
    # bottleneck; kept for workloads with deeper trees or more CG-bound
    # iterations.
    precond_reuse: bool = False
    precond_cg_cap: int = 15
    verbose: bool = False


_SOLVER_CACHE: dict = {}


class ParametricSolver:
    """LM solver bound to one lowered graph STRUCTURE.

    Everything value-like (params, index routing, free masks) is a traced
    argument (linearize.runtime_state); only shapes are compiled in. Use
    :meth:`cached` to share one compiled solver across graphs with the same
    (padded) structure — the incremental path's no-recompile contract.
    """

    def __init__(self, ga: GraphArrays, opts: GNOptions = None):
        self.ga = ga
        self.opts = opts or GNOptions()
        linear = self.opts.linear
        if linear == "auto":
            if ga.total_dof <= self.opts.dense_threshold:
                linear = "dense"
            else:
                # dense32: f32 dense Cholesky + matrix-free f64 polish. The
                # ndchol sparse solver is FASTER above ~5k poses and is the
                # bench flagship, but its symbolic phase binds to exact
                # connectivity — the incremental path (changing vslots
                # inside one shape bucket) would recompute symbolic +
                # retrace per step, so auto keeps the connectivity-agnostic
                # dense32 and batch callers opt into linear="ndchol".
                linear = "dense32"
        self.linear = linear
        # f64 view of the structure for the mixed solver's exact system
        import copy

        self._ga64 = copy.copy(ga)
        self._ga64.dtype = jnp.float64
        # dense32/ndchol carry values in f64 (linearize/cost are O(nnz);
        # only the factorization drops to f32)
        self._use64 = (
            self.linear in ("dense32", "ndchol")
            and bool(jax.config.jax_enable_x64)
            and ga.dtype == jnp.float32
        )
        # dtype-aware effective ftol (see GNOptions.ftol)
        self._ftol = (
            self.opts.ftol
            if self.opts.ftol is not None
            else (1e-10 if (self._use64 or ga.dtype == jnp.float64) else 3e-7)
        )
        # dataset metric scale: median pairwise-odometry edge length —
        # drives the scale-aware dtol AND the f32-vs-f64 CG matvec branch
        scale = 1.0
        norms = []
        for b in ga.batches:
            if b.ftype.arity == 2 and "z" in b.params:
                z = np.asarray(b.params["z"])
                if z.ndim == 2 and z.shape[1] >= 2:
                    norms.append(
                        np.linalg.norm(z[:, : min(3, z.shape[1] - 1)],
                                       axis=1)
                    )
        if norms:
            scale = float(np.median(np.concatenate(norms))) or 1.0
        self._edge_scale = scale
        # scale-aware effective dtol (see GNOptions.dtol_auto)
        if self.opts.dtol_auto and self.opts.dtol > 0:
            D = sum(
                ga.counts[t] * ga.manifolds[t].dof for t in ga.type_names
            )
            self._dtol = self.opts.dtol * scale * float(np.sqrt(max(D, 1)))
        else:
            self._dtol = self.opts.dtol
        self._rt0 = runtime_state(ga)
        # ndchol: one-time host symbolic analysis bound to THIS graph's
        # connectivity; solve() re-derives it (hash-cached) when handed an
        # rt from a different-connectivity graph
        self._sym = self._symbolic_for(ga.batches) if self.linear == "ndchol" else None
        self._sym_cache = {}
        self._alt_programs = {}
        # fused-chordal: symbolic for the 2-dof init systems (sparse above
        # the init2d threshold, dense-traced below)
        self._chordal_sym = None
        self._chordal_dev = {}
        if self.opts.fused_chordal and "Pose2" in ga.counts:
            from rome_tpu.solvers.init2d import (
                _SPARSE_THRESHOLD, _chordal_symbolic, _pose2_edges,
                _pose2_priors,
            )

            edges = _pose2_edges(ga)
            if edges and ga.counts["Pose2"] >= _SPARSE_THRESHOLD:
                self._chordal_sym = _chordal_symbolic(
                    ga.counts["Pose2"], edges, _pose2_priors(ga)
                )
                self._chordal_dev = self._chordal_sym.device_arrs()
        self._step = jax.jit(self._make_step(self._sym))
        self._cost = jax.jit(lambda values, rt: cost_at(self.ga, values, rt))

    def _symbolic_for(self, batches_or_vslots):
        """Host symbolic factorization for a connectivity (list of batches
        or of numpy vslots arrays, in ga.batches order)."""
        from rome_tpu.solvers.sparse import symbolic_factor

        ga = self.ga
        if hasattr(batches_or_vslots[0], "vslots"):
            vs = [np.asarray(b.vslots) for b in batches_or_vslots]
        else:
            vs = [np.asarray(v) for v in batches_or_vslots]
        dofs = {t: ga.manifolds[t].dof for t in ga.type_names}
        specs = [(b.vtypes, v) for b, v in zip(ga.batches, vs)]
        sym = symbolic_factor(
            ga.type_names, ga.counts, dofs, specs, leaf=self.opts.nd_leaf
        )
        sym._dev = sym.device_arrs()
        return sym

    def _sym_for_rt(self, rt):
        """ndchol symbolic for the rt actually being solved (hash-cached)."""
        if self.linear != "ndchol":
            return None
        # identity fast path: runtime_state on the same GraphArrays returns
        # the same device arrays — skip the device->host hash fetch
        if all(
            a is b for a, b in zip(rt["vslots"], self._rt0["vslots"])
        ) and len(rt["vslots"]) == len(self._rt0["vslots"]):
            return self._sym
        vs = [np.asarray(v) for v in rt["vslots"]]
        key = tuple(v.tobytes() for v in vs)
        base_key = tuple(np.asarray(v).tobytes() for v in self._rt0["vslots"])
        if key == base_key:
            return self._sym
        sym = self._sym_cache.get(key)
        if sym is None:
            sym = self._symbolic_for(vs)
            self._sym_cache[key] = sym
        return sym

    def _programs_for(self, sym):
        """(jitted step, jitted fused loop) specialized to a symbolic plan.

        The default plan uses the instance programs; alternates (different
        connectivity handed to a cached solver) get their own jit entries."""
        if sym is None or sym is self._sym:
            if not hasattr(self, "_solve_loop"):
                self._solve_loop = jax.jit(self._make_solve_loop(self._sym))
            return self._step, self._solve_loop
        pkey = (sym.plan, sym.ea_pairs, sym.fea_pairs)
        progs = self._alt_programs.get(pkey)
        if progs is None:
            progs = (
                jax.jit(self._make_step(sym)),
                jax.jit(self._make_solve_loop(sym)),
            )
            self._alt_programs[pkey] = progs
        return progs

    @classmethod
    def cached(cls, ga: GraphArrays, opts: GNOptions = None):
        """Structure-keyed solver reuse: same signature + options -> same
        compiled XLA programs (pass the new graph's runtime_state/values to
        :meth:`solve`)."""
        opts = opts or GNOptions()
        key = (structure_signature(ga), tuple(sorted(vars(opts).items())))
        solver = _SOLVER_CACHE.get(key)
        if solver is None:
            solver = cls(ga, opts)
            _SOLVER_CACHE[key] = solver
        return solver

    # -- one LM iteration as a pure function --------------------------------
    def _make_step(self, sym=None):
        ga = self.ga
        opts = self.opts
        # f64 refinement needs x64 enabled in this process (bench.py and the
        # CPU test mesh enable it); otherwise the cast is a silent f32 no-op
        _X64_OK = bool(jax.config.jax_enable_x64) and ga.dtype == jnp.float32
        # dense32/ndchol carry VALUES and linearizations in f64 (O(nnz),
        # cheap) and keep only the factorization in f32: an
        # f32 state+residual path caps cost resolution at ~1e-4 relative,
        # which on M3500's flat valley is a 0.15 m ATE floor (measured).
        use64 = self.linear in ("dense32", "ndchol") and _X64_OK
        gaW = self._ga64 if use64 else ga

        def boxplus_all(values, delta, rt):
            out = {}
            for t in gaW.type_names:
                man = gaW.manifolds[t]
                d = delta[t] * rt["free"][t][:, None]
                out[t] = man.normalize(man.boxplus(values[t], d))
            return out

        pstate_empty = {}

        def solve_dense(lins, lam, rt, pstate):
            """Damped-normal-equations solve: f64 assembly, Jacobi scaling,
            f32 Cholesky, f64 iterative refinement.

            At M3500 scale cond(H) ~ 1e8, so an H *stored* in f32 yields
            steps that are wrong by O(eps32*cond) ~ O(1) — LM then crawls
            (measured: cost stuck ~2.2k vs the f64 optimum 1774). Assembling
            H/g in f64 (cheap: small-block einsums + scatters) and
            refining the f32-factorized solve against the f64 system gives
            f64-quality steps at f32 factorization speed: each round is one
            f64 matvec (O(n^2)) + one f32 triangular solve pair."""
            use64 = opts.ir_rounds > 0 and _X64_OK
            hdt = jnp.float64 if use64 else ga.dtype
            H, g = dense_normal_eqs(ga, lins, dtype=hdt, rt=rt)
            diag = jnp.maximum(jnp.diag(H), 1e-8)
            Hd = H + lam.astype(hdt) * jnp.diag(diag)
            # symmetric Jacobi scaling: Hs = D Hd D with D = diag(Hd)^-1/2
            d = 1.0 / jnp.sqrt(jnp.maximum(jnp.diag(Hd), 1e-12))
            Hs = Hd * d[:, None] * d[None, :]
            bs = -g * d
            L, lower = jax.scipy.linalg.cho_factor(
                Hs.astype(ga.dtype), lower=True
            )
            y = jax.scipy.linalg.cho_solve((L, lower), bs.astype(ga.dtype))
            y = y.astype(hdt)
            if use64:
                # safeguarded refinement: the f32-factorization iteration has
                # contraction factor ~ eps32*cond(Hs) which exceeds 1 at tiny
                # damping — keep the iterate with the smallest f64 residual
                # instead of trusting the last one
                y_best, rn_best = y, jnp.asarray(jnp.inf, hdt)
                for _ in range(opts.ir_rounds):
                    r = bs - Hs @ y
                    rn = jnp.linalg.norm(r)
                    better = rn < rn_best
                    y_best = jnp.where(better, y, y_best)
                    rn_best = jnp.where(better, rn, rn_best)
                    dy = jax.scipy.linalg.cho_solve(
                        (L, lower), r.astype(ga.dtype)
                    )
                    y = y + dy.astype(hdt)
                rn = jnp.linalg.norm(bs - Hs @ y)
                y = jnp.where(rn < rn_best, y, y_best)
            x = ((y * d) * free_vector(ga, rt).astype(hdt)).astype(ga.dtype)
            return (
                unflatten_tangent(ga, x),
                g.astype(ga.dtype),
                pstate_empty,
                jnp.asarray(True),
                {},
            )

        def solve_pcg(lins, lam, rt, pstate):
            free = rt["free"]
            gvec = gradient_from_lins(ga, lins, rt)
            D = block_diag_from_lins(ga, lins)

            def hvp(v):
                out = hvp_from_lins(ga, lins, v, rt)
                # Marquardt damping on the diagonal of J^T J
                for t in out:
                    dd = jnp.maximum(
                        jnp.diagonal(D[t], axis1=-2, axis2=-1), 1e-8
                    )
                    out[t] = out[t] + lam * dd * v[t]
                    out[t] = out[t] * free[t][:, None]
                return out

            # block-Jacobi preconditioner: invert damped per-variable blocks
            Pinv = {}
            for t in ga.type_names:
                dof = ga.manifolds[t].dof
                eye = jnp.eye(dof, dtype=ga.dtype)
                dd = jnp.maximum(jnp.diagonal(D[t], axis1=-2, axis2=-1), 1e-8)
                blk = D[t] + lam * dd[..., None] * eye + 1e-8 * eye
                fmask = free[t][:, None, None]
                blk = blk * fmask + eye * (1.0 - fmask)
                Pinv[t] = jnp.linalg.inv(blk)

            def precond(r):
                return {
                    t: jnp.einsum("nij,nj->ni", Pinv[t], r[t]) * free[t][:, None]
                    for t in r
                }

            b = {t: -gvec[t] for t in gvec}
            x, _k, cg_ok = pcg(
                hvp, b, precond, opts.pcg_tol, opts.pcg_iters, ga.dtype
            )
            return x, gvec, pstate_empty, cg_ok, {}

        def solve_dense32(lins, lam, rt, pstate):
            """Dense large-graph solver: f32 dense normal equations + ONE
            f32 Cholesky per iteration + short matrix-free f64 CG polish.

            f64 arithmetic touches only O(nnz) quantities: the CG matvec is
            computed matrix-free through the factor batches
            (gradient_from_lins/hvp_from_lins on f64-cast lins), and the
            preconditioner reuses the fresh f32 factor (one trisolve pair
            per apply). A fresh exact-in-f32 preconditioner puts CG at a
            handful of iterations to polish_tol.

            When x64 is live, ``lins`` arrive in f64 (values carried in f64
            by the step — see ``use64``) and the CG runs in f64; otherwise
            everything is f32 and the CG acts as a cheap exact-precondition
            solve (1-2 iterations)."""
            f32 = jnp.float32
            wdt = gaW.dtype  # working dtype of values/lins/CG
            H, _g32 = dense_normal_eqs(gaW, lins, dtype=f32, rt=rt)
            diag = jnp.maximum(jnp.diag(H), 1e-8)
            Hd = H + lam.astype(f32) * jnp.diag(diag)
            d = 1.0 / jnp.sqrt(jnp.maximum(jnp.diag(Hd), 1e-12))
            Hs = Hd * d[:, None] * d[None, :]
            Hs = Hs + opts.chol_jitter * jnp.eye(Hs.shape[0], dtype=f32)
            L, lower = jax.scipy.linalg.cho_factor(Hs, lower=True)
            fvec = free_vector(gaW, rt).astype(wdt)

            def minv(r):
                # r (unscaled residual, wdt) -> approx Hd^-1 r via the f32
                # scaled factor; two triangular solves
                y = jax.scipy.linalg.cho_solve((L, lower), r.astype(f32) * d)
                return (y * d).astype(wdt) * fvec

            g = gradient_from_lins(gaW, lins, rt)
            diagW = diag.astype(wdt)
            lamW = lam.astype(wdt)

            def hD(x):
                v = unflatten_tangent(gaW, x)
                out = hvp_from_lins(gaW, lins, v, rt)
                return (
                    flatten_tangent(gaW, out) + lamW * diagW * x
                ) * fvec

            # CG on the true damped system, preconditioned by the f32
            # factor (see cg_polish).
            b = -flatten_tangent(gaW, g)
            x, r, k = cg_polish(minv, hD, b)
            delta = unflatten_tangent(gaW, x)
            bn = jnp.linalg.norm(b) + 1e-300
            exact = jnp.linalg.norm(r) <= opts.polish_tol * bn
            # model reduction for the gain ratio, free from CG state:
            # H delta = b - r and b = -g  =>
            # pred = -(g.d + 0.5 d.Hd) = 0.5 b.d + 0.5 d.r
            pred = 0.5 * (jnp.vdot(b, x) + jnp.vdot(x, r))
            return delta, g, pstate_empty, exact, {
                "pred": pred, "cg_iters": k,
            }

        def cg_polish(minv, hD, b, tol=None):
            """CG on the true damped system, preconditioned by the fresh
            f32 factorization. Plain Richardson refinement does NOT
            contract here: eps32 * cond(Hs) > 1 at M3500's conditioning, so
            refined steps stay biased and LM crawls (measured: 40
            iterations of ~0.01-cost creep). CG only needs the
            preconditioner to be SPD-ish and recovers the exact step in a
            handful of iterations; the matvec is matrix-free over the
            factor batches (O(nnz)).

            The loop body holds the ONLY instantiation of minv and hD
            (z/beta computed at the top of the body instead of priming them
            before the loop): the preconditioner is a whole multifrontal
            tree sweep for ndchol, and every extra traced copy of it adds
            to the compile time.
            Returns (x, residual, k)."""
            tol = opts.polish_tol if tol is None else tol
            bn = jnp.linalg.norm(b) + 1e-300
            x0 = jnp.zeros_like(b)

            def cg_cond(s):
                _x, r_, _p, _rz, k = s
                return jnp.logical_and(
                    k < opts.polish_iters,
                    jnp.linalg.norm(r_) > tol * bn,
                )

            def cg_body(s):
                x_, r_, p_, rz_, k = s
                z = minv(r_)
                rz2 = jnp.vdot(r_, z)
                beta = jnp.where(
                    k == 0, 0.0, rz2 / jnp.where(jnp.abs(rz_) < 1e-300,
                                                 1e-300, rz_)
                )
                p_ = z + beta * p_
                Ap = hD(p_)
                denom = jnp.vdot(p_, Ap)
                alpha = rz2 / jnp.where(jnp.abs(denom) < 1e-300, 1e-300, denom)
                x_ = x_ + alpha * p_
                r_ = r_ - alpha * Ap
                return (x_, r_, p_, rz2, k + 1)

            x, r, _p, _rz, k = jax.lax.while_loop(
                cg_cond, cg_body,
                (x0, b, jnp.zeros_like(b), jnp.zeros((), b.dtype),
                 jnp.zeros((), jnp.int32)),
            )
            return x, r, k

        def solve_ndchol(lins, lam, rt, pstate):
            """Sparse large-graph solver: nested-dissection
            multifrontal block-sparse Cholesky (O(~nnz·front) per iteration
            instead of the dense O(n^3)) preconditioning the same short
            matrix-free f64 CG polish as dense32.

            The symbolic structure (closed-over `sym` plan + index maps in
            rt["ndchol"]) turns the factorization into ~log(n) level-batched
            dense partial Cholesky stages; shallow per-front dependency
            chains also keep f32 rounding accumulation far below the dense
            factorization's, so a smaller jitter (= tighter preconditioner,
            fewer CG iterations) is numerically safe. Reference contract:
            the Bayes-tree clique solve (Slam.jl:261, SURVEY.md §3.4)."""
            from rome_tpu.solvers.sparse.ndchol import (
                ndchol_assemble, ndchol_factorize, ndchol_solve,
            )

            f32 = jnp.float32
            wdt = gaW.dtype
            nd = rt["ndchol"]
            # tunable scalars may ride in as TRACED values (rt["ndchol_tune"])
            # so a single compiled program serves a parameter sweep
            tune = rt.get("ndchol_tune") if isinstance(rt, dict) else None
            jitter = (
                tune["jitter"] if tune is not None else opts.chol_jitter
            )
            ptol = (
                tune["polish_tol"] if tune is not None else opts.polish_tol
            )
            vals = normal_eq_entry_values(gaW, lins, dtype=f32)
            fvec32 = free_vector(gaW, rt).astype(f32)
            lam32 = lam.astype(f32)
            diag_H = (
                jnp.zeros(sym.D, f32)
                .at[nd["diag_dst"]]
                .add(vals[nd["diag_src"]] * fvec32[nd["diag_dst"]] ** 2)
            )
            dv = jax.lax.rsqrt(jnp.maximum(diag_H * (1.0 + lam32), 1e-12))
            df = dv * fvec32
            diag_add = fvec32 * (
                lam32 / (1.0 + lam32) + jitter
            ) + (1.0 - fvec32)

            def _refresh(_):
                Ws = ndchol_assemble(sym, nd, vals, df, diag_add)
                Linvs, L21s, _L11s = ndchol_factorize(sym, nd, Ws)
                return Linvs, L21s, df

            # lazy preconditioner refresh (same policy as solve_mixed): the
            # damped system changes slowly along the LM path — reuse the
            # previous factorization (CG corrects through it; `exact` stays
            # residual-tested) and rebuild only when the previous CG ran
            # long (stale).
            reuse = (
                opts.precond_reuse
                and isinstance(pstate, dict)
                and "Linvs" in pstate
            )
            if reuse:
                Linvs, L21s, dfp = jax.lax.cond(
                    pstate["stale"], _refresh,
                    lambda _: (pstate["Linvs"], pstate["L21s"],
                               pstate["df"]),
                    None,
                )
            else:
                Linvs, L21s, dfp = _refresh(None)

            def minv(r):
                y = ndchol_solve(sym, nd, Linvs, L21s, r.astype(f32) * dfp)
                return (y * dfp).astype(wdt)

            g = gradient_from_lins(gaW, lins, rt)
            fvecW = free_vector(gaW, rt).astype(wdt)
            diagW = diag_H.astype(wdt)
            lamW = lam.astype(wdt)

            # loose polish (inexact Newton) doesn't need f64 matvecs: the
            # CG only drives the relative residual to ~polish_tol, so an
            # f32 Hvp is precise enough — only the RHS b (gradient) and the
            # cost evaluations stay in f64. At tight polish_tol the f64
            # matvec is kept (the f32 one's error would
            # floor the achievable residual). The branch is STATIC, so when
            # the effective tol rides in traced via rt["ndchol_tune"] we
            # must not pick f32 from the (possibly looser) static default —
            # a tuned tol tighter than ~1e-3 against the f32 matvec floors
            # the residual and CG spins to its cap. Tuned sweeps therefore
            # always get the f64 matvec. The branch is ALSO scale-gated:
            # on the 10 m-block city grid the f32 Hvp's rounding corrupted
            # the CG directions outright — LM hit an 8-rejection stall at
            # cost +12.7% over the optimum, while the identical config with
            # the f64 matvec converged to the optimum in 10 iters;
            # 1 m-scale graphs (M3500/MIT) are unaffected.
            if (
                tune is None
                and opts.polish_tol >= 1e-3
                and wdt != jnp.float32
                and self._edge_scale <= 3.0
            ):
                lins32 = [
                    (bb, r0.astype(f32), tuple(J.astype(f32) for J in Js), vs)
                    for bb, r0, Js, vs in lins
                ]
                diag32 = diag_H
                fvec32b = fvec32

                def hD(x):
                    v = unflatten_tangent(ga, x.astype(f32))
                    out = hvp_from_lins(ga, lins32, v, rt)
                    return (
                        (flatten_tangent(ga, out) + lam32 * diag32 * x.astype(f32))
                        * fvec32b
                    ).astype(wdt)

            else:
                def hD(x):
                    v = unflatten_tangent(gaW, x)
                    out = hvp_from_lins(gaW, lins, v, rt)
                    return (
                        flatten_tangent(gaW, out) + lamW * diagW * x
                    ) * fvecW

            b = -flatten_tangent(gaW, g)
            x, r, k = cg_polish(minv, hD, b, tol=ptol)
            delta = unflatten_tangent(gaW, x)
            bn = jnp.linalg.norm(b) + 1e-300
            exact = jnp.linalg.norm(r) <= ptol * bn
            pred = 0.5 * (jnp.vdot(b, x) + jnp.vdot(x, r))
            if reuse:
                new_pstate = {
                    "Linvs": Linvs, "L21s": L21s, "df": dfp,
                    # refresh signal: the CG needed enough iterations that
                    # the stale factor stopped paying for itself
                    "stale": k >= opts.precond_cg_cap,
                }
            else:
                new_pstate = pstate_empty
            return delta, g, new_pstate, exact, {
                "pred": pred, "cg_iters": k,
            }

        def solve_mixed(lins, lam, rt, pstate):
            """The flagship large-graph solver: exact f64 Gauss-Newton steps
            at f32 factorization cost.

            - preconditioner: damped Jacobi-scaled H assembled in f32, ONE
              dense Cholesky (+1e-6 floor on the unit diagonal so
              f32 pivots never go negative) — REFRESHED LAZILY: the O(n^3)
              factor+inverse is reused across LM iterations and rebuilt only
              when the previous CG hit its iteration cap without reaching
              tol (the stale signal). H changes slowly along the LM path, so
              most iterations skip the n^3 work entirely;
            - system: the TRUE damped normal equations in f64, matrix-free —
              Hvp as sparse gather/einsum/scatter over the factor batches
              (O(nnz)) instead of an O(n^2) dense f64 matvec;
            - CG in f64 preconditioned by the f32 factor: robust where plain
              iterative refinement (Richardson) diverges once
              eps32*cond(H_damped) > 1 near convergence (lam -> 0).
            """
            f64 = jnp.float64

            def refresh(_):
                H32, _g32 = dense_normal_eqs(ga, lins, dtype=ga.dtype, rt=rt)
                diag32 = jnp.maximum(jnp.diag(H32), 1e-8)
                Hd32 = H32 + lam * jnp.diag(diag32)
                dvec = 1.0 / jnp.sqrt(jnp.maximum(jnp.diag(Hd32), 1e-12))
                Hs32 = Hd32 * dvec[:, None] * dvec[None, :]
                Hs32 = Hs32 + 1e-6 * jnp.eye(Hs32.shape[0], dtype=ga.dtype)
                L, _lower = jax.scipy.linalg.cho_factor(Hs32, lower=True)
                # explicit inverse: one O(n^3) inversion makes every CG
                # apply two matvecs instead of two triangular solves.
                # (cho_solve against a full identity OOMs — XLA materializes
                # ~30 panel temporaries — so invert the factor in column
                # blocks under lax.map and form Minv = Linv^T Linv.)
                nD = Hs32.shape[0]
                blk = 1024
                npad = (-nD) % blk
                eyeP = jnp.eye(nD + npad, dtype=ga.dtype)[: nD + npad, :nD]
                cols = eyeP.reshape(-1, blk, nD)  # (nblk, blk, n) one-hot

                def solve_block(c):
                    # x @ L = c  ->  x = c L^-1 (rows of L^-1 selected by c)
                    return jax.lax.linalg.triangular_solve(
                        L, c, left_side=False, lower=True, transpose_a=False
                    )

                Linv_rows = jax.lax.map(solve_block, cols)  # rows of L^-1
                return Linv_rows.reshape(nD + npad, nD)[:nD], dvec

            Linv, dvec = jax.lax.cond(
                pstate["stale"],
                refresh,
                lambda _: (pstate["Linv"], pstate["dvec"]),
                None,
            )
            fvec = free_vector(ga, rt)

            def precond(r):
                # Hs^-1 = L^-T L^-1: two matvecs per apply
                x = flatten_tangent(ga, r).astype(ga.dtype)
                x = Linv.T @ (Linv @ (x * dvec))
                x = (x * dvec).astype(f64) * fvec.astype(f64)
                return unflatten_tangent(ga, x)

            # ---- exact f64 system, matrix-free ----
            lins64 = [
                (b, r0.astype(f64), tuple(J.astype(f64) for J in Js), vs)
                for b, r0, Js, vs in lins
            ]
            ga64 = self._ga64
            rt64 = jax.tree_util.tree_map(
                lambda x: x.astype(f64) if x.dtype == ga.dtype else x, rt
            )
            g64 = gradient_from_lins(ga64, lins64, rt64)
            D64 = block_diag_from_lins(ga64, lins64)
            lam64 = lam.astype(f64)

            def hvp(v):
                out = hvp_from_lins(ga64, lins64, v, rt64)
                for t in out:
                    dd = jnp.maximum(
                        jnp.diagonal(D64[t], axis1=-2, axis2=-1), 1e-8
                    )
                    out[t] = (out[t] + lam64 * dd * v[t]) * rt64["free"][t][:, None]
                return out

            b = {t: -g64[t] for t in g64}
            x, _k, cg_ok = pcg(hvp, b, precond, 1e-8, opts.mixed_cg_iters, f64)
            delta = {t: x[t].astype(ga.dtype) for t in x}
            new_pstate = {
                "Linv": Linv,
                "dvec": dvec,
                # explicit residual-test failure => the reused factor no
                # longer preconditions well; refactorize next iteration
                # (and the truncated step must not fire ftol/xtol — the
                # cg_ok flag gates those codes in the LM loop)
                "stale": ~cg_ok,
            }
            return (
                delta,
                {t: g64[t].astype(ga.dtype) for t in g64},
                new_pstate,
                cg_ok,
                {},
            )

        linear_solve = {
            "dense": solve_dense,
            "dense32": solve_dense32,
            "ndchol": solve_ndchol,
            "pcg": solve_pcg,
            "mixed": solve_mixed,
        }[self.linear]

        # cost accumulation dtype: f64 scalars when x64 is live — f32
        # accumulation noise (~1e-4 relative at M3500 scale) otherwise
        # masks ftol-level cost changes and the loop never terminates early
        cdt = jnp.float64 if _X64_OK else ga.dtype

        # ndchol: f64 residuals + f32 Jacobians (linearize_all_mixed_j) —
        # every J consumer in this path is f32 already
        mixed_j = (
            self.linear == "ndchol" and opts.mixed_jacobians and use64
        )

        @full_f32_matmuls
        def step(values, lam, rt, pstate=None):
            if pstate is None:
                pstate = self._pstate0(sym)
            if mixed_j:
                lins = linearize_all_mixed_j(gaW, ga, values, rt)
            else:
                lins = linearize_all(gaW, values, rt)
            cost0 = sum(
                0.5 * jnp.sum(r0.astype(cdt) * r0.astype(cdt))
                for _b, r0, _J, _v in lins
            )
            delta, g, new_pstate, exact, extras = linear_solve(
                lins, lam, rt, pstate
            )
            if isinstance(g, dict):
                gvec = g
            else:
                gvec = unflatten_tangent(gaW, g)
            gnorm = jnp.sqrt(_tdot(gvec, gvec))
            dnorm = jnp.sqrt(_tdot(delta, delta))
            trial = boxplus_all(values, delta, rt)
            cost1 = cost_at(gaW, trial, rt, accum_dtype=cdt)
            # gain ratio: actual vs quadratic-model predicted reduction.
            # dense32 derives pred from its CG state for free; other
            # solvers pay one extra Hvp.
            if "pred" in extras:
                pred = extras["pred"].astype(cdt)
            else:
                Hd = hvp_from_lins(gaW, lins, delta, rt)
                pred = (-(_tdot(gvec, delta) + 0.5 * _tdot(delta, Hd))).astype(cdt)
            cg_iters = extras.get("cg_iters", jnp.zeros((), jnp.int32))
            rho = (cost0 - cost1) / jnp.where(pred > 1e-30, pred, 1e-30)
            ok = jnp.logical_and(jnp.isfinite(cost1), cost1 < cost0)
            new_values = jax.tree_util.tree_map(
                lambda a, b: jnp.where(ok, a, b), trial, values
            )
            # Marquardt schedule: shrink lam only on good model agreement,
            # grow it when the quadratic model overshoots (rho small) even if
            # the step was accepted — kills the GN zigzag on rotation-heavy
            # graphs (Manhattan) without rejecting progress.
            tune_s = rt.get("ndchol_tune") if isinstance(rt, dict) else None
            lam_min = (
                tune_s["lam_min"]
                if tune_s is not None and "lam_min" in tune_s
                else opts.lam_min
            )
            grow = jnp.minimum(lam * opts.lam_up, opts.lam_max)
            shrink = jnp.maximum(lam * opts.lam_down, lam_min)
            new_lam = jnp.where(
                ~ok,
                grow,
                jnp.where(rho < 0.25, grow, jnp.where(rho > 0.7, shrink, lam)),
            )
            return (
                new_values, new_lam, cost0, cost1, gnorm, dnorm, ok,
                new_pstate, exact, cg_iters,
            )

        # expose the building blocks for the speculative-accept loop
        # (_make_solve_loop ndchol path) without re-tracing them
        def linize(values, rt):
            if mixed_j:
                return linearize_all_mixed_j(gaW, ga, values, rt)
            return linearize_all(gaW, values, rt)

        step.parts = dict(
            linear_solve=linear_solve, boxplus_all=boxplus_all, cdt=cdt,
            linize=linize,
        )
        return step

    def _pstate0(self, sym=None):
        """Initial lazy-preconditioner state: stale=True forces a
        factorization on the first iteration; the zero buffers are
        placeholders XLA never reads on the refresh branch. ``sym`` selects
        the ndchol plan whose front shapes the state must match (defaults
        to this solver's own)."""
        if self.linear == "ndchol":
            if not self.opts.precond_reuse:
                return {}
            sym = sym if sym is not None else self._sym
            f32 = jnp.float32
            Linvs, L21s = [], []
            for n_l, sm, bm in sym.plan:
                if n_l == 0:
                    Linvs.append(None)
                    L21s.append(None)
                    continue
                Linvs.append(jnp.zeros((n_l, sm, sm), f32))
                L21s.append(
                    jnp.zeros((n_l, bm, sm), f32) if bm else None
                )
            return {
                "Linvs": Linvs, "L21s": L21s,
                "df": jnp.zeros((sym.D,), f32),
                "stale": jnp.asarray(True),
            }
        if self.linear != "mixed":
            return {}
        from rome_tpu.solvers.linearize import tangent_offsets

        _base, nD = tangent_offsets(self.ga)
        return {
            "Linv": jnp.zeros((nD, nD), dtype=self.ga.dtype),
            "dvec": jnp.ones((nD,), dtype=self.ga.dtype),
            "stale": jnp.asarray(True),
        }

    # -- fused on-device outer loop ------------------------------------------
    # Reason codes for the while_loop convergence logic (0 = still running)
    _REASONS = {
        0: "max_iters",
        1: "gtol",
        2: "xtol",
        3: "ftol",
        4: "step_floor",
        5: "stalled",
        6: "dtol",
    }

    def _make_solve_loop(self, sym=None):
        """The whole LM solve as ONE jitted XLA program: lax.while_loop over
        LM iterations with the accept/convergence logic in-graph, so no
        iteration waits on a host<->device round-trip."""
        ga, opts = self.ga, self.opts
        step = self._make_step(sym)
        max_iters = int(opts.max_iters)
        _x64 = bool(jax.config.jax_enable_x64) and ga.dtype == jnp.float32
        cdt = jnp.float64 if _x64 else ga.dtype
        # working dtype of values/gradients (dense32/ndchol carry f64)
        wdt = jnp.float64 if self._use64 else ga.dtype
        step_floor = 1e-4 if wdt == jnp.float32 else 1e-9

        fused_chordal = bool(
            opts.fused_chordal and "Pose2" in ga.counts
            and any(
                b.ftype.name in ("Pose2Pose2", "MutablePose2Pose2Gaussian")
                for b in ga.batches
            )
        )
        if fused_chordal:
            from rome_tpu.solvers.init2d import _chordal_body

            # batch roles are STATIC; the values (vslots/params/weights)
            # ride in through rt so the traced chordal sees current data
            edge_idx = [
                i for i, b in enumerate(ga.batches)
                if b.ftype.name in ("Pose2Pose2", "MutablePose2Pose2Gaussian")
            ]
            prior_idx = [
                i for i, b in enumerate(ga.batches)
                if b.ftype.name == "PriorPose2"
            ]
            chordal_sym = self._chordal_sym

            def traced_chordal(values, rt):
                edges = [
                    (rt["vslots"][i][:, 0], rt["vslots"][i][:, 1],
                     rt["params"][i]["z"], rt["params"][i]["sqrt_info"],
                     rt["weight"][i])
                    for i in edge_idx
                ]
                priors = [
                    (rt["vslots"][i][:, 0], rt["params"][i]["z"],
                     rt["params"][i]["sqrt_info"], rt["weight"][i])
                    for i in prior_idx
                ]
                pose2 = _chordal_body(
                    wdt, ga.counts["Pose2"], values["Pose2"], edges, priors,
                    rt["free"]["Pose2"], chordal_sym,
                    rt.get("chordal_nd", {}),
                )
                return {**values, "Pose2": pose2}

        # Speculative-accept loop (ndchol): linearize AT THE TRIAL POINT —
        # its residuals give the trial cost for free, and on accept (the
        # overwhelmingly common case post-chordal-init) the linearization
        # is exactly what the next iteration needs, so the separate
        # cost_at(trial) pass AND the final cost_at disappear. A rejected
        # step wastes one linearize (same cost as the pass it replaced).
        speculative = self.linear == "ndchol" and opts.speculative
        if speculative:
            parts = step.parts
            linear_solve = parts["linear_solve"]
            boxplus_all = parts["boxplus_all"]
            linize = parts["linize"]

            def sumsq(lins):
                return sum(
                    0.5 * jnp.sum(r0.astype(cdt) * r0.astype(cdt))
                    for _b, r0, _J, _v in lins
                )

            @full_f32_matmuls
            def loop(values, lam, rt):
                if fused_chordal:
                    values = traced_chordal(values, rt)
                lins0 = linize(values, rt)
                cost_cur0 = sumsq(lins0)
                carried0 = [(r0, Js) for _b, r0, Js, _v in lins0]
                hist0 = jnp.zeros((max_iters, 7), dtype=jnp.float32)

                def rebuild(carried, rt):
                    return [
                        (b, r0, Js, rt["vslots"][i])
                        for i, (b, (r0, Js)) in enumerate(
                            zip(ga.batches, carried)
                        )
                    ]

                def cond(state):
                    (_v, _c, _cc, _lam, it, _cp, _nr, code, _g, _h,
                     _ps) = state
                    return jnp.logical_and(it < max_iters, code == 0)

                def body(state):
                    (values, carried, cost0, lam, it, cost_prev, n_rej,
                     code, _g, hist, pstate) = state
                    lins = rebuild(carried, rt)
                    delta, g, pstate, exact, extras = linear_solve(
                        lins, lam, rt, pstate
                    )
                    gvec = g if isinstance(g, dict) else unflatten_tangent(
                        gaW, g
                    )
                    gnorm = jnp.sqrt(_tdot(gvec, gvec))
                    dnorm = jnp.sqrt(_tdot(delta, delta))
                    trial = boxplus_all(values, delta, rt)
                    lins_t = linize(trial, rt)
                    cost1 = sumsq(lins_t)
                    pred = extras["pred"].astype(cdt)
                    cg_iters = extras.get(
                        "cg_iters", jnp.zeros((), jnp.int32)
                    )
                    rho = (cost0 - cost1) / jnp.where(
                        pred > 1e-30, pred, 1e-30
                    )
                    ok = jnp.logical_and(
                        jnp.isfinite(cost1), cost1 < cost0
                    )
                    new_values = jax.tree_util.tree_map(
                        lambda a, b_: jnp.where(ok, a, b_), trial, values
                    )
                    new_carried = [
                        (
                            jnp.where(ok, rt_, rc_),
                            tuple(
                                jnp.where(ok, Jt_, Jc_)
                                for Jt_, Jc_ in zip(Jst, Jsc)
                            ),
                        )
                        for (_b1, rt_, Jst, _v1), (rc_, Jsc) in zip(
                            lins_t, carried
                        )
                    ]
                    new_cost0 = jnp.where(ok, cost1, cost0)
                    tune_s = (
                        rt.get("ndchol_tune") if isinstance(rt, dict)
                        else None
                    )
                    lam_min = (
                        tune_s["lam_min"]
                        if tune_s is not None and "lam_min" in tune_s
                        else opts.lam_min
                    )
                    grow = jnp.minimum(lam * opts.lam_up, opts.lam_max)
                    shrink = jnp.maximum(lam * opts.lam_down, lam_min)
                    new_lam = jnp.where(
                        ~ok,
                        grow,
                        jnp.where(
                            rho < 0.25, grow,
                            jnp.where(rho > 0.7, shrink, lam),
                        ),
                    )
                    hist = hist.at[it].set(
                        jnp.stack(
                            [cost0, cost1, gnorm.astype(cost0.dtype),
                             dnorm.astype(cost0.dtype),
                             ok.astype(cost0.dtype),
                             new_lam.astype(cost0.dtype),
                             cg_iters.astype(cost0.dtype)]
                        ).astype(jnp.float32)
                    )
                    ftol_hit = jnp.abs(cost_prev - cost1) <= (
                        self._ftol * jnp.maximum(1.0, jnp.abs(cost_prev))
                    )
                    dtol_v = (
                        tune_s["dtol"] if tune_s is not None else self._dtol
                    )
                    dtol_hit = jnp.logical_and(
                        jnp.asarray(dtol_v > 0.0),
                        jnp.logical_and(
                            dnorm < dtol_v, new_lam <= opts.lam0 + 0.0
                        ),
                    )
                    acc_code = jnp.where(
                        gnorm < opts.gtol,
                        1,
                        jnp.where(
                            jnp.logical_and(exact, dnorm < opts.xtol),
                            2,
                            jnp.where(
                                jnp.logical_and(
                                    exact,
                                    jnp.logical_and(
                                        jnp.isfinite(cost_prev), ftol_hit
                                    ),
                                ),
                                3,
                                jnp.where(dtol_hit, 6, 0),
                            ),
                        ),
                    )
                    n_rej_new = jnp.where(ok, 0, n_rej + 1)
                    rej_code = jnp.where(
                        dnorm < step_floor,
                        4,
                        jnp.where(
                            jnp.logical_or(
                                n_rej_new >= 8, new_lam >= opts.lam_max
                            ),
                            5,
                            0,
                        ),
                    )
                    new_code = jnp.where(ok, acc_code, rej_code).astype(
                        jnp.int32
                    )
                    new_cost_prev = jnp.where(ok, cost1, cost_prev)
                    # a rejection means lam grew 8x — the carried
                    # preconditioner no longer matches; force a refresh
                    if isinstance(pstate, dict) and "stale" in pstate:
                        pstate = {
                            **pstate,
                            "stale": jnp.logical_or(pstate["stale"], ~ok),
                        }
                    return (
                        new_values, new_carried, new_cost0, new_lam,
                        it + 1, new_cost_prev, n_rej_new, new_code,
                        gnorm, hist, pstate,
                    )

                init = (
                    values, carried0, cost_cur0,
                    lam, jnp.zeros((), jnp.int32),
                    jnp.asarray(jnp.inf, dtype=cdt),
                    jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
                    jnp.zeros((), dtype=wdt), hist0,
                    self._pstate0(sym),
                )
                (values, _carried, final_cost, lam, it, _cp, n_rej, code,
                 gnorm, hist, _ps) = jax.lax.while_loop(cond, body, init)
                # final_cost is the exact cost at the returned values (the
                # last accepted linearization's residuals) — no extra pass
                return values, it, code, n_rej, gnorm, final_cost, hist

            return loop

        @full_f32_matmuls
        def loop(values, lam, rt):
            if fused_chordal:
                values = traced_chordal(values, rt)
            hist0 = jnp.zeros((max_iters, 7), dtype=jnp.float32)

            def cond(state):
                _v, _lam, it, _cp, _nr, code, _g, _h, _ps = state
                return jnp.logical_and(it < max_iters, code == 0)

            def body(state):
                values, lam, it, cost_prev, n_rej, code, _g, hist, pstate = state
                (new_values, new_lam, cost0, cost1, gnorm, dnorm, ok, pstate,
                 exact, cg_iters) = step(values, lam, rt, pstate)
                hist = hist.at[it].set(
                    jnp.stack(
                        [cost0, cost1, gnorm.astype(cost0.dtype),
                         dnorm.astype(cost0.dtype), ok.astype(cost0.dtype),
                         new_lam.astype(cost0.dtype),
                         cg_iters.astype(cost0.dtype)]
                    ).astype(jnp.float32)
                )
                # accepted-branch convergence. ftol/xtol are only meaningful
                # when the linear solve was trustworthy (`exact`): a
                # truncated CG step under a stale preconditioner barely
                # moves cost and would otherwise fire ftol at a
                # non-stationary point.
                ftol_hit = jnp.abs(cost_prev - cost1) <= self._ftol * jnp.maximum(
                    1.0, jnp.abs(cost_prev)
                )
                tune = rt.get("ndchol_tune") if isinstance(rt, dict) else None
                dtol_v = tune["dtol"] if tune is not None else self._dtol
                dtol_hit = jnp.logical_and(
                    jnp.asarray(dtol_v > 0.0),
                    jnp.logical_and(
                        dnorm < dtol_v, new_lam <= opts.lam0 + 0.0
                    ),
                )
                acc_code = jnp.where(
                    gnorm < opts.gtol,
                    1,
                    jnp.where(
                        jnp.logical_and(exact, dnorm < opts.xtol),
                        2,
                        jnp.where(
                            jnp.logical_and(
                                exact,
                                jnp.logical_and(
                                    jnp.isfinite(cost_prev), ftol_hit
                                ),
                            ),
                            3,
                            jnp.where(dtol_hit, 6, 0),
                        ),
                    ),
                )
                # rejected-branch convergence
                n_rej_new = jnp.where(ok, 0, n_rej + 1)
                rej_code = jnp.where(
                    dnorm < step_floor,
                    4,
                    jnp.where(
                        jnp.logical_or(n_rej_new >= 8, new_lam >= opts.lam_max),
                        5,
                        0,
                    ),
                )
                new_code = jnp.where(ok, acc_code, rej_code).astype(jnp.int32)
                new_cost_prev = jnp.where(ok, cost1, cost_prev)
                return (
                    new_values,
                    new_lam,
                    it + 1,
                    new_cost_prev,
                    n_rej_new,
                    new_code,
                    gnorm,
                    hist,
                    pstate,
                )

            init = (
                values,
                lam,
                jnp.zeros((), jnp.int32),
                jnp.asarray(jnp.inf, dtype=cdt),
                jnp.zeros((), jnp.int32),
                jnp.zeros((), jnp.int32),
                jnp.zeros((), dtype=wdt),
                hist0,
                self._pstate0(sym),
            )
            values, lam, it, _cp, n_rej, code, gnorm, hist, _ps = jax.lax.while_loop(
                cond, body, init
            )
            final_cost = cost_at(ga, values, rt, accum_dtype=cdt)
            return values, it, code, n_rej, gnorm, final_cost, hist

        return loop

    # -- host-scheduled loop --------------------------------------------------
    def solve_host(self, values=None, rt=None):
        """LM with the Marquardt schedule on the host: one jitted STEP
        (compiles faster than the fused loop) + a Python loop that pays one
        scalar sync per iteration; the fused loop (:meth:`solve`) is for
        latency-critical repeated solves."""
        ga, opts = self.ga, self.opts
        values = values or ga.values0
        if self._use64:
            values = {t: jnp.asarray(v, jnp.float64) for t, v in values.items()}
        rt = rt if rt is not None else self._rt0
        step_fn = self._step
        if self.linear == "ndchol":
            symr = self._sym_for_rt(rt)
            rt = {**rt, "ndchol": symr._dev}
            step_fn, _ = self._programs_for(symr)
        lam = jnp.asarray(opts.lam0, dtype=ga.dtype)
        hist = []
        cost_prev = float("inf")
        n_rej = 0
        code = 0
        gnorm = float("nan")
        pstate = self._pstate0(
            symr if self.linear == "ndchol" else None
        )
        for it in range(int(opts.max_iters)):
            new_values, lam, c0, c1, gn, dn, ok, pstate, exact, cg_k = step_fn(
                values, lam, rt, pstate
            )
            # ONE device_get for all step scalars, not five round-trips
            c0, c1, gn, dn, okb, exact = jax.device_get(
                (c0, c1, gn, dn, ok, exact)
            )
            c0, c1, gn, dn, okb, exact = (
                float(c0), float(c1), float(gn), float(dn), bool(okb),
                bool(exact),
            )
            gnorm = gn
            hist.append(
                dict(iter=it, cost0=c0, cost1=c1, gnorm=gn, dnorm=dn,
                     accepted=okb, lam=float(lam), cg=int(cg_k))
            )
            if okb:
                values = new_values
                # ftol/xtol only trusted on an exact (non-truncated) solve
                if gn < opts.gtol:
                    code = 1
                elif exact and dn < opts.xtol:
                    code = 2
                elif exact and np.isfinite(cost_prev) and abs(cost_prev - c1) <= (
                    self._ftol * max(1.0, abs(cost_prev))
                ):
                    code = 3
                elif self._dtol > 0 and dn < self._dtol and float(lam) <= opts.lam0:
                    code = 6
                cost_prev = c1
                n_rej = 0
            else:
                n_rej += 1
                if dn < (1e-4 if ga.dtype == jnp.float32 else 1e-9):
                    code = 4
                elif n_rej >= 8 or float(lam) >= opts.lam_max:
                    code = 5
            if code:
                break
        it_total = len(hist)
        converged = code in (1, 2, 3, 4, 6) or (code == 5 and n_rej >= 8 and it_total > 3)
        final_cost = float(self._cost(values, rt))
        stats = SolveStats(
            iterations=it_total,
            final_cost=final_cost,
            gnorm=gnorm,
            converged=bool(converged),
            history=hist,
            linear=self.linear,
            reason=self._REASONS.get(code, "max_iters"),
        )
        return values, stats

    # -- outer loop ----------------------------------------------------------
    def solve(self, values=None, rt=None):
        """Run the fused LM solve. ``rt`` (linearize.runtime_state) carries
        the graph's traced data — pass the CURRENT graph's state when this
        solver instance came from the structure cache."""
        ga, opts = self.ga, self.opts
        values = values or ga.values0
        if self._use64:
            values = {t: jnp.asarray(v, jnp.float64) for t, v in values.items()}
        rt = rt if rt is not None else self._rt0
        if self._chordal_sym is not None:
            rt = {**rt, "chordal_nd": self._chordal_dev}
        lam = jnp.asarray(opts.lam0, dtype=ga.dtype)
        if self.linear == "ndchol":
            symr = self._sym_for_rt(rt)
            rt = {**rt, "ndchol": symr._dev}
            _step, loop_fn = self._programs_for(symr)
        else:
            if not hasattr(self, "_solve_loop"):
                self._solve_loop = jax.jit(self._make_solve_loop())
            loop_fn = self._solve_loop
        values, it, code, n_rej, gnorm, final_cost, hist = loop_fn(
            values, lam, rt
        )
        # ONE device_get for every host-needed scalar + the history matrix,
        # not one round-trip per scalar
        it, code, n_rej, gnorm, final_cost, hist = jax.device_get(
            (it, code, n_rej, gnorm, final_cost, hist)
        )
        it = int(it)
        code = int(code)
        hist = [
            dict(
                iter=k,
                cost0=float(h[0]),
                cost1=float(h[1]),
                gnorm=float(h[2]),
                dnorm=float(h[3]),
                accepted=bool(h[4] > 0.5),
                lam=float(h[5]),
                cg=int(h[6]),
            )
            for k, h in enumerate(list(hist)[:it])
        ]
        if opts.verbose:
            for h in hist:
                print(
                    f"  LM it={h['iter']} cost={h['cost0']:.6g}->{h['cost1']:.6g} "
                    f"|g|={h['gnorm']:.3g} |dx|={h['dnorm']:.3g} "
                    f"ok={h['accepted']} lam={h['lam']:.1e}"
                )
        # converged semantics match the old host loop: any tolerance hit
        # counts; "stalled" counts only after enough rejects past warmup
        converged = code in (1, 2, 3, 4, 6) or (
            code == 5 and int(n_rej) >= 8 and it > 3
        )
        stats = SolveStats(
            iterations=it,
            final_cost=float(final_cost),
            gnorm=float(gnorm),
            converged=bool(converged),
            history=hist,
            linear=self.linear,
            reason=self._REASONS.get(code, "max_iters"),
        )
        return values, stats


@dataclass
class SolveStats:
    iterations: int
    final_cost: float
    gnorm: float
    converged: bool
    history: list
    linear: str
    reason: str = ""


# --------------------------- covariance recovery ---------------------------

def _blocked_spd_inverse(H, blk: int = 1024):
    """H^-1 for SPD H via Cholesky + column-blocked triangular solves.

    cho_solve against a full identity OOMs at M3500 scale (XLA keeps ~30
    panel temporaries live); lax.map over column blocks bounds the working
    set, and the final L^-T L^-1 is one matmul."""
    L, _low = jax.scipy.linalg.cho_factor(H, lower=True)
    nD = H.shape[0]
    npad = (-nD) % blk
    eyeP = jnp.eye(nD + npad, dtype=H.dtype)[:, :nD]
    cols = eyeP.reshape(-1, blk, nD)

    def solve_block(c):
        return jax.lax.linalg.triangular_solve(
            L, c, left_side=False, lower=True, transpose_a=False
        )

    Linv = jax.lax.map(solve_block, cols).reshape(nD + npad, nD)[:nD]
    return Linv.T @ Linv


def marginal_covariances(ga: GraphArrays, values, rt=None, method="auto"):
    """Per-variable marginal covariance blocks in the local tangent frame —
    the analogue of the reference's parametric covariance recovery
    (testParametricCovariances.jl:33-55). Returns {type_name: (n, dof, dof)}.

    ``method``:
      - "dense": full-H inverse via blocked Cholesky solves — O(n^3) flops /
        O(n^2) memory; exact, fine for fixtures.
      - "takahashi": selected inversion along the nested-dissection
        elimination tree (sparse/ndchol) — only the inverse entries on the
        filled pattern are computed, so per-pose marginals at M3500 scale
        cost about one extra factorization instead of a dense inverse.
      - "auto": takahashi above ~1500 tangent dims, dense below.

    Assembles in f64 when x64 is enabled (cond(H) ~ 1e8 makes f32 marginals
    unreliable)."""
    use64 = bool(jax.config.jax_enable_x64)
    hdt = jnp.float64 if use64 else ga.dtype
    lins = linearize_all(ga, values, rt)
    if method == "auto":
        method = "takahashi" if ga.total_dof > 1500 else "dense"
    if method == "takahashi":
        return _marginal_covariances_takahashi(ga, lins, rt, hdt)
    H, _g = dense_normal_eqs(ga, lins, dtype=hdt, rt=rt)
    H = H + 1e-8 * jnp.eye(H.shape[0], dtype=hdt)
    cov = _blocked_spd_inverse(H)
    out, off = {}, 0
    for t in ga.type_names:
        n, d = ga.counts[t], ga.manifolds[t].dof
        if n == 0:
            out[t] = jnp.zeros((0, d, d), dtype=ga.dtype)
            continue
        idx = off + jnp.arange(n)[:, None] * d + jnp.arange(d)[None, :]
        out[t] = cov[idx[:, :, None], idx[:, None, :]].astype(ga.dtype)
        off += n * d
    return out


def _marginal_covariances_takahashi(ga: GraphArrays, lins, rt, hdt):
    """Sparse covariance recovery: ND multifrontal factorization + Takahashi
    selected inversion, then gather each variable's dof x dof diagonal block
    from its supernode front (a variable's tangent dims are contiguous in
    one supernode by construction of the var-level dissection)."""
    from rome_tpu.solvers.sparse import (
        ndchol_assemble, ndchol_factorize, ndchol_takahashi, symbolic_factor,
    )

    rt = rt if rt is not None else runtime_state(ga)
    # cache keyed on the rt's actual connectivity (vslots bytes) — the same
    # GraphArrays can be solved under alternate-connectivity rts, and a plan
    # cached by ga identity alone would silently return wrong covariances
    key = tuple(np.asarray(v).tobytes() for v in rt["vslots"])
    cached = getattr(ga, "_cov_sym", None)
    sym = cached[1] if cached is not None and cached[0] == key else None
    if sym is None:
        dofs = {t: ga.manifolds[t].dof for t in ga.type_names}
        specs = [
            (b.vtypes, np.asarray(v)) for b, v in zip(ga.batches, rt["vslots"])
        ]
        sym = symbolic_factor(ga.type_names, ga.counts, dofs, specs)
        sym._dev = sym.device_arrs()
        ga._cov_sym = (key, sym)
    arrs = sym._dev
    vals = normal_eq_entry_values(ga, lins, dtype=hdt)
    fvec = free_vector(ga, rt).astype(hdt)
    diag_H = (
        jnp.zeros(sym.D, hdt)
        .at[arrs["diag_dst"]]
        .add(vals[arrs["diag_src"]] * fvec[arrs["diag_dst"]] ** 2)
    )
    # lam=0 (undamped information matrix) + tiny jitter for SPD safety,
    # matching the dense path's 1e-8 ridge
    dv = 1.0 / jnp.sqrt(jnp.maximum(diag_H, 1e-12))
    df = dv * fvec
    jit_rel = jnp.asarray(1e-8, hdt)
    diag_add = fvec * jit_rel + (1.0 - fvec)
    Ws = ndchol_assemble(sym, arrs, vals, df, diag_add)
    Linvs, L21s, _ = ndchol_factorize(sym, arrs, Ws)
    Xs = ndchol_takahashi(sym, arrs, Linvs, L21s)
    # un-scale: cov = D X D restricted to each variable's block; gather via
    # each scalar dim's (level, node, supernode offset) coordinates
    base, _D = tangent_offsets(ga)
    out = {}
    # flatten all per-level X fronts once; per-variable gather by index maps
    flat = {}
    for l in range(sym.nlev):
        if Xs[l] is not None:
            flat[l] = Xs[l].reshape(-1)
    # host-side index math (symbolic arrays are numpy)
    for t in ga.type_names:
        n, d = ga.counts[t], ga.manifolds[t].dof
        if n == 0:
            out[t] = jnp.zeros((0, d, d), dtype=ga.dtype)
            continue
        scal = base[t] + np.arange(n * d).reshape(n, d)
        gidx = np.zeros((n, d, d), np.int64)
        glev = np.zeros((n,), np.int64)
        for l in range(sym.nlev):
            n_l, sm, bm = sym.plan[l]
            if n_l == 0:
                continue
            sup_idx = np.asarray(sym.arrs[f"sup_idx_{l}"])  # (n_l, sm)
            # scalar -> (node_local, offset) map for this level
            pos = {}
            for j in range(n_l):
                for a in range(sm):
                    s = sup_idx[j, a]
                    if s < sym.D:
                        pos[int(s)] = (j, a)
            f = sm + bm
            for i in range(n):
                s0 = int(scal[i, 0])
                if s0 in pos:
                    j, a = pos[s0]
                    offs = np.array(
                        [pos[int(scal[i, k])][1] for k in range(d)]
                    )
                    assert (np.array(
                        [pos[int(scal[i, k])][0] for k in range(d)]
                    ) == j).all(), "variable split across supernodes"
                    gidx[i] = (
                        j * f * f + offs[:, None] * f + offs[None, :]
                    )
                    glev[i] = l
        # gather per level
        blocks = jnp.zeros((n, d, d), hdt)
        for l in range(sym.nlev):
            sel = np.where(glev == l)[0]
            if len(sel) == 0 or l not in flat:
                continue
            got = flat[l][jnp.asarray(gidx[sel].reshape(-1))]
            blocks = blocks.at[jnp.asarray(sel)].set(
                got.reshape(len(sel), d, d)
            )
        dvar = df[jnp.asarray(scal)]  # (n, d) — includes free mask
        out[t] = (blocks * dvar[:, :, None] * dvar[:, None, :]).astype(
            ga.dtype
        )
    return out
