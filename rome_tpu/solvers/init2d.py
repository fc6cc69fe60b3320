"""Chordal two-stage linear initialization for 2D pose graphs.

The reference relies on odometry-chain propagation for init (IIF graphinit /
initParametricFrom, e.g. examples/ManhattanDatasetBatch.jl:30-41). For large
loop-closure graphs that start is far outside the LM basin. The answer here
is the classic chordal initialization (Carlone et al.) expressed as two
*linear* least-squares solves, both assembled as normal equations
(scatter-adds) and factorized on the device:

  stage 1 (rotation, chordal relaxation): parametrize each rotation by its
    unnormalized first column u_i = (c_i, s_i). The edge constraint
    R_j = R_i R(z_th) is LINEAR in u:  r = u_j - R(z_th) u_i. No angle
    variable ever appears, so there is NO wrap sensitivity — the relaxation
    is globally convergent regardless of the starting point (unlike a
    theta-Laplacian pass, which inherits the wrap basin of the odometry
    init: measured cost-after-init on M3500 was 8.6e6 for the theta pass vs
    1.3e5 for the relaxation). theta = atan2(s, c) afterwards.
  stage 2 (translation): given rotations, R_i^T (t_j - t_i) = z_t is linear
    in t -> one 2x2-block-structured LS solve.

Frozen (free=0) poses are held bit-identical (fixed-lag contract,
testFixedLagFG.jl:115) — they enter stage solves as pinned boundary values.
After this init the full LM converges in ~12 iterations on Manhattan-3500
and reaches the global basin on MIT (cost 20.6 vs the 383.8 local minimum
that odometry init falls into).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from rome_tpu.graph.lower import GraphArrays
from rome_tpu.utils.math import full_f32_matmuls, rot2

_ODO_BATCHES = ("Pose2Pose2", "MutablePose2Pose2Gaussian")


def _pose2_edges(ga: GraphArrays):
    es = []
    for b in ga.batches:
        if b.ftype.name in _ODO_BATCHES:
            es.append(
                (b.vslots[:, 0], b.vslots[:, 1], b.params["z"], b.params["sqrt_info"], b.weight)
            )
    return es


def _pose2_priors(ga: GraphArrays):
    out = []
    for b in ga.batches:
        if b.ftype.name == "PriorPose2":
            out.append((b.vslots[:, 0], b.params["z"], b.params["sqrt_info"], b.weight))
    return out


@full_f32_matmuls
def _solve_spd_delta(A, g, free, dtype, matvec=None):
    """GN step for a linear problem: solve A dx = -g with frozen rows pinned
    to dx = 0 (their coupling into free rows is already inside g = A x - b).

    The chordal normal matrices are graph Laplacians — condition number grows
    like diameter^2, so a pure-f32 factorization (plus a 1e-6 jitter) loses
    the init quality entirely (measured on M3500: cost-after-init 2.7e7 in
    f32 vs 1.3e5 exact). Assemble/refine in f64 when x64 is live, factorize
    in f32: Jacobi scaling + f32 Cholesky + f64 CG refinement.

    ``matvec``: optional UNPINNED A@x in refinement precision — the
    edge-based O(m) product in place of the dense (2n)^2 one."""
    f = free.astype(A.dtype)
    A = A * (f[:, None] * f[None, :]) + jnp.diag(1.0 - f)
    # symmetric Jacobi scaling onto a unit diagonal
    d = 1.0 / jnp.sqrt(jnp.maximum(jnp.diag(A), 1e-12))
    bs = -g * d
    f32 = jnp.float32
    As32 = (A * d[:, None] * d[None, :]).astype(f32) + 1e-6 * jnp.eye(
        A.shape[0], dtype=f32
    )
    L, low = jax.scipy.linalg.cho_factor(As32, lower=True)
    # explicit triangular inverse: the CG below applies the preconditioner
    # up to 30x, each time as two matvecs instead of two triangular solves
    Linv = jax.lax.linalg.triangular_solve(
        L, jnp.eye(L.shape[0], dtype=f32), left_side=True, lower=True
    )

    def _prec32(r32):
        return Linv.T @ (Linv @ r32)

    rdt = g.dtype  # refinement precision (f64 when x64 is live)
    y = _prec32(bs.astype(f32)).astype(rdt)
    if rdt != f32:
        # f64 CG on the scaled system, preconditioned by the f32 factor —
        # converges where plain iterative refinement (Richardson) stalls
        # once eps32 * cond exceeds 1 (Laplacian cond ~ diameter^2).
        if matvec is None:
            As64 = (A * d[:, None] * d[None, :]).astype(rdt)

            def apply_s(v):
                return As64 @ v
        else:
            one_minus_f = 1.0 - f

            def apply_s(v):
                x = d * v
                y_ = f * matvec(f * x) + one_minus_f * x
                return d * y_

        def prec(r):
            return _prec32(r.astype(f32)).astype(rdt)

        x = y
        r = bs - apply_s(x)
        z = prec(r)
        p = z
        rz = jnp.vdot(r, z)
        bn = jnp.linalg.norm(bs) + 1e-300

        def body(state):
            x, r, z, p, rz, k = state
            Ap = apply_s(p)
            alpha = rz / jnp.vdot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = prec(r)
            rz2 = jnp.vdot(r, z)
            p = z + (rz2 / rz) * p
            return (x, r, z, p, rz2, k + 1)

        def cond(state):
            # tol sized for an INITIALIZER — but not loosely: capping at
            # 12 iters / 1e-5 left the M3500 init at cost 8.4e6 (vs 1.3e5
            # converged), sending LM into the wrong basin. 1e-7 keeps init
            # quality; the cap stays as the hard budget.
            _x, r, _z, _p, _rz, k = state
            return jnp.logical_and(
                k < 30, jnp.linalg.norm(r) > 1e-7 * bn
            )

        x, r, _z, _p, _rz, _k = jax.lax.while_loop(
            cond, body, (x, r, z, p, rz, jnp.zeros((), jnp.int32))
        )
        # safeguard: fall back to the single f32 solve if CG diverged
        y = jnp.where(
            jnp.linalg.norm(bs - apply_s(x)) <= jnp.linalg.norm(bs - apply_s(y)),
            x,
            y,
        )
    return (y * d * f).astype(dtype)


def _ndchol_spd_delta(sym, nd, vals_vec, g, free2, matvec, out_dtype,
                      tol=1e-7, ridge=1e-6):
    """Sparse twin of :func:`_solve_spd_delta`: ND multifrontal f32
    factorization of the 2-dof chordal system as the preconditioner of a
    refinement-precision CG against the edge-based matvec. No dense (2n)^2
    object anywhere."""
    from rome_tpu.solvers.sparse import (
        ndchol_assemble, ndchol_factorize, ndchol_solve,
    )

    f32 = jnp.float32
    rdt = g.dtype
    f = free2.astype(f32)
    vals32 = vals_vec.astype(f32)
    diag_A = (
        jnp.zeros(sym.D, f32)
        .at[nd["diag_dst"]]
        .add(vals32[nd["diag_src"]] * f[nd["diag_dst"]] ** 2)
    )
    dv = jax.lax.rsqrt(jnp.maximum(diag_A, 1e-12))
    df = dv * f
    diag_add = f * ridge + (1.0 - f)  # preconditioner ridge (see sweep note)
    Ws = ndchol_assemble(sym, nd, vals32, df, diag_add)
    # blocked=False: the refinement CG must reach 1e-7 within its cap;
    # the recursive blocked factor's extra f32 rounding made it cap out
    Linvs, L21s, _L11s = ndchol_factorize(sym, nd, Ws, blocked=False)

    def minv(r):
        y = ndchol_solve(sym, nd, Linvs, L21s, r.astype(f32) * df)
        return (y * df).astype(rdt)

    frdt = free2.astype(rdt)
    b = (-g) * frdt
    x0 = jnp.zeros_like(b)
    if rdt == f32:
        return (minv(b) * frdt).astype(out_dtype)
    one_minus = 1.0 - frdt

    def apply_A(v):
        return frdt * matvec(frdt * v) + one_minus * v

    bn = jnp.linalg.norm(b) + 1e-300

    def cond(state):
        # default tolerance 1e-7: the M3500 flat valley is BRUTALLY
        # sensitive to ROTATION-stage init precision — measured end-to-end
        # ATE by chordal CG tol: 1e-7 -> 0.005-0.017 m, 3e-7 -> 1.41 m,
        # 1e-6 -> 0.34 m (gate 0.1 m). Do not loosen the rotation stage.
        _x, r, _p, _rz, k = state
        return jnp.logical_and(k < 30, jnp.linalg.norm(r) > tol * bn)

    def body(state):
        x, r, p, rz, k = state
        z = minv(r)
        rz2 = jnp.vdot(r, z)
        beta = jnp.where(k == 0, 0.0, rz2 / jnp.where(jnp.abs(rz) < 1e-300,
                                                      1e-300, rz))
        p = z + beta * p
        Ap = apply_A(p)
        alpha = rz2 / jnp.where(jnp.abs(jnp.vdot(p, Ap)) < 1e-300, 1e-300,
                                jnp.vdot(p, Ap))
        return (x + alpha * p, r - alpha * Ap, p, rz2, k + 1)

    x, _r, _p, _rz, _k = jax.lax.while_loop(
        cond, body,
        (x0, b, jnp.zeros_like(b), jnp.zeros((), rdt),
         jnp.zeros((), jnp.int32)),
    )
    return (x * frdt).astype(out_dtype)


_CHORDAL_CACHE: dict = {}

# above this many poses the two stage solves go SPARSE: the same
# nested-dissection multifrontal machinery as the main ndchol solver, on the
# (c,s)/(x,y) 2-dof systems (the dense (2n)^2 assembly+factorization was the
# last O(n^3) block in the whole M3500 pipeline)
_SPARSE_THRESHOLD = 300

# Chordal solve tunables (chosen with end-to-end ATE validation on M3500):
# - leaf 64 (vs the sparse solver's default 16) halves the ND tree depth of
#   the 2-dof systems; each CG application is a 2-sweep level walk, so
#   fewer levels = fewer sequential small kernels per iteration.
# - ridge 1e-7 on the f32 preconditioner: faster CG contraction than 1e-6,
#   ATE unchanged.
# - BOTH stage tolerances stay 1e-7: loosening the TRANSLATION stage to
#   1e-4 looked harmless in isolation (init 66 ms) but sent the full LM
#   to 27-30 iterations and ATE 3.3-6.0 m (gate 0.1) — the flat-valley
#   basin is set by translation init quality as much as rotation.
_CHORDAL_LEAF = 64
_CHORDAL_RIDGE = 1e-7
_CHORDAL_TOL_ROT = 1e-7
_CHORDAL_TOL_TRANS = 1e-7


def _chordal_symbolic(n, edges, priors, leaf=None):
    """Symbolic ND factorization of the 2-dof chordal systems (both stages
    share the pose graph's sparsity)."""
    import numpy as np

    from rome_tpu.solvers.sparse import symbolic_factor

    specs = []
    for i, j, _z, _S, _w in edges:
        specs.append(
            (("U", "U"),
             np.stack([np.asarray(i), np.asarray(j)], axis=1).astype(np.int64))
        )
    for idx, _z, _S, _w in priors:
        specs.append((("U",), np.asarray(idx)[:, None].astype(np.int64)))
    return symbolic_factor(
        ["U"], {"U": n}, {"U": 2}, specs,
        leaf=leaf if leaf is not None else _CHORDAL_LEAF,
    )


def chordal_init_pose2(ga: GraphArrays, values, dense_limit: int = 20000):
    """Return values with the Pose2 block re-initialized. Other variable
    types pass through untouched. The whole two-stage solve is ONE jitted
    program, cached per structure."""
    if "Pose2" not in ga.counts:
        return values
    n = ga.counts["Pose2"]
    edges = _pose2_edges(ga)
    if not edges:
        return values
    priors = _pose2_priors(ga)

    # the connectivity component of the signature costs device->host
    # fetches of the vslot arrays — compute once per GraphArrays object
    sig = getattr(ga, "_chordal_sig", None)
    if sig is None:
        sig = (
            n,
            str(ga.dtype),
            (_CHORDAL_LEAF, _CHORDAL_RIDGE, _CHORDAL_TOL_ROT,
             _CHORDAL_TOL_TRANS),
            tuple(e[2].shape for e in edges),
            tuple(p[1].shape for p in priors),
            # full connectivity: source AND target slots for edges, plus
            # prior slots — hashing sources alone can collide two graphs
            # with equal counts but different targets, silently reusing the
            # wrong symbolic scatter maps
            tuple(
                np.asarray(e[0]).tobytes() + np.asarray(e[1]).tobytes()
                for e in edges
            )
            if n >= _SPARSE_THRESHOLD else None,
            tuple(np.asarray(p[0]).tobytes() for p in priors)
            if n >= _SPARSE_THRESHOLD else None,
        )
        ga._chordal_sig = sig
    cached = _CHORDAL_CACHE.get(sig)
    if cached is None:
        if n >= _SPARSE_THRESHOLD:
            sym = _chordal_symbolic(n, edges, priors)
            sym_dev = sym.device_arrs()
        else:
            sym, sym_dev = None, {}
        fn = jax.jit(
            lambda v, e, p, f, nd: _chordal_body(
                ga.dtype, n, v, e, p, f, sym, nd
            )
        )
        cached = (fn, sym_dev)
        _CHORDAL_CACHE[sig] = cached
    fn, sym_dev = cached
    pose2 = fn(values["Pose2"], edges, priors, ga.free["Pose2"], sym_dev)
    out = dict(values)
    out["Pose2"] = pose2
    return out


@full_f32_matmuls
def _chordal_body(dtype, n, pose2_values, edges, priors, free, sym=None,
                  nd=None):
    # assembly/refinement precision: f64 when x64 is live (the Laplacian
    # solves need it — see _solve_spd_delta), else the graph dtype
    adt = jnp.float64 if jax.config.jax_enable_x64 else dtype
    th0 = pose2_values[:, 2].astype(adt)
    t0 = pose2_values[:, :2].astype(adt)
    edges = [
        (i, j, z.astype(adt), S.astype(adt), w.astype(adt))
        for i, j, z, S, w in edges
    ]
    priors = [
        (i, z.astype(adt), S.astype(adt), w.astype(adt))
        for i, z, S, w in priors
    ]
    dtype, out_dtype = adt, dtype

    def idx2(i):
        return 2 * i[:, None] + jnp.arange(2)[None, :]  # (m, 2)

    # -------- stage 1: chordal rotation relaxation (linear in (c, s)) ------
    # unknown u_i = (cos th_i, sin th_i) unnormalized; edge residual
    # r = w * (u_j - R(z_th) u_i); prior residual r = w * (u_i - u_target).
    # Solved as one GN step from the current u (linear => exact), frozen
    # poses pinned so their u never moves.
    u0 = jnp.stack([jnp.cos(th0), jnp.sin(th0)], axis=-1)  # (n, 2)
    # the dense normal matrix only feeds the f32 factorization — assemble
    # it in f32; gradient + CG matvec stay in refinement precision
    f32m = jnp.float32
    sparse = sym is not None
    A = None if sparse else jnp.zeros((2 * n, 2 * n), dtype=f32m)
    vals1 = []  # sparse-path contribution blocks, entry_coords order
    g = jnp.zeros((n, 2), dtype=dtype)
    for i, j, z, S, w in edges:
        wq = (S[:, 2, 2] * w) ** 2  # info weight of the rotation row
        cz, sz = jnp.cos(z[:, 2]), jnp.sin(z[:, 2])
        Rz = jnp.stack(
            [jnp.stack([cz, -sz], -1), jnp.stack([sz, cz], -1)], -2
        )  # (m, 2, 2)
        r = u0[j] - jnp.einsum("nij,nj->ni", Rz, u0[i])  # (m, 2)
        # g = A u - b contributions: J_j = I, J_i = -Rz
        g = g.at[j].add(wq[:, None] * r)
        g = g.at[i].add(-wq[:, None] * jnp.einsum("nji,nj->ni", Rz, r))
        eye2 = jnp.broadcast_to(jnp.eye(2, dtype=f32m), Rz.shape)
        wI = (wq[:, None, None]).astype(f32m) * eye2
        wRz = (wq[:, None, None] * Rz).astype(f32m)
        if sparse:
            # (k,l) block order matches sparse.symbolic.entry_coords for a
            # 2-slot batch with vslots (i, j):
            # (0,0)->A[i,i]=wI  (0,1)->A[i,j]=-wRz^T
            # (1,0)->A[j,i]=-wRz  (1,1)->A[j,j]=wI
            vals1 += [wI.reshape(-1),
                      (-jnp.swapaxes(wRz, -1, -2)).reshape(-1),
                      (-wRz).reshape(-1), wI.reshape(-1)]
        else:
            ii, jj = idx2(i), idx2(j)
            A = A.at[jj[:, :, None], jj[:, None, :]].add(wI)
            A = A.at[ii[:, :, None], ii[:, None, :]].add(wI)  # Rz^T Rz = I
            A = A.at[jj[:, :, None], ii[:, None, :]].add(-wRz)
            A = A.at[ii[:, :, None], jj[:, None, :]].add(
                -jnp.swapaxes(wRz, -1, -2)
            )
    for idx, z, S, w in priors:
        wq = (S[:, 2, 2] * w) ** 2
        ut = jnp.stack([jnp.cos(z[:, 2]), jnp.sin(z[:, 2])], -1)
        g = g.at[idx].add(wq[:, None] * (u0[idx] - ut))
        eye2 = jnp.broadcast_to(jnp.eye(2, dtype=f32m), (idx.shape[0], 2, 2))
        wI = (wq[:, None, None]).astype(f32m) * eye2
        if sparse:
            vals1.append(wI.reshape(-1))
        else:
            ii = idx2(idx)
            A = A.at[ii[:, :, None], ii[:, None, :]].add(wI)
    def mv_rot(xf):
        # edge-based A@x, O(m)
        x = xf.reshape(n, 2)
        y = jnp.zeros_like(x)
        for i, j, z, S, w in edges:
            wq = (S[:, 2, 2] * w) ** 2
            cz, sz = jnp.cos(z[:, 2]), jnp.sin(z[:, 2])
            Rz = jnp.stack(
                [jnp.stack([cz, -sz], -1), jnp.stack([sz, cz], -1)], -2
            )
            e = x[j] - jnp.einsum("nij,nj->ni", Rz, x[i])
            y = y.at[j].add(wq[:, None] * e)
            y = y.at[i].add(-wq[:, None] * jnp.einsum("nji,nj->ni", Rz, e))
        for idx, z, S, w in priors:
            wq = (S[:, 2, 2] * w) ** 2
            y = y.at[idx].add(wq[:, None] * x[idx])
        return y.reshape(-1)

    f2 = jnp.repeat(free, 2)
    if sparse:
        du = _ndchol_spd_delta(
            sym, nd, jnp.concatenate(vals1), g.reshape(-1), f2, mv_rot,
            dtype, tol=_CHORDAL_TOL_ROT, ridge=_CHORDAL_RIDGE,
        )
    else:
        du = _solve_spd_delta(A, g.reshape(-1), f2, dtype, matvec=mv_rot)
    u = u0 + du.reshape(n, 2)
    th = jnp.where(free > 0, jnp.arctan2(u[:, 1], u[:, 0]), th0)

    # -------- stage 2: translations (single linear solve) ------------------
    R = rot2(th)
    A = None if sparse else jnp.zeros((2 * n, 2 * n), dtype=f32m)
    vals2 = []
    g = jnp.zeros((n, 2), dtype=dtype)

    for i, j, z, S, w in edges:
        St = S[:, :2, :2]
        W = jnp.einsum("nij,nik->njk", St, St) * (w ** 2)[:, None, None]  # (m,2,2)
        Ri = R[i]
        # r = R_i^T (t_j - t_i) - dt;  J_tj = R_i^T, J_ti = -R_i^T
        r = jnp.einsum("nji,nj->ni", Ri, t0[j] - t0[i]) - z[:, :2]
        RW = jnp.einsum("nij,njk->nik", Ri, W)          # R_i W
        RWRt = jnp.einsum("nik,nlk->nil", RW, Ri)       # R_i W R_i^T
        RWr = jnp.einsum("nij,nj->ni", RW, r)
        g = g.at[j].add(RWr).at[i].add(-RWr)
        RWRt32 = RWRt.astype(f32m)
        if sparse:
            # (0,0)->A[i,i]  (0,1)->A[i,j]  (1,0)->A[j,i]  (1,1)->A[j,j]
            vals2 += [RWRt32.reshape(-1), (-RWRt32).reshape(-1),
                      (-RWRt32).reshape(-1), RWRt32.reshape(-1)]
        else:
            ii, jj = idx2(i), idx2(j)
            A = A.at[jj[:, :, None], jj[:, None, :]].add(RWRt32)
            A = A.at[ii[:, :, None], ii[:, None, :]].add(RWRt32)
            A = A.at[jj[:, :, None], ii[:, None, :]].add(-RWRt32)
            A = A.at[ii[:, :, None], jj[:, None, :]].add(-RWRt32)
    for idx, z, S, w in priors:
        St = S[:, :2, :2]
        W = jnp.einsum("nij,nik->njk", St, St) * (w ** 2)[:, None, None]
        r = t0[idx] - z[:, :2]
        g = g.at[idx].add(jnp.einsum("njk,nk->nj", W, r))
        if sparse:
            vals2.append(W.astype(f32m).reshape(-1))
        else:
            ii = idx2(idx)
            A = A.at[ii[:, :, None], ii[:, None, :]].add(W.astype(f32m))

    def mv_tr(xf):
        x = xf.reshape(n, 2)
        y = jnp.zeros_like(x)
        for i, j, z, S, w in edges:
            St = S[:, :2, :2]
            W = jnp.einsum("nij,nik->njk", St, St) * (w ** 2)[:, None, None]
            Ri = R[i]
            RWRt = jnp.einsum(
                "nik,nlk->nil", jnp.einsum("nij,njk->nik", Ri, W), Ri
            )
            e = jnp.einsum("nij,nj->ni", RWRt, x[j] - x[i])
            y = y.at[j].add(e).at[i].add(-e)
        for idx, z, S, w in priors:
            St = S[:, :2, :2]
            W = jnp.einsum("nij,nik->njk", St, St) * (w ** 2)[:, None, None]
            y = y.at[idx].add(jnp.einsum("nij,nj->ni", W, x[idx]))
        return y.reshape(-1)

    f2 = jnp.repeat(free, 2)
    if sparse:
        dt = _ndchol_spd_delta(
            sym, nd, jnp.concatenate(vals2), g.reshape(-1), f2, mv_tr, dtype,
            tol=_CHORDAL_TOL_TRANS, ridge=_CHORDAL_RIDGE,
        )
    else:
        dt = _solve_spd_delta(A, g.reshape(-1), f2, dtype, matvec=mv_tr)
    t = t0 + dt.reshape(n, 2)
    # frozen poses stay bit-identical to the input (fixed-lag contract)
    out = jnp.concatenate([t, th[:, None]], axis=-1).astype(out_dtype)
    return jnp.where(free[:, None] > 0, out, pose2_values)
