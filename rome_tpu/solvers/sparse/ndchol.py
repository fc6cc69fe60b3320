"""Device numeric phase of the nested-dissection multifrontal Cholesky.

Everything here is traced into the caller's XLA program: one scatter-add
assembly into per-level padded front tensors, a leaf-to-root sweep of
batched dense partial Cholesky factorizations, and two tree sweeps for the
solve. Static structure comes from the :class:`SymbolicChol` plan (closed
over); all index maps arrive as traced ARGUMENTS (``arrs``) so no multi-MB
constant is baked into the program and one trace serves any graph with the
same map shapes.

Every matrix product here is f32 at full precision (``full_f32_matmuls``):
the factor preconditions the solver's CG, and a TF32 factor costs LM
iterations.

Scaling convention (matches the dense32 solver, gauss_newton.py): the
caller assembles the Jacobi-scaled damped system Hs = D (H + lam*diag(H)) D
with unit diagonal, via per-entry scale factors; here we only add
``diag_add`` (damping remainder + jitter + frozen identity) plus 1.0 on
padding diagonals.

Reference contract: the per-clique dense factorizations of the reference's
Bayes-tree solve (SURVEY.md §3.4), batched per tree level.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from rome_tpu.utils.math import full_f32_matmuls


def _tri(L, B, *, trans, left=True):
    """Batched lower-triangular solve; B is (..., n, k)."""
    return lax.linalg.triangular_solve(
        L, B, left_side=left, lower=True, transpose_a=trans
    )


def _tri_inv_blocked(L):
    """Batched lower-triangular inverse via recursive 2x2-block Schur:

        [[A, 0], [B, C]]^-1 = [[A^-1, 0], [-C^-1 B A^-1, C^-1]]

    — all batched matmuls instead of triangular substitution. Rounding is
    a whisker different from substitution; the factor is a CG-corrected
    preconditioner, and the Takahashi covariance path is gated by the f64
    cross-check in bench.py."""
    m = L.shape[-1]
    if m <= 32:
        eye = jnp.broadcast_to(
            jnp.eye(m, dtype=L.dtype), L.shape[:-2] + (m, m)
        )
        return _tri(L, eye, trans=False)
    h = m // 2
    A = L[..., :h, :h]
    B = L[..., h:, :h]
    C = L[..., h:, h:]
    Ai = _tri_inv_blocked(A)
    Ci = _tri_inv_blocked(C)
    X = -(Ci @ (B @ Ai))
    top = jnp.concatenate(
        [Ai, jnp.zeros(L.shape[:-2] + (h, m - h), L.dtype)], axis=-1
    )
    bot = jnp.concatenate([X, Ci], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def _chol_blocked(A):
    """Batched Cholesky via recursive 2x2 blocking — the inner panel
    factorizations bottom out in small native cholesky calls and
    everything else is matmuls. A non-SPD input still surfaces NaNs
    through the base-case cholesky (the LM loop's NaN-pivot rejection
    contract is unchanged)."""
    m = A.shape[-1]
    if m <= 32:
        return jnp.linalg.cholesky(A)
    h = m // 2
    A11 = A[..., :h, :h]
    A21 = A[..., h:, :h]
    A22 = A[..., h:, h:]
    L11 = _chol_blocked(A11)
    L21 = A21 @ jnp.swapaxes(_tri_inv_blocked(L11), -1, -2)
    S = A22 - L21 @ jnp.swapaxes(L21, -1, -2)
    L22 = _chol_blocked(S)
    top = jnp.concatenate(
        [L11, jnp.zeros(A.shape[:-2] + (h, m - h), A.dtype)], axis=-1
    )
    bot = jnp.concatenate([L21, L22], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def ndchol_assemble(sym, arrs, vals, scale_vec, diag_add):
    """Build per-level front tensors from scaled entry contributions.

    vals: (E,) raw J^T J entry contributions (dtype f32).
    scale_vec: (D,) per-scalar-dim scale (d * free) — entries are scaled by
      scale_vec[row]*scale_vec[col].
    diag_add: (D,) value added to each real diagonal front position.
    Returns list of (n_l, fmax_l, fmax_l) front tensors.
    """
    sv = vals * scale_vec[arrs["rows"]] * scale_vec[arrs["cols"]]
    Ws = []
    for l, (n_l, sm, bm) in enumerate(sym.plan):
        f = sm + bm
        w = jnp.zeros((n_l * f * f,), vals.dtype)
        if n_l == 0:
            Ws.append(w.reshape(n_l, f, f))
            continue
        w = w.at[arrs[f"asm_dst_{l}"]].add(sv[arrs[f"asm_src_{l}"]])
        w = w.at[arrs[f"dummy_diag_{l}"]].add(1.0)
        w = w.at[arrs[f"real_diag_{l}"]].add(
            diag_add[arrs[f"real_diag_scalar_{l}"]]
        )
        Ws.append(w.reshape(n_l, f, f))
    return Ws


@full_f32_matmuls
def ndchol_factorize(sym, arrs, Ws, blocked=False):
    """Leaf-to-root batched partial Cholesky with fan-in Schur scatters.

    Per level: ONE batched Cholesky, ONE batched triangular inversion
    (L11^{-1} against identity), then everything downstream — L21, Schur
    update, and BOTH solve sweeps — is batched matmul. The explicit
    triangular inverse trades a little backward stability (fine: the factor
    is a CG preconditioner, f64 CG corrects it) for removing every
    triangular_solve from the sweeps.

    Returns (Linvs, L21s, L11s) lists per level."""
    Ws = list(Ws)
    flat = [W.reshape(-1) for W in Ws]
    Linvs, L21s, L11s = [], [], []
    for l, (n_l, sm, bm) in enumerate(sym.plan):
        if n_l == 0:
            Linvs.append(None)
            L21s.append(None)
            L11s.append(None)
            continue
        W = flat[l].reshape(n_l, sm + bm, sm + bm)
        A11 = W[:, :sm, :sm]
        # blocked=True: recursive matmul-only chol+inverse. Its extra f32
        # rounding makes the factor a weaker preconditioner (the chordal
        # CG caps out and LM needs more iterations). Default stays native.
        if blocked:
            L11 = _chol_blocked(A11)
            Linv = _tri_inv_blocked(L11)
        else:
            L11 = jnp.linalg.cholesky(A11)
            eye = jnp.broadcast_to(
                jnp.eye(sm, dtype=W.dtype), (n_l, sm, sm)
            )
            Linv = _tri(L11, eye, trans=False)
        L11s.append(L11)
        Linvs.append(Linv)
        if bm == 0:
            L21s.append(None)
            continue
        A21 = W[:, sm:, :sm]
        L21 = A21 @ jnp.swapaxes(Linv, -1, -2)  # A21 L11^{-T}
        L21s.append(L21)
        U = W[:, sm:, sm:] - L21 @ jnp.swapaxes(L21, -1, -2)
        u = U.reshape(-1)
        for (ll, m) in sym.ea_pairs:
            if ll != l:
                continue
            flat[m] = flat[m].at[arrs[f"ea_dst_{l}_{m}"]].add(
                u[arrs[f"ea_src_{l}_{m}"]]
            )
    return Linvs, L21s, L11s


@full_f32_matmuls
def ndchol_solve(sym, arrs, Linvs, L21s, b):
    """Two tree sweeps: solve (L L^T) x = b for the scaled system — all
    batched matmuls + precomputed scatters/gathers, zero triangular solves.

    b: (D,) in the factor dtype. Returns x: (D,)."""
    dt = b.dtype
    # scatter RHS into per-level supernode slots
    Rs = []
    for l, (n_l, sm, bm) in enumerate(sym.plan):
        r = jnp.zeros((n_l * sm,), dt)
        if n_l and sm:
            r = r.at[arrs[f"rhs_dst_{l}"]].set(b[arrs[f"rhs_src_{l}"]])
        Rs.append(r)
    # forward: L y = b (leaf-to-root)
    ys = []
    for l, (n_l, sm, bm) in enumerate(sym.plan):
        if n_l == 0 or sm == 0:
            ys.append(None)
            continue
        R = Rs[l].reshape(n_l, sm, 1)
        y = Linvs[l] @ R
        ys.append(y[..., 0])
        if bm == 0:
            continue
        u = -(L21s[l] @ y)[..., 0]  # (n_l, bm)
        uf = u.reshape(-1)
        for (ll, m) in sym.fea_pairs:
            if ll != l:
                continue
            Rs[m] = Rs[m].at[arrs[f"fea_dst_{l}_{m}"]].add(
                uf[arrs[f"fea_src_{l}_{m}"]]
            )
    # backward: L^T x = y (root-to-leaf)
    x = jnp.zeros((sym.D + 1,), dt)
    for l in range(sym.nlev - 1, -1, -1):
        n_l, sm, bm = sym.plan[l]
        if n_l == 0 or sm == 0:
            continue
        t = ys[l]
        if bm:
            xb = x[arrs[f"bnd_idx_{l}"]] * arrs[f"bnd_mask_{l}"].astype(dt)
            t = t - jnp.einsum("nbs,nb->ns", L21s[l], xb)
        xs = jnp.einsum("nsk,nk->ns", jnp.swapaxes(Linvs[l], -1, -2), t)
        x = x.at[arrs[f"sup_idx_{l}"].reshape(-1)].set(xs.reshape(-1))
    return x[: sym.D]


def ndchol_logdet(sym, L11s):
    """log det of the scaled damped system (sum of 2*log diag(L11), real
    columns only — padding diagonals are exactly 1)."""
    out = 0.0
    for l, L11 in enumerate(L11s):
        if L11 is None:
            continue
        d = jnp.diagonal(L11, axis1=-2, axis2=-1)
        out = out + 2.0 * jnp.sum(jnp.log(jnp.maximum(d, 1e-30)))
    return out


@full_f32_matmuls
def ndchol_takahashi(sym, arrs, Linvs, L21s):
    """Selected inverse on the filled pattern (Takahashi), root-to-leaf.

    Returns per-level X_front tensors (n_l, fmax_l, fmax_l) holding
    [[X_SS, X_SB], [X_BS, X_BB]] of the SCALED system inverse; callers
    un-scale marginal blocks with the Jacobi d vector. Level-batched:
    X_BB is gathered from already-computed ancestor fronts via the same
    fan-in index maps used at factorization (run in reverse as gathers)."""
    # flat concatenated storage for gathers across levels
    sizes = [n * (sm + bm) * (sm + bm) for (n, sm, bm) in sym.plan]
    offs = [0]
    for s in sizes:
        offs.append(offs[-1] + s)
    dt = None
    for L in Linvs:
        if L is not None:
            dt = L.dtype
            break
    xall = jnp.zeros((offs[-1] + 1,), dt)  # +1 dump slot
    Xs = [None] * sym.nlev
    for l in range(sym.nlev - 1, -1, -1):
        n_l, sm, bm = sym.plan[l]
        if n_l == 0:
            continue
        f = sm + bm
        Linv = Linvs[l]
        # inv(A11) = L11^{-T} L11^{-1}
        A11inv = jnp.swapaxes(Linv, -1, -2) @ Linv
        if bm:
            # X_BB: gather from ancestor fronts (computed already)
            gidx = arrs[f"tak_bb_{l}"]  # (n_l*bm*bm,) flat into xall
            XBB = xall[gidx].reshape(n_l, bm, bm)
            # W = A21 A11^{-1} = L21 L11^{-1} (b, s)
            W = L21s[l] @ Linv
            XBS = -(XBB @ W)          # (n, b, s)
            XSS = A11inv + jnp.swapaxes(W, -1, -2) @ (XBB @ W)
            X = jnp.concatenate(
                [
                    jnp.concatenate([XSS, jnp.swapaxes(XBS, -1, -2)], axis=2),
                    jnp.concatenate([XBS, XBB], axis=2),
                ],
                axis=1,
            )
        else:
            X = A11inv
            if f > sm:
                X = jnp.zeros((n_l, f, f), dt).at[:, :sm, :sm].set(A11inv)
        Xs[l] = X
        xall = lax.dynamic_update_slice(xall, X.reshape(-1), (offs[l],))
    return Xs
