"""Variable-PARTITIONED distributed solve: owner-computes + separator exchange.

This is the SURVEY §2.7 north-star sharding shape, complementing
``parallel.sharding`` (factor-axis sharding with variables replicated):

- every device OWNS a contiguous block of each variable type (for
  trajectory-ordered SLAM graphs contiguous blocks are a near-minimal cut);
- each factor is assigned to the device owning its first variable;
- variables referenced by a factor on a non-owner device are SEPARATORS;
  only those cross the mesh. Two collectives per CG application:
    1. value exchange: owners write their separator values into a
       (n_sep, dim) buffer, one ``psum`` replicates it (owner is the only
       writer, so the sum IS the value);
    2. gradient/HVP reduce: each device scatter-adds its factors'
       contributions; the separator tail is ``psum``-reduced and folded back
       into the owner's block.
  Comms volume per exchange is O(n_sep * dof) instead of the replicated
  path's O(n_total * dof) — for a 1,024-pose chain on 8 devices the
  separator set is ~30 poses vs 1,024 replicated (a ~34x payload cut; see
  ``tests/test_varpart.py``).

The reference's analogue is clique-to-worker dispatch of subgraphs
(/root/reference/src/legacy/Slam.jl:261, IIF ``multiproc``): workers own
subgraphs and exchange only clique-separator marginals. Here the exchange is
the exact linear-algebra separator (boundary columns of J), not an
approximate marginal.

Status: production-quality prototype for single-type and mixed-type graphs;
the flagship replicated path remains the default until multi-host DCN
hardware is available to validate the comms win end-to-end.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rome_tpu.graph.lower import GraphArrays


# --------------------------------------------------------------------------
# host-side partition planning (numpy)
# --------------------------------------------------------------------------

class VarPartitionPlan:
    """Static routing tables for an owner-computes partition.

    All arrays are stacked along a leading device axis and sharded over the
    mesh; inside ``shard_map`` each device sees only its own row.
    """

    def __init__(self, ga: GraphArrays, ndev: int):
        self.ga = ga
        self.ndev = ndev
        tn = ga.type_names

        # ---- contiguous variable blocks per type --------------------------
        self.bounds = {}      # t -> (ndev+1,) block boundaries
        self.owner = {}       # t -> (n,) owning device
        self.n_loc = {}       # t -> padded own-block size
        for t in tn:
            n = ga.counts[t]
            b = np.round(np.linspace(0, n, ndev + 1)).astype(np.int64)
            self.bounds[t] = b
            ow = np.zeros(n, np.int64)
            for d in range(ndev):
                ow[b[d]:b[d + 1]] = d
            self.owner[t] = ow
            self.n_loc[t] = int(max(1, (b[1:] - b[:-1]).max()))

        # ---- factor -> device assignment ----------------------------------
        fdev = []  # per batch: (n,) device id
        for bt in ga.batches:
            t0 = bt.vtypes[0]
            fdev.append(self.owner[t0][np.asarray(bt.vslots)[:, 0]])
        self.fdev = fdev

        # ---- separator detection -------------------------------------------
        sep_mask = {t: np.zeros(ga.counts[t], bool) for t in tn}
        for bt, dv in zip(ga.batches, fdev):
            vs = np.asarray(bt.vslots)
            for k, t in enumerate(bt.vtypes):
                cross = self.owner[t][vs[:, k]] != dv
                sep_mask[t][vs[cross, k]] = True
        self.sep_ids = {}   # t -> (n_sep,) global ids (>=1 row, padded)
        self.n_sep = {}
        sep_pos = {}        # t -> (n,) global id -> sep slot (or 0)
        for t in tn:
            ids = np.nonzero(sep_mask[t])[0]
            if ids.size == 0:
                ids = np.array([0], np.int64)  # dummy row, masked out
            self.sep_ids[t] = ids
            self.n_sep[t] = len(ids)
            sp = np.zeros(ga.counts[t], np.int64)
            sp[ids] = np.arange(len(ids))
            sep_pos[t] = sp
        self.sep_real = {
            t: sep_mask[t][self.sep_ids[t]].astype(np.float32) for t in tn
        }

        # ---- separator routing: owner's local position + ownership mask ---
        # sep_src[t]: (ndev, n_sep) own-block position of each separator on
        # its owner (0 elsewhere); sep_own[t]: (ndev, n_sep) 1 iff owned.
        self.sep_src = {}
        self.sep_own = {}
        for t in tn:
            ids = self.sep_ids[t]
            src = np.zeros((ndev, len(ids)), np.int64)
            own = np.zeros((ndev, len(ids)), np.float32)
            for d in range(ndev):
                m = (self.owner[t][ids] == d) & (self.sep_real[t] > 0)
                src[d, m] = ids[m] - self.bounds[t][d]
                own[d, m] = 1.0
            self.sep_src[t] = src
            self.sep_own[t] = own
        # inverse map for the Schur solve: own-block position -> separator
        # slot (-1 = interior)
        self.own2sep = {}
        for t in tn:
            o2s = np.full((ndev, self.n_loc[t]), -1, np.int64)
            for d in range(ndev):
                m = self.sep_own[t][d] > 0
                o2s[d, self.sep_src[t][d, m]] = np.nonzero(m)[0]
            self.own2sep[t] = o2s

        # ---- own-block stacking (values / free / valid) --------------------
        # own_gids[t]: (ndev, n_loc) global variable id feeding each own row
        # (clamped for pads); own_valid marks real rows.
        self.own_gids = {}
        self.own_valid = {}
        for t in tn:
            g = np.zeros((ndev, self.n_loc[t]), np.int64)
            v = np.zeros((ndev, self.n_loc[t]), np.float32)
            for d in range(ndev):
                lo, hi = self.bounds[t][d], self.bounds[t][d + 1]
                g[d, : hi - lo] = np.arange(lo, hi)
                v[d, : hi - lo] = 1.0
            self.own_gids[t] = g
            self.own_valid[t] = v

        # ---- per-device factor subsets with LOCAL index remap --------------
        # local index: own position (owner) or n_loc + sep slot (remote)
        self.fb_local = []  # per batch: dict of stacked (ndev, m_loc, ...)
        for bt, dv in zip(ga.batches, fdev):
            vs = np.asarray(bt.vslots)
            w = np.asarray(bt.weight)
            m_loc = int(max(1, np.bincount(dv, minlength=ndev).max()))
            arity = vs.shape[1]
            vsl = np.zeros((ndev, m_loc, arity), np.int64)
            wl = np.zeros((ndev, m_loc), np.float64)
            rows = np.zeros((ndev, m_loc), np.int64)  # source row (for params)
            for d in range(ndev):
                ridx = np.nonzero(dv == d)[0]
                mr = len(ridx)
                rows[d, :mr] = ridx
                wl[d, :mr] = w[ridx]
                for k, t in enumerate(bt.vtypes):
                    v_ids = vs[ridx, k]
                    is_own = self.owner[t][v_ids] == d
                    li = np.where(
                        is_own,
                        v_ids - self.bounds[t][d],
                        self.n_loc[t] + sep_pos[t][v_ids],
                    )
                    vsl[d, :mr, k] = li
            params = {
                k: np.asarray(p)[rows] for k, p in bt.params.items()
            }  # (ndev, m_loc, ...)
            if "sqrt_info" in params:
                # padded rows need a usable sqrt_info; weight 0 hides them
                eye = np.eye(bt.params["sqrt_info"].shape[-1])
                pad = wl == 0.0
                params["sqrt_info"] = np.where(
                    pad[..., None, None], eye, params["sqrt_info"]
                )
            self.fb_local.append(
                dict(vslots=vsl, weight=wl, params=params, vtypes=bt.vtypes,
                     ftype=bt.ftype)
            )

    # ---- value scatter / gather -------------------------------------------
    def scatter_values(self, values):
        """Global per-type values -> stacked own blocks (ndev, n_loc, dim)."""
        return {
            t: np.asarray(values[t])[self.own_gids[t]] for t in self.ga.type_names
        }

    def gather_values(self, own_stacked):
        """Stacked own blocks -> global per-type arrays."""
        out = {}
        for t in self.ga.type_names:
            arr = np.zeros(
                (self.ga.counts[t],) + tuple(np.asarray(own_stacked[t]).shape[2:]),
                np.asarray(own_stacked[t]).dtype,
            )
            for d in range(self.ndev):
                lo, hi = self.bounds[t][d], self.bounds[t][d + 1]
                arr[lo:hi] = np.asarray(own_stacked[t])[d, : hi - lo]
            out[t] = arr
        return out

    def comms_note(self):
        """Bytes per exchange: separator payload vs replicated-path payload."""
        itemsize = np.dtype(np.float32).itemsize
        sep = sum(
            int(self.sep_real[t].sum()) * self.ga.manifolds[t].dof
            for t in self.ga.type_names
        )
        full = sum(
            self.ga.counts[t] * self.ga.manifolds[t].dof
            for t in self.ga.type_names
        )
        return dict(
            separator_dofs=sep,
            replicated_dofs=full,
            payload_ratio=round(full / max(sep, 1), 2),
            bytes_per_exchange=sep * itemsize,
        )


# --------------------------------------------------------------------------
# the sharded solver
# --------------------------------------------------------------------------

def make_varpart_solver(ga: GraphArrays, mesh: Mesh, axis: str = "v",
                        pcg_iters: int = 100, pcg_tol: float = 1e-8,
                        max_iters: int = 100, ftol: float = 1e-8,
                        gtol: float = 1e-8):
    """Build the owner-computes fused LM solve over ``mesh``.

    Returns ``(solve, plan)`` where ``solve(values, lam0)`` maps global
    values -> (global values, iters, code, final_cost).
    """
    ndev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    plan = VarPartitionPlan(ga, ndev)
    tn = ga.type_names
    manifolds = ga.manifolds
    dtype = ga.dtype

    # ---- device-resident routing tables (stacked on the device axis) ------
    def dev_sharded(x):
        return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(axis)))

    sep_src = {t: dev_sharded(plan.sep_src[t]) for t in tn}
    sep_own = {t: dev_sharded(plan.sep_own[t].astype(dtype)) for t in tn}
    own2sep = {t: dev_sharded(plan.own2sep[t]) for t in tn}
    own_valid = {t: dev_sharded(plan.own_valid[t].astype(dtype)) for t in tn}
    # free mask over own rows (frozen vars + padding pinned)
    free_own = {
        t: dev_sharded(
            (np.asarray(ga.free[t])[plan.own_gids[t]] * plan.own_valid[t]).astype(dtype)
        )
        for t in tn
    }
    # free mask over separator slots (replicated)
    free_sep = {
        t: jnp.asarray(
            np.asarray(ga.free[t])[plan.sep_ids[t]] * plan.sep_real[t], dtype
        )
        for t in tn
    }
    fbs = [
        dict(
            vslots=dev_sharded(fb["vslots"]),
            weight=dev_sharded(fb["weight"].astype(dtype)),
            params={k: dev_sharded(v.astype(np.asarray(v).dtype))
                    for k, v in fb["params"].items()},
        )
        for fb in plan.fb_local
    ]
    statics = [(fb["ftype"], fb["vtypes"]) for fb in plan.fb_local]
    n_loc = plan.n_loc

    # ---- shard-local helpers (run inside shard_map; leading dev axis = 1) --
    def _sq(x):
        return x[0]  # strip the size-1 device axis shard_map leaves

    def tdot_local(a, b, fown):
        return sum(
            jnp.sum((a[t] * b[t]) * fown[t][:, None]) for t in a
        )

    def build(mode="solve"):
        """``mode``: "solve" = the fused LM loop (production);
        phase probes for the scaling decomposition (tools/scaling_bench.py):
        "lin_cost"     = sep exchange + linearize + cost psum only
        "schur_full"   = one full Schur step (linearize + local elimination
                         + fused psum + separator solve + back-substitute)
        "schur_nopsum" = same with the fused reduction skipped (local-only
                         work; full-minus-this isolates collective time)
        "schur_nosep"  = same with the replicated separator solve skipped
                         (full-minus-this isolates the replicated solve)
        """
        skip_psum = mode == "schur_nopsum"
        skip_sep = mode == "schur_nosep"

        def core(own_vals, lam, sep_srcS, sep_ownS, own2sepS, own_validS,
                 free_ownS, free_sepS, fbsS):
            # all routing tables arrive sharded with a leading size-1 axis
            sep_srcL = {t: _sq(sep_srcS[t]) for t in tn}
            sep_ownL = {t: _sq(sep_ownS[t]) for t in tn}
            own2sepL = {t: _sq(own2sepS[t]) for t in tn}
            free_ownL = {t: _sq(free_ownS[t]) for t in tn}
            validL = {t: _sq(own_validS[t]) for t in tn}
            fbsL = [
                dict(vslots=_sq(fb["vslots"]), weight=_sq(fb["weight"]),
                     params={k: _sq(v) for k, v in fb["params"].items()})
                for fb in fbsS
            ]

            def sep_exchange(own):
                """(n_loc, d) per type -> replicated (n_sep, d) via psum."""
                out = {}
                for t in tn:
                    v = own[t][sep_srcL[t]] * sep_ownL[t][:, None]
                    out[t] = jax.lax.psum(v, axis)
                return out

            def with_sep(own, sep):
                return {t: jnp.concatenate([own[t], sep[t]]) for t in tn}

            def linearize_local(vloc):
                lins = []
                for (ftype, vtypes), fb in zip(statics, fbsL):
                    mans = [manifolds[t] for t in vtypes]
                    vsl = fb["vslots"]
                    pts = tuple(
                        vloc[t][vsl[:, k]] for k, t in enumerate(vtypes)
                    )

                    def f(deltas, prow, p, _r=ftype.residual, _m=mans):
                        newp = tuple(
                            m.boxplus(pp, d) for m, pp, d in zip(_m, p, deltas)
                        )
                        return prow["sqrt_info"] @ _r(prow, *newp)

                    zeros = tuple(
                        jnp.zeros((vsl.shape[0], m.dof), dtype=dtype)
                        for m in mans
                    )

                    def fj(deltas, prow, p, _f=f):
                        return _f(deltas, prow, p), jax.jacfwd(_f)(deltas, prow, p)

                    r0, Js = jax.vmap(fj)(zeros, fb["params"], pts)
                    w = fb["weight"]
                    r0 = r0 * w[:, None]
                    Js = tuple(J * w[:, None, None] for J in Js)
                    lins.append((vtypes, vsl, r0, Js))
                return lins

            def local_zeros():
                return {
                    t: jnp.zeros(
                        (n_loc[t] + plan.n_sep[t], manifolds[t].dof), dtype=dtype
                    )
                    for t in tn
                }

            def reduce_to_own(gloc):
                """Scattered (n_loc+n_sep, dof) -> owner blocks (n_loc, dof).

                The separator tail (cross-device contributions) psums over
                the mesh and folds into the owner's row. Payload: n_sep*dof.
                """
                out = {}
                for t in tn:
                    own_part = gloc[t][: n_loc[t]]
                    tail = jax.lax.psum(gloc[t][n_loc[t]:], axis)
                    own_part = own_part.at[sep_srcL[t]].add(
                        tail * sep_ownL[t][:, None]
                    )
                    out[t] = own_part * free_ownL[t][:, None]
                return out

            def grad_of(lins):
                g = local_zeros()
                for vtypes, vsl, r0, Js in lins:
                    for k, t in enumerate(vtypes):
                        g[t] = g[t].at[vsl[:, k]].add(
                            jnp.einsum("nij,ni->nj", Js[k], r0)
                        )
                return reduce_to_own(g)

            def free_local(t):
                return jnp.concatenate([free_ownL[t], free_sepS[t]])

            def hvp_of(lins, v_own):
                v_loc = with_sep(v_own, sep_exchange(v_own))
                out = local_zeros()
                for vtypes, vsl, r0, Js in lins:
                    u = None
                    for k, t in enumerate(vtypes):
                        vk = v_loc[t][vsl[:, k]] * free_local(t)[vsl[:, k], None]
                        uk = jnp.einsum("nij,nj->ni", Js[k], vk)
                        u = uk if u is None else u + uk
                    for k, t in enumerate(vtypes):
                        out[t] = out[t].at[vsl[:, k]].add(
                            jnp.einsum("nij,ni->nj", Js[k], u)
                        )
                return reduce_to_own(out)

            def block_diag_of(lins):
                D = {
                    t: jnp.zeros(
                        (n_loc[t] + plan.n_sep[t], manifolds[t].dof,
                         manifolds[t].dof),
                        dtype=dtype,
                    )
                    for t in tn
                }
                for vtypes, vsl, r0, Js in lins:
                    for k, t in enumerate(vtypes):
                        D[t] = D[t].at[vsl[:, k]].add(
                            jnp.einsum("nij,nik->njk", Js[k], Js[k])
                        )
                out = {}
                for t in tn:
                    own_part = D[t][: n_loc[t]]
                    tail = jax.lax.psum(D[t][n_loc[t]:], axis)
                    out[t] = own_part.at[sep_srcL[t]].add(
                        tail * sep_ownL[t][:, None, None]
                    )
                return out

            def cost_of(vloc):
                lins = linearize_local(vloc)
                # f64 accumulation + f64 psum: the LM accept test compares
                # cost1 < cost0, and an f32 cross-process psum's reduction
                # order perturbs the sum at ~1e-7 relative — enough to flip
                # accept decisions and drift the iteration count between
                # single- and multi-process runs of the identical problem
                # (11 vs 18 iters were seen). f64 collectives make the
                # perturbation ~1e-16, far below any accept threshold.
                cdt = jnp.float64 if jax.config.jax_enable_x64 else dtype
                c = sum(
                    0.5 * jnp.sum(r0.astype(cdt) * r0.astype(cdt))
                    for _vt, _vs, r0, _J in lins
                )
                return jax.lax.psum(c, axis).astype(dtype), lins

            def boxplus_own(own, delta):
                out = {}
                for t in tn:
                    man = manifolds[t]
                    out[t] = man.normalize(
                        man.boxplus(own[t], delta[t] * free_ownL[t][:, None])
                    )
                    # padded rows stay bit-identical (normalize may perturb)
                    out[t] = jnp.where(
                        validL[t][:, None] > 0, out[t], own[t]
                    )
                return out

            # static own-block scalar layout for the subdomain preconditioner
            base_own = {}
            D_own = 0
            for t in tn:
                base_own[t] = D_own
                D_own += n_loc[t] * manifolds[t].dof

            # separator scalar layout (GLOBAL, replicated across devices)
            base_sep = {}
            D_sep = 0
            for t in tn:
                base_sep[t] = D_sep
                D_sep += plan.n_sep[t] * manifolds[t].dof
            DT = D_own + D_sep  # [interior-own | separator] + dump row

            def slot_offsets(vsl_k, t):
                """Local slot column -> scalar offsets (n, dof) into the
                [interior | separator] layout; frozen/pad rows -> dump DT."""
                d = manifolds[t].dof
                s = vsl_k
                idx = jnp.minimum(s, n_loc[t] - 1)
                is_rem = s >= n_loc[t]
                o2s = own2sepL[t][idx]
                sidx = jnp.where(is_rem, s - n_loc[t], o2s)
                is_sep = sidx >= 0
                o_int = base_own[t] + idx * d
                o_sep = D_own + base_sep[t] + jnp.maximum(sidx, 0) * d
                o = jnp.where(is_sep, o_sep, o_int)
                act = jnp.where(
                    is_rem,
                    free_sepS[t][jnp.maximum(sidx, 0)],
                    free_ownL[t][idx],
                )
                return jnp.where(
                    (act > 0)[:, None],
                    o[:, None] + jnp.arange(d)[None, :],
                    DT,
                )

            def schur_solve(lins, lam):
                """EXACT damped-normal-equations solve with ONE fused psum:
                each device eliminates its interior variables locally
                (dense Cholesky — interiors touch only local factors by
                construction), forms its Schur-complement contribution on
                the GLOBAL separator set, one psum sums
                [S_d | reduced-rhs | separator-gradient | interior |g|^2],
                and every device solves the small replicated separator
                system directly. No CG, no per-iteration collective chatter
                — this cuts the ~9000 collectives/solve of a CG-based
                exchange to ~7 per LM iteration. Reference analogue: upward clique
                elimination to the Bayes-tree root followed by the root
                solve (Slam.jl:261 solveTree!), with devices as cliques."""
                rows_all, cols_all, vals_all = [], [], []
                g_idx_all, g_val_all = [], []
                for vtypes, vsl, r0, Js in lins:
                    offs = [
                        slot_offsets(vsl[:, k], t)
                        for k, t in enumerate(vtypes)
                    ]
                    for k in range(len(vtypes)):
                        g_idx_all.append(offs[k].reshape(-1))
                        g_val_all.append(
                            jnp.einsum("nij,ni->nj", Js[k], r0).reshape(-1)
                        )
                        for l in range(len(vtypes)):
                            blk = jnp.einsum("nij,nik->njk", Js[k], Js[l])
                            n, dk, dl = blk.shape
                            rows_all.append(
                                jnp.broadcast_to(
                                    offs[k][:, :, None], (n, dk, dl)
                                ).reshape(-1)
                            )
                            cols_all.append(
                                jnp.broadcast_to(
                                    offs[l][:, None, :], (n, dk, dl)
                                ).reshape(-1)
                            )
                            vals_all.append(blk.reshape(-1))
                M = jnp.zeros((DT + 1, DT + 1), dtype)
                M = M.at[
                    jnp.concatenate(rows_all), jnp.concatenate(cols_all)
                ].add(jnp.concatenate(vals_all))
                gl = jnp.zeros((DT + 1,), dtype)
                gl = gl.at[jnp.concatenate(g_idx_all)].add(
                    jnp.concatenate(g_val_all)
                )
                M = M[:DT, :DT]
                gl = gl[:DT]
                # activity masks from the raw diagonal (inactive = dumped:
                # frozen / padding / not present on this device)
                diag0 = jnp.diag(M)
                int_act = (diag0[:D_own] > 0).astype(dtype)
                # damping on the LOCAL diagonal: interiors are fully local
                # (= global); separator shares sum to the global diagonal
                # through the same psum that sums S_d
                M = M + lam * jnp.diag(diag0)
                A_II = M[:D_own, :D_own]
                A_II = A_II + jnp.diag(1.0 - int_act)
                dI = jax.lax.rsqrt(jnp.maximum(jnp.diag(A_II), 1e-12))
                As = A_II * dI[:, None] * dI[None, :] + 1e-6 * jnp.eye(
                    D_own, dtype=dtype
                )
                L, lower = jax.scipy.linalg.cho_factor(As, lower=True)
                A_IS = M[:D_own, D_own:]
                U = dI[:, None] * A_IS                      # (D_own, D_sep)
                Y = jax.scipy.linalg.cho_solve((L, lower), U)
                b_I = -gl[:D_own] * int_act
                b_S = -gl[D_own:]
                v = jax.scipy.linalg.cho_solve((L, lower), dI * b_I)
                S_d = M[D_own:, D_own:] - U.T @ Y           # (D_sep, D_sep)
                r_d = b_S - U.T @ v
                gI_sq = jnp.sum((gl[:D_own] * int_act) ** 2)
                # ---- the one collective: fused Schur reduction ----
                pack = jnp.concatenate(
                    [S_d.reshape(-1), r_d, gl[D_own:], gI_sq[None]]
                )
                # f64 reduction (see cost_of): keeps the summed Schur system
                # bit-stable across process topologies, so single- and
                # multi-process runs follow the same LM trajectory
                cdt = jnp.float64 if jax.config.jax_enable_x64 else dtype
                if not skip_psum:
                    pack = jax.lax.psum(pack.astype(cdt), axis).astype(dtype)
                S = pack[: D_sep * D_sep].reshape(D_sep, D_sep)
                r_S = pack[D_sep * D_sep : D_sep * D_sep + D_sep]
                g_S = pack[D_sep * D_sep + D_sep : -1]
                gnorm = jnp.sqrt(pack[-1] + jnp.sum(g_S**2))
                # replicated separator solve (identical on every device)
                if skip_sep:
                    x_S = jnp.zeros((D_sep,), dtype)
                else:
                    sep_act = (jnp.abs(jnp.diag(S)) > 0).astype(dtype)
                    S = S + jnp.diag(1.0 - sep_act)
                    dS = jax.lax.rsqrt(jnp.maximum(jnp.diag(S), 1e-12))
                    Ss = S * dS[:, None] * dS[None, :] + 1e-6 * jnp.eye(
                        D_sep, dtype=dtype
                    )
                    Ls, lows = jax.scipy.linalg.cho_factor(Ss, lower=True)
                    x_S = dS * jax.scipy.linalg.cho_solve(
                        (Ls, lows), dS * r_S
                    )
                    x_S = x_S * sep_act
                # back-substitute interiors (local)
                x_I = dI * jax.scipy.linalg.cho_solve(
                    (L, lower), dI * (b_I - A_IS @ x_S)
                )
                x_I = x_I * int_act
                # scatter back to (n_loc, dof) per type
                delta = {}
                for t in tn:
                    d = manifolds[t].dof
                    xi = x_I[base_own[t] : base_own[t] + n_loc[t] * d].reshape(
                        n_loc[t], d
                    )
                    o2s = own2sepL[t]
                    sbase = D_own - D_own + base_sep[t]  # offset into x_S
                    gidx = sbase + jnp.maximum(o2s, 0)[:, None] * d + jnp.arange(d)[None, :]
                    xs = jnp.where((o2s >= 0)[:, None], x_S[gidx], 0.0)
                    delta[t] = (xi + xs) * free_ownL[t][:, None]
                return delta, gnorm

            def gn_step(own, lam):
                vloc = with_sep(own, sep_exchange(own))
                cost0, lins = cost_of(vloc)
                delta, gnorm = schur_solve(lins, lam)
                trial = boxplus_own(own, delta)
                cost1, _ = cost_of(with_sep(trial, sep_exchange(trial)))
                ok = jnp.logical_and(jnp.isfinite(cost1), cost1 < cost0)
                new_own = jax.tree_util.tree_map(
                    lambda a, b_: jnp.where(ok, a, b_), trial, own
                )
                dnorm = jnp.sqrt(
                    jax.lax.psum(tdot_local(delta, delta, free_ownL), axis)
                )
                return new_own, cost0, cost1, gnorm, dnorm, ok, jnp.ones(
                    (), jnp.int32
                )

            # ---- phase probes (scaling decomposition) ---------------------
            if mode != "solve":
                own0p = {t: _sq(own_vals[t]) for t in tn}
                cth, linsp = cost_of(with_sep(own0p, sep_exchange(own0p)))
                if mode == "lin_cost":
                    return jnp.reshape(cth, (1,))
                deltap, gnp = schur_solve(linsp, lam)
                # fold delta in so no phase gets dead-code-eliminated;
                # (1,)-shaped per-device output (nopsum values legitimately
                # differ across devices)
                out = gnp + 0.0 * sum(
                    jnp.sum(deltap[t]) for t in tn
                ) + 0.0 * cth
                return jnp.reshape(out, (1,))

            # ---- fused LM loop (Marquardt schedule in-graph) --------------
            def lm_cond(state):
                _v, _lam, it, _cp, _nr, code, _cg = state
                return jnp.logical_and(it < max_iters, code == 0)

            def lm_body(state):
                own, lam, it, cost_prev, n_rej, code, cg_total = state
                nv, c0, c1, gn, dn, ok, cg_k = gn_step(own, lam)
                new_lam = jnp.where(
                    ok, jnp.maximum(lam * 0.25, 1e-12),
                    jnp.minimum(lam * 8.0, 1e8),
                )
                ftol_hit = jnp.abs(cost_prev - c1) <= ftol * jnp.maximum(
                    1.0, jnp.abs(cost_prev)
                )
                acc = jnp.where(
                    gn < gtol, 1,
                    jnp.where(
                        jnp.logical_and(jnp.isfinite(cost_prev), ftol_hit), 3, 0
                    ),
                )
                n_rej2 = jnp.where(ok, 0, n_rej + 1)
                # rejected trial within ftol of the plateau = converged
                # (same reduction-order robustness as parallel.sharding) —
                # gated on >=2 consecutive plateau rejections so a single
                # symmetric overshoot (cost1 ~ cost_prev, |g| large) can't
                # fire a false "converged"
                rej_ftol = jnp.logical_and(
                    n_rej2 >= 2,
                    jnp.logical_and(
                        jnp.isfinite(cost_prev),
                        jnp.abs(cost_prev - c1)
                        <= ftol * jnp.maximum(1.0, jnp.abs(cost_prev)),
                    ),
                )
                rej = jnp.where(
                    rej_ftol, 3,
                    jnp.where(dn < 1e-4, 4, jnp.where(n_rej2 >= 8, 5, 0)),
                )
                return (
                    nv, new_lam, it + 1, jnp.where(ok, c1, cost_prev),
                    n_rej2, jnp.where(ok, acc, rej).astype(jnp.int32),
                    cg_total + cg_k,
                )

            own0 = {t: _sq(own_vals[t]) for t in tn}
            init = (
                own0, lam, jnp.zeros((), jnp.int32),
                jnp.asarray(jnp.inf, dtype=dtype),
                jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
                jnp.zeros((), jnp.int32),
            )
            own, lam, it, _cp, _nr, code, cg_total = jax.lax.while_loop(
                lm_cond, lm_body, init
            )
            fc, _ = cost_of(with_sep(own, sep_exchange(own)))
            return {t: own[t][None] for t in tn}, it, code, fc, cg_total

        return core

    from jax import shard_map

    vspec = {t: P(axis) for t in tn}
    tabspec = {t: P(axis) for t in tn}
    repspec = {t: P() for t in tn}
    fbspec = [
        dict(vslots=P(axis), weight=P(axis),
             params={k: P(axis) for k in fb["params"]})
        for fb in plan.fb_local
    ]
    in_specs = (vspec, P(), tabspec, tabspec, tabspec, tabspec,
                tabspec, repspec, fbspec)
    solve_core = jax.jit(
        shard_map(
            build(), mesh=mesh,
            in_specs=in_specs,
            out_specs=(vspec, P(), P(), P(), P()),
            check_vma=False,
        )
    )

    _probes = {}

    def probe(name, values=None, lam0=1e-4):
        """Run one phase-probe program (see build() modes) and block; used
        by tools/scaling_bench.py for the per-phase decomposition."""
        fn = _probes.get(name)
        if fn is None:
            fn = jax.jit(
                shard_map(
                    build(name), mesh=mesh, in_specs=in_specs,
                    out_specs=P(axis), check_vma=False,
                )
            )
            _probes[name] = fn
        values = values if values is not None else ga.values0
        scattered = plan.scatter_values(values)
        own = {t: dev_sharded(scattered[t]) for t in tn}
        out = fn(
            own, jnp.asarray(lam0, dtype), sep_src, sep_own, own2sep,
            own_valid, free_own, free_sep, fbs
        )
        return jax.block_until_ready(out)

    def solve(values=None, lam0=1e-4):
        values = values if values is not None else ga.values0
        scattered = plan.scatter_values(values)
        own = {t: dev_sharded(scattered[t]) for t in tn}
        lam = jnp.asarray(lam0, dtype=dtype)
        own, it, code, fc, cg_total = solve_core(
            own, lam, sep_src, sep_own, own2sep, own_valid, free_own,
            free_sep, fbs
        )
        def _host_global(x):
            # multi-process run: shards on other processes are not
            # addressable here — allgather them (tiny: own-values payload)
            if x.is_fully_addressable:
                return np.asarray(x)
            from jax.experimental import multihost_utils

            return np.asarray(multihost_utils.process_allgather(x, tiled=True))

        out = plan.gather_values({t: _host_global(v) for t, v in own.items()})
        from rome_tpu.solvers.gauss_newton import ParametricSolver

        stats = dict(
            iterations=int(it),
            # shared code map (gauss_newton is the source of truth)
            reason=ParametricSolver._REASONS.get(int(code), "?"),
            converged=int(code) in (1, 3, 4) or (int(code) == 5 and int(it) > 3),
            final_cost=float(fc),
            schur_solves=int(cg_total),
            # collective census per the core's structure (tn types):
            # per LM iteration: sep_exchange(tn) + cost psum(1) + ONE fused
            # Schur pack psum(1) + trial exchange(tn) + trial cost(1) +
            # dnorm psum(1) — no inner CG, no per-iteration chatter
            collectives=int(it) * (4 + 2 * len(tn)),
            comms=plan.comms_note(),
        )
        return {t: jnp.asarray(v, dtype) for t, v in out.items()}, stats

    solve.probe = probe
    return solve, plan
