"""Distributed nonparametric belief propagation.

The reference parallelizes *clique solves* of the sampling solver across
Julia worker processes (src/legacy/Slam.jl:189-297, testBeehiveGrow.jl:21-28
via ``SolverParams.multiproc``). The JAX re-expression shards the two
phases of the compiled sweep (solvers/multimodal/batched.py) over a device
mesh inside ONE ``shard_map`` program:

- **messages** (approxConv grid): embarrassingly parallel over factors —
  each device linearizes/solves only its slice of every factor batch and
  scatters the resulting particle messages into a local copy of the padded
  (V, K, N, pdim) product tensor; a single ``psum`` merges the disjoint
  writes (each (var, k) slot is written by exactly one device).
- **products** (masked parallel-Gibbs KDE): sharded over the variable axis —
  each device runs the Gibbs product for its V/ndev slice of variables and
  an ``all_gather`` reassembles the new beliefs.

Per-factor fallback messages (multihypo data association, non-Gaussian
mixtures) are computed host-side BEFORE the sharded program and enter as a
pre-filled base of the product tensor, exactly as in the single-device
engine.

Randomness note: per-shard sampling draws use shapes local to the shard, so
multi-device results equal single-device results in distribution (KL), not
bitwise — the acceptance tests are statistical, mirroring the reference's
band tests (testHexagonal2D_CliqByCliq.jl:38-79).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rome_tpu.solvers.multimodal.batched import (
    BatchedNonparametricSolver,
    _masked_gibbs,
    _sample_z,
)
from rome_tpu.solvers.multimodal.convolve import _gn_solve_target
from rome_tpu.solvers.multimodal.kde import silverman_bandwidth


class ShardedNonparametricSolver(BatchedNonparametricSolver):
    """Drop-in distributed variant of :class:`BatchedNonparametricSolver`.

    Same host-side routing/fallback machinery; the per-sweep compute runs
    factor- and variable-sharded over ``mesh``.
    """

    def __init__(self, fg, mesh: Mesh, solve_key: str = "default", N=None,
                 gibbs_sweeps: int = 3, axis: str = "f"):
        super().__init__(fg, solve_key=solve_key, N=N, gibbs_sweeps=gibbs_sweeps)
        self.mesh = mesh
        self.axis = axis
        self.ndev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
        self.gibbs_sweeps = gibbs_sweeps
        self._sharded_sweep = self._build_sharded_sweep()

    # -- sharded data layout -------------------------------------------------
    def _shard_inputs(self):
        """Per-source arrays padded to the mesh and device_put with the
        factor-axis sharding: params rows + routing (vslots, dest_var,
        dest_k). Padded rows get dest_var = V (out of bounds => scatter
        DROPS the update, masking them out)."""
        ga, bp, nd = self.ga, self.bp, self.ndev
        srcs = []
        for src in bp.sources:
            b = ga.batches[src.b]
            n = b.n
            pad = (-n) % nd
            params = {
                k: np.asarray(v) for k, v in self._params_all[src.b].items()
            }
            vsl = np.asarray(b.vslots)
            dest_var = np.asarray(src.dest_var)
            dest_k = np.asarray(src.dest_k)
            if pad:
                params = {
                    k: np.concatenate(
                        [v, np.repeat(v[-1:], pad, axis=0)], axis=0
                    )
                    for k, v in params.items()
                }
                vsl = np.concatenate([vsl, np.zeros((pad, vsl.shape[1]), vsl.dtype)])
                dest_var = np.concatenate(
                    [dest_var, np.full(pad, ga.counts[src.ttype], dest_var.dtype)]
                )
                dest_k = np.concatenate([dest_k, np.zeros(pad, dest_k.dtype)])
            arr = dict(params)
            arr["__vslots"] = vsl
            arr["__dest_var"] = dest_var
            arr["__dest_k"] = dest_k
            srcs.append(arr)
        shard = NamedSharding(self.mesh, P(self.axis))
        return [
            {k: jax.device_put(jnp.asarray(v), shard) for k, v in arr.items()}
            for arr in srcs
        ]

    def _build_sharded_sweep(self):
        ga, bp, N = self.ga, self.bp, self.N
        nd, axis = self.ndev, self.axis
        gibbs_sweeps = self.gibbs_sweeps
        vpad = {t: (-ga.counts[t]) % nd for t in ga.type_names}

        def sweep_shard(beliefs, base_padded, base_masks, msg_masks, var_masks,
                        key, srcs):
            # ---- phase 1: factor-sharded messages --------------------------
            padded = {t: v for t, v in base_padded.items()}
            masks = {t: v for t, v in base_masks.items()}
            for si, (src, arr) in enumerate(zip(bp.sources, srcs)):
                b = ga.batches[src.b]
                mans = [ga.manifolds[vt] for vt in b.vtypes]
                tman = mans[src.s]
                t = src.ttype
                kk = jax.random.fold_in(key, si)
                pid = jax.lax.axis_index(axis)
                kk = jax.random.fold_in(kk, pid)
                k_z, k_infl, k_null = jax.random.split(kk, 3)
                vsl = arr["__vslots"]
                nloc = vsl.shape[0]
                pts = [
                    beliefs[vt][vsl[:, k]] for k, vt in enumerate(b.vtypes)
                ]
                x0 = pts[src.s]
                bw = jax.vmap(lambda p: silverman_bandwidth(tman, p))(x0)
                scale = jnp.maximum(bw, 1e-2) * arr["__inflation"][:, None]
                noise = (
                    jax.random.normal(k_infl, (nloc, N, tman.dof), dtype=x0.dtype)
                    * scale[:, None, :]
                )
                x0_infl = tman.normalize(tman.boxplus(x0, noise))
                params = {
                    k: v for k, v in arr.items() if not k.startswith("__")
                }
                z = _sample_z({"z": arr["z"]}, arr["__L"], k_z, N)
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

                solved = jax.vmap(one_factor)(params, z, x0_infl, tuple(pts))
                eta = arr["__nullhypo"]
                keep = (
                    jax.random.uniform(k_null, (nloc, N), dtype=x0.dtype)
                    < eta[:, None]
                )
                solved = tman.normalize(
                    jnp.where(keep[..., None], x0_infl, solved)
                )
                # local scatter; padded rows have dest_var == V -> dropped
                padded[t] = padded[t].at[arr["__dest_var"], arr["__dest_k"]].set(
                    solved
                )
                masks[t] = masks[t].at[arr["__dest_var"], arr["__dest_k"]].set(1.0)
            # merge disjoint shard writes: each (var, k) slot is written by
            # exactly one device; everywhere else the base (identity point /
            # host-spliced fallback message) passes through untouched
            merged_p, merged_m = {}, {}
            for t in padded:
                wrote = masks[t] - base_masks[t]          # 1 where THIS shard wrote
                contrib = padded[t] * wrote[..., None, None]
                total_wrote = jnp.minimum(jax.lax.psum(wrote, axis), 1.0)
                merged_m[t] = jnp.minimum(
                    base_masks[t] + total_wrote, 1.0
                ) * msg_masks[t]
                merged_p[t] = (
                    base_padded[t] * (1.0 - total_wrote)[..., None, None]
                    + jax.lax.psum(contrib, axis)
                )

            # ---- phase 2: variable-sharded Gibbs products ------------------
            new_beliefs = dict(beliefs)
            pid = jax.lax.axis_index(axis)
            for ti, t in enumerate(ga.type_names):
                if t not in merged_p:
                    continue
                man = ga.manifolds[t]
                K = bp.kmax[t]
                V = ga.counts[t]
                Vp = V + vpad[t]
                rows = Vp // nd
                pad_spec = [(0, vpad[t])] + [(0, 0)] * (merged_p[t].ndim - 1)
                pfull = jnp.pad(merged_p[t], pad_spec)
                mfull = jnp.pad(merged_m[t], [(0, vpad[t]), (0, 0)])
                start = pid * rows
                psl = jax.lax.dynamic_slice_in_dim(pfull, start, rows, 0)
                msl = jax.lax.dynamic_slice_in_dim(mfull, start, rows, 0)
                prod = _masked_gibbs(man, K, N, gibbs_sweeps)
                gidx = start + jnp.arange(rows)
                keys = jax.vmap(
                    lambda i: jax.random.fold_in(
                        jax.random.fold_in(key, 99 + ti), i
                    )
                )(gidx)
                out_sl = jax.vmap(prod)(keys, psl, msl)
                out = jax.lax.all_gather(out_sl, axis, axis=0, tiled=True)[:V]
                full_mask = jax.lax.all_gather(msl, axis, axis=0, tiled=True)[:V]
                any_msg = jnp.max(full_mask, axis=1)
                upd = (
                    any_msg
                    * jnp.asarray(bp.has_msg[t], dtype=beliefs[t].dtype)
                    * ga.free[t]
                    * var_masks[t]
                )[:, None, None]
                new_beliefs[t] = jnp.where(upd > 0, out, beliefs[t])
            return new_beliefs

        from jax import shard_map

        srcs_sharded = self._shard_inputs()
        self._srcs_sharded = srcs_sharded
        vspec = {t: P() for t in ga.type_names}
        pspec = {t: P() for t in ga.type_names if bp.has_msg[t].any()}
        srcs_spec = [{k: P(axis) for k in d} for d in srcs_sharded]
        fn = shard_map(
            sweep_shard,
            mesh=self.mesh,
            in_specs=(vspec, pspec, pspec, pspec, vspec, P(), srcs_spec),
            out_specs=vspec,
            check_vma=False,
        )
        return jax.jit(fn)

    # -- one sharded Jacobi sweep -------------------------------------------
    def sweep(self, beliefs, key, var_masks=None, msg_masks=None):
        bp, ga = self.bp, self.ga

        # base product tensors (identity-point padding) + host-side fallback
        # splice — identical to the single-device engine
        base_padded, base_masks = {}, {}
        for t in ga.type_names:
            if not bp.has_msg[t].any():
                continue
            man = ga.manifolds[t]
            pdim = beliefs[t].shape[-1]
            ident = jnp.asarray(man.identity(), dtype=ga.dtype)
            base_padded[t] = (
                jnp.zeros((ga.counts[t], bp.kmax[t], self.N, pdim), ga.dtype)
                + ident
            )
            base_masks[t] = jnp.zeros((ga.counts[t], bp.kmax[t]), dtype=ga.dtype)
        if bp.fallback:
            from rome_tpu.solvers.multimodal.convolve import approx_conv

            self.scatter_beliefs(beliefs)
            for i, (flbl, vlbl, t, vslot, k) in enumerate(bp.fallback):
                kk = jax.random.fold_in(key, 7_000_000 + i)
                m = approx_conv(
                    self.fg, flbl, vlbl, self.solve_key, key=kk, N=self.N
                )
                base_padded[t] = base_padded[t].at[vslot, k].set(
                    m.astype(ga.dtype)
                )
                base_masks[t] = base_masks[t].at[vslot, k].set(1.0)
        if msg_masks is not None:
            msg_masks = {
                t: jnp.asarray(msg_masks[t], ga.dtype) for t in base_masks
            }
        else:
            msg_masks = {
                t: jnp.ones_like(base_masks[t]) for t in base_masks
            }
        if var_masks is None:
            var_masks = {
                t: jnp.ones((ga.counts[t],), ga.dtype) for t in ga.type_names
            }
        else:
            vm = {
                t: jnp.asarray(
                    var_masks.get(t, jnp.ones((ga.counts[t],))), ga.dtype
                )
                for t in ga.type_names
            }
            var_masks = vm
        return self._sharded_sweep(
            beliefs, base_padded, base_masks, msg_masks, var_masks, key,
            self._srcs_sharded,
        )
