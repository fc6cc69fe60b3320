"""Lower a FactorGraph to dense structure-of-arrays batches for the solvers.

This is the batched re-expression of the reference's per-factor Julia dispatch
(SURVEY.md §7 design stance): factors group by type into dense batches
(params stacked, variable slots as int32 index arrays); variables group by
type into dense point arrays. Everything downstream is vmap/segment-sum over
these arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import jax.numpy as jnp

from rome_tpu.factors.base import FactorType
from rome_tpu.graph.graph import FactorGraph


@dataclass
class FactorBatch:
    ftype: FactorType
    n: int
    vtypes: tuple            # type name per variable slot
    vslots: np.ndarray       # (n, arity) int32 — slot within the type array
    params: dict             # str -> (n, ...) arrays
    weight: np.ndarray       # (n,) float — 0/1 solvable mask
    labels: list = field(default_factory=list)
    # nonparametric-path metadata (addFactor! kwargs, SURVEY.md §5):
    nullhypo: np.ndarray = None    # (n,) float eta per factor
    inflation: np.ndarray = None   # (n,) float init-noise scale per factor


@dataclass
class GraphArrays:
    type_names: list                 # ordered variable types present
    manifolds: dict                  # type name -> Manifold
    counts: dict                     # type name -> n
    values0: dict                    # type name -> (n, point_dim)
    free: dict                       # type name -> (n,) float, 1 = optimize
    batches: list                    # list[FactorBatch]
    var_labels: dict                 # type name -> list of labels by slot
    dtype: object = jnp.float32
    # factor labels NOT lowered into batches (multihypo-extended factors);
    # the nonparametric driver routes these through per-factor approx_conv
    excluded_factors: list = field(default_factory=list)

    @property
    def total_dof(self):
        return sum(self.counts[t] * self.manifolds[t].dof for t in self.type_names)

    def tangent_zeros(self):
        return {
            t: jnp.zeros((self.counts[t], self.manifolds[t].dof), dtype=self.dtype)
            for t in self.type_names
        }

    def to_device(self):
        self.values0 = {k: jnp.asarray(v, dtype=self.dtype) for k, v in self.values0.items()}
        self.free = {k: jnp.asarray(v, dtype=self.dtype) for k, v in self.free.items()}
        for b in self.batches:
            b.vslots = jnp.asarray(b.vslots)
            b.params = {k: jnp.asarray(v, dtype=self.dtype) for k, v in b.params.items()}
            b.weight = jnp.asarray(b.weight, dtype=self.dtype)
        return self


def bucket_size(n: int) -> int:
    """Shape bucket: round up to ~12.5% granularity (multiples of
    2^(bit_length-3), min 8). Growing graphs re-use one compiled solver
    within a bucket — the no-recompile contract of the incremental path
    (reference analogue: solveTree! tree recycling,
    ManhattanDatasetIncremental.jl:97-115)."""
    if n <= 8:
        return 8
    g = max(8, 1 << (int(n).bit_length() - 3))
    return ((n + g - 1) // g) * g


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """Pad axis 0 to n rows by replicating the last row (always a VALID
    row: valid manifold point / params that evaluate finitely — padding is
    masked by weight/free zeros downstream, and 0*nan would poison sums)."""
    if a.shape[0] >= n:
        return a
    reps = np.repeat(a[-1:], n - a.shape[0], axis=0)
    return np.concatenate([a, reps], axis=0)


def lower(
    fg: FactorGraph,
    solve_key: str = "parametric",
    dtype=jnp.float32,
    pad: bool = False,
) -> GraphArrays:
    """Build dense solver arrays from the graph.

    Semantics mirror the reference fixed-lag behavior
    (setSolvableOldPoses!, RobotUtils.jl:79-98): variables with solvable=0 or
    marginalized=True stay in the arrays as constants (free=0) so factors
    touching them still constrain free variables; factors with solvable=0 or
    with every variable frozen are dropped.
    """
    # variable tables
    type_names, var_labels = [], {}
    for label in fg._var_order:
        t = fg.variables[label].vtype.name
        if t not in var_labels:
            var_labels[t] = []
            type_names.append(t)
        var_labels[t].append(label)

    manifolds, counts, values0, free = {}, {}, {}, {}
    for t in type_names:
        labels = var_labels[t]
        recs = [fg.variables[l] for l in labels]
        man = recs[0].manifold
        manifolds[t] = man
        counts[t] = len(labels)
        pts = []
        for r in recs:
            if solve_key in r.points:
                pts.append(np.asarray(r.points[solve_key], dtype=np.float64))
            else:
                pts.append(np.asarray(man.identity(), dtype=np.float64))
        values0[t] = np.stack(pts)
        free[t] = np.array(
            [1.0 if (r.solvable > 0 and not r.marginalized) else 0.0 for r in recs]
        )

    # factor batches grouped by type
    groups: dict[str, list] = {}
    excluded = []
    for flabel in fg._fct_order:
        f = fg.factors[flabel]
        if f.solvable <= 0:
            continue
        if len(f.variables) != f.ftype.arity:
            # multihypo-extended factor: data association is a sampling
            # concept; the parametric path skips it (as the reference's
            # parametric solver does) and the nonparametric path handles it
            # per-factor (approx_conv)
            excluded.append(flabel)
            continue
        recs = [fg.variables[v] for v in f.variables]
        if all(r.solvable <= 0 or r.marginalized for r in recs):
            continue
        groups.setdefault(f.ftype.name, []).append(f)

    batches = []
    for tname, fs in groups.items():
        ftype = fs[0].ftype
        n = len(fs)
        vslots = np.zeros((n, ftype.arity), dtype=np.int32)
        for i, f in enumerate(fs):
            for k, v in enumerate(f.variables):
                vslots[i, k] = fg.variables[v].slot
        # batch only the param keys EVERY instance carries: constructors may
        # attach extra per-factor metadata (e.g. the flux mixture's DT,
        # fluxmix.py) that the residual kernel never reads — those stay on
        # the Factor records (and in serialization) but not in the batch
        common = set(fs[0].params)
        for f in fs[1:]:
            common &= set(f.params)
        params = {
            key: np.stack([f.params[key] for f in fs]) for key in sorted(common)
        }
        default_infl = fg.params.inflation
        batches.append(
            FactorBatch(
                ftype=ftype,
                n=n,
                vtypes=tuple(vt.name for vt in ftype.variable_types),
                vslots=vslots,
                params=params,
                weight=np.ones(n),
                labels=[f.label for f in fs],
                nullhypo=np.array([float(f.nullhypo or 0.0) for f in fs]),
                inflation=np.array(
                    [
                        float(f.inflation if f.inflation is not None else default_infl)
                        for f in fs
                    ]
                ),
            )
        )

    if pad:
        for t in type_names:
            n = bucket_size(counts[t])
            if n > counts[t]:
                values0[t] = _pad_rows(values0[t], n)
                free[t] = np.concatenate(
                    [free[t], np.zeros(n - counts[t])]
                )
                var_labels[t] = var_labels[t] + [
                    f"__pad_{t}_{i}" for i in range(n - counts[t])
                ]
                counts[t] = n
        for b in batches:
            n = bucket_size(b.n)
            if n > b.n:
                b.vslots = _pad_rows(b.vslots, n)
                b.params = {k: _pad_rows(v, n) for k, v in b.params.items()}
                b.weight = np.concatenate([b.weight, np.zeros(n - b.n)])
                b.nullhypo = _pad_rows(b.nullhypo, n)
                b.inflation = _pad_rows(b.inflation, n)
                b.labels = b.labels + [None] * (n - b.n)
                b.n = n

    ga = GraphArrays(
        type_names=type_names,
        manifolds=manifolds,
        counts=counts,
        values0=values0,
        free=free,
        batches=batches,
        var_labels=var_labels,
        dtype=dtype,
        excluded_factors=excluded,
    )
    return ga.to_device()


def write_back(fg: FactorGraph, ga: GraphArrays, values, solve_key: str = "parametric"):
    """Push solved device values back into the graph records.

    Frozen variables (free=0) are NOT written: they keep their original
    float64 host values bit-identical — the fixed-lag freeze guarantee the
    reference tests assert (testFixedLagFG.jl:113-121).
    """
    for t in ga.type_names:
        man = ga.manifolds[t]
        # normalize ON DEVICE, then one transfer — normalize(np_array)
        # would round-trip host->device->host
        arr = np.asarray(man.normalize(values[t]), dtype=np.float64)
        free = np.asarray(ga.free[t])
        for slot, label in enumerate(ga.var_labels[t]):
            if free[slot] == 0.0:
                continue
            fg.variables[label].points[solve_key] = arr[slot]
            fg.variables[label].initialized[solve_key] = True
