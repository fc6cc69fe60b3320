"""Factor-graph container — the DistributedFactorGraphs-equivalent data layer.

Design: the graph itself is host-side metadata (labels, tags,
solvable flags, PPEs — cheap Python), while *all* numeric state lowers to
dense per-variable-type arrays and per-factor-type batches (structure of
arrays) that the solvers jit over. Mirrors the DFG API surface the reference
leans on: addVariable!/addFactor!/ls/lsf/solvable/PPE/initVariable!
(/root/reference/src/RoME.jl:21,51-52 reexports; SURVEY.md §0).
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from rome_tpu.distributions import Distribution
from rome_tpu.utils.host import host_default_device, on_host
from rome_tpu.factors.base import Factor
from rome_tpu.variables import VariableType, get_variable_type


@dataclass
class SolverParams:
    """Single config object mirroring IIF SolverParams fields exercised by the
    reference (SURVEY.md §5 config table)."""

    N: int = 100                      # particles per belief
    graphinit: bool = True            # init new variables by factor propagation
    treeinit: bool = False            # solveGraph routes through the Bayes tree
    downsolve: bool = True
    multiproc: bool = False           # parametric solve over the device mesh
    # async_ is realized by the frontend: manage_solve_tree (Slam.jl:189-297
    # analogue) always runs the solver on a background thread with Condition
    # backpressure; this flag is carried for config parity.
    async_: bool = False
    drawtree: bool = False            # write ASCII Bayes tree to logpath
    showtree: bool = False            # print ASCII Bayes tree after build
    # True: tree upsolve restricts each clique's messages to its
    # subtree-assigned factors (message-likelihood discipline); False: full
    # neighborhood belief products (testHexagonal2D_CliqByCliq.jl:17-26)
    useMsgLikelihoods: bool = True
    qfl: int = 99999999               # quasi fixed-lag window length
    isfixedlag: bool = False
    limitfixeddown: bool = False
    inflation: float = 5.0
    maxincidence: int = 500
    dbg: bool = False
    logpath: str = "/tmp/rome_tpu"
    algorithms: tuple = (":default", ":parametric")
    # solver knobs
    max_iters: int = 100
    lm_lambda0: float = 1e-4
    cg_tol: float = 1e-8
    dtype: str = "float32"


@dataclass
class VariableRecord:
    label: str
    vtype: VariableType
    slot: int                          # index within this type's dense arrays
    timestamp_ns: int = 0
    tags: tuple = ()
    solvable: int = 1
    marginalized: bool = False
    # solvekey -> flat point (np array, point_dim)
    points: dict = field(default_factory=dict)
    # solvekey -> particle array (N, point_dim) for the nonparametric engine
    beliefs: dict = field(default_factory=dict)
    # solvekey -> PPE coords (reference :simulated ground-truth plumbing,
    # GenerateCommon.jl:36-48)
    ppes: dict = field(default_factory=dict)
    initialized: dict = field(default_factory=dict)  # solvekey -> bool

    @property
    def manifold(self):
        return self.vtype.manifold


class FactorGraph:
    """In-memory factor graph (LocalDFG/GraphsDFG analogue)."""

    def __init__(self, params: Optional[SolverParams] = None, session: str = "default"):
        self.params = params or SolverParams()
        self.session = session
        self.variables: dict[str, VariableRecord] = {}
        self.factors: dict[str, Factor] = {}
        self._var_order: list[str] = []   # insertion order
        self._fct_order: list[str] = []
        self._type_counts: dict[str, int] = {}
        self._adj: dict[str, list[str]] = {}  # var label -> factor labels
        self.logs: list[str] = []

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    def add_variable(
        self,
        label: str,
        vtype,
        timestamp_ns: Optional[int] = None,
        tags: Sequence[str] = (),
        solvable: int = 1,
    ) -> VariableRecord:
        """addVariable! analogue."""
        label = str(label)
        if label in self.variables:
            raise ValueError(f"variable {label!r} already exists")
        vt = get_variable_type(vtype)
        slot = self._type_counts.get(vt.name, 0)
        self._type_counts[vt.name] = slot + 1
        rec = VariableRecord(
            label=label,
            vtype=vt,
            slot=slot,
            timestamp_ns=int(timestamp_ns if timestamp_ns is not None else time.time_ns()),
            tags=tuple(tags),
            solvable=int(solvable),
        )
        self.variables[label] = rec
        self._var_order.append(label)
        self._adj[label] = []
        return rec

    def add_factor(
        self,
        var_labels: Sequence[str],
        factor: Factor,
        label: Optional[str] = None,
        graphinit: Optional[bool] = None,
        solvable: int = 1,
        multihypo: Optional[Sequence[float]] = None,
        nullhypo: float = 0.0,
        tags: Sequence[str] = (),
        timestamp_ns: Optional[int] = None,
        inflation: Optional[float] = None,
    ) -> Factor:
        """addFactor! analogue, same kwargs surface (SURVEY.md §5)."""
        var_labels = tuple(str(v) for v in var_labels)
        for v in var_labels:
            if v not in self.variables:
                raise KeyError(f"unknown variable {v!r}")
        expect = factor.ftype.variable_types
        if multihypo is not None and len(var_labels) > len(expect):
            # reference multihypo layout (testMultimodalRangeBearing.jl:53):
            # extra variables are data-association candidates for the LAST
            # factor slot; all must share that slot's type
            for v, et in zip(var_labels[: len(expect) - 1], expect[:-1]):
                at = self.variables[v].vtype
                if at.name != et.name:
                    raise TypeError(
                        f"{factor.ftype.name} slot expects {et.name}, variable {v} is {at.name}"
                    )
            last = expect[-1]
            for v in var_labels[len(expect) - 1 :]:
                at = self.variables[v].vtype
                if at.name != last.name:
                    raise TypeError(
                        f"{factor.ftype.name} candidate slot expects {last.name}, "
                        f"variable {v} is {at.name}"
                    )
            if len(multihypo) != len(var_labels):
                raise ValueError("multihypo length must match variables")
        else:
            if len(var_labels) != len(expect):
                raise ValueError(
                    f"{factor.ftype.name} expects {len(expect)} variables, got {len(var_labels)}"
                )
            for v, et in zip(var_labels, expect):
                at = self.variables[v].vtype
                if at.name != et.name:
                    raise TypeError(
                        f"{factor.ftype.name} slot expects {et.name}, variable {v} is {at.name}"
                    )
        factor.variables = var_labels
        if factor.ftype.needs_dt and "dt" not in factor.params:
            # reference timestamps-to-dt plumbing (DynPoint2D.jl:25:
            # fullvariables[2].nstime - fullvariables[1].nstime)
            ts = [self.variables[v].timestamp_ns for v in var_labels]
            factor.params["dt"] = np.float64(ts[-1] - ts[0]) * 1e-9
        factor.label = label or (factor.ftype.name.lower() + "f_" + "_".join(var_labels))
        if factor.label in self.factors:
            # uniquify like DFG does
            k = 1
            while f"{factor.label}_{k}" in self.factors:
                k += 1
            factor.label = f"{factor.label}_{k}"
        factor.solvable = int(solvable)
        factor.multihypo = list(multihypo) if multihypo is not None else None
        factor.nullhypo = float(nullhypo)
        factor.tags = tuple(tags)
        factor.inflation = inflation
        factor.timestamp_ns = int(
            timestamp_ns if timestamp_ns is not None else time.time_ns()
        )
        self.factors[factor.label] = factor
        self._fct_order.append(factor.label)
        for v in var_labels:
            self._adj[v].append(factor.label)

        do_init = self.params.graphinit if graphinit is None else graphinit
        if do_init:
            self._graphinit_factor(factor)
        return factor

    # ------------------------------------------------------------------
    # queries (ls/lsf/exists/getVariable analogues)
    # ------------------------------------------------------------------
    def exists(self, label: str) -> bool:
        return label in self.variables or label in self.factors

    def ls(self, pattern: Optional[str] = None, tags: Optional[Sequence[str]] = None):
        out = list(self._var_order)
        if pattern is not None:
            rx = re.compile(pattern)
            out = [l for l in out if rx.search(l)]
        if tags:
            ts = set(tags)
            out = [l for l in out if ts & set(self.variables[l].tags)]
        return sorted(out)

    def lsf(self, pattern: Optional[str] = None):
        out = list(self._fct_order)
        if pattern is not None:
            rx = re.compile(pattern)
            out = [l for l in out if rx.search(l)]
        return sorted(out)

    def get_variable(self, label: str) -> VariableRecord:
        return self.variables[str(label)]

    def get_factor(self, label: str) -> Factor:
        return self.factors[str(label)]

    def neighbors(self, label: str):
        label = str(label)
        if label in self.variables:
            return list(self._adj[label])
        return list(self.factors[label].variables)

    @property
    def num_variables(self):
        return len(self.variables)

    @property
    def num_factors(self):
        return len(self.factors)

    # ------------------------------------------------------------------
    # state access
    # ------------------------------------------------------------------
    def get_point(self, label: str, solve_key: str = "parametric") -> np.ndarray:
        rec = self.variables[str(label)]
        if solve_key not in rec.points:
            raise KeyError(f"{label} has no point for solveKey {solve_key!r}")
        return np.asarray(rec.points[solve_key])

    def set_point(self, label: str, point, solve_key: str = "parametric"):
        rec = self.variables[str(label)]
        point = np.asarray(point, dtype=np.float64).reshape(rec.vtype.point_dim)
        rec.points[solve_key] = point
        rec.initialized[solve_key] = True

    def get_coords(self, label: str, solve_key: str = "parametric") -> np.ndarray:
        """Tangent coords of the point (log); e.g. Pose2 -> (x, y, theta)."""
        rec = self.variables[str(label)]
        with host_default_device():
            return np.asarray(rec.manifold.log(np.asarray(rec.points[solve_key])))

    def set_coords(self, label: str, coords, solve_key: str = "parametric"):
        rec = self.variables[str(label)]
        coords = np.asarray(coords, dtype=np.float64).reshape(rec.vtype.dof)
        with host_default_device():
            self.set_point(label, np.asarray(rec.manifold.exp(coords)), solve_key)

    def init_variable(self, label: str, value, solve_key: str = "parametric"):
        """initVariable! analogue: value may be a Distribution (mean taken as
        coords, e.g. g2oParser.jl:66-71) or a flat point / coords array."""
        rec = self.variables[str(label)]
        if isinstance(value, Distribution):
            coords = value.mean()
            self.set_coords(label, coords, solve_key)
        else:
            arr = np.asarray(value, dtype=np.float64).reshape(-1)
            if arr.size == rec.vtype.point_dim:
                self.set_point(label, arr, solve_key)
            elif arr.size == rec.vtype.dof:
                self.set_coords(label, arr, solve_key)
            else:
                raise ValueError(
                    f"value size {arr.size} matches neither point_dim nor dof of {rec.vtype}"
                )

    def is_initialized(self, label: str, solve_key: str = "parametric") -> bool:
        return bool(self.variables[str(label)].initialized.get(solve_key, False))

    # PPE plumbing (reference :simulated ground truth, GenerateCommon.jl:36-48)
    def set_ppe(self, label: str, coords, ppe_key: str = "simulated"):
        self.variables[str(label)].ppes[ppe_key] = np.asarray(coords, dtype=np.float64)

    def get_ppe(self, label: str, ppe_key: str = "simulated") -> np.ndarray:
        return self.variables[str(label)].ppes[ppe_key]

    def get_ppe_suggested(self, label: str, solve_key: str = "parametric"):
        """getPPESuggested analogue — current estimate coords."""
        return self.get_coords(label, solve_key)

    # solvable management (fixed-lag support, RobotUtils.jl:79-98)
    def set_solvable(self, label: str, value: int):
        label = str(label)
        if label in self.variables:
            self.variables[label].solvable = int(value)
        elif label in self.factors:
            self.factors[label].solvable = int(value)
        else:
            raise KeyError(label)

    def set_marginalized(self, label: str, value: bool = True):
        self.variables[str(label)].marginalized = bool(value)

    # ------------------------------------------------------------------
    # initialization (initAll! analogue)
    # ------------------------------------------------------------------
    # Per-(factor-type, slot) jit cache for the closed-form initializers.
    # Eager per-op dispatch costs ~ms; a cached CPU-jitted call is ~100 us,
    # so a 10k-factor graph inits in seconds instead of minutes. Keyed on
    # ftype identity + param keys so retraced only once per factor type.
    _init_jit_cache: dict = {}

    @classmethod
    def _jitted_initializer(cls, ftype, k, man):
        key = (id(ftype), k)
        fn = cls._init_jit_cache.get(key)
        if fn is None:
            import jax

            raw = ftype.initializers[k]
            fn = jax.jit(lambda params, pts: man.normalize(raw(params, pts)))
            cls._init_jit_cache[key] = fn
        return fn

    @on_host
    def _graphinit_factor(self, factor: Factor, solve_key: str = "parametric"):
        """On addFactor!: if exactly the reference graphinit behavior —
        propagate an estimate through the new factor into any uninitialized
        connected variable (closed-form initializer if the factor type has
        one)."""
        recs = [self.variables[v] for v in factor.variables]
        for k, rec in enumerate(recs):
            if rec.initialized.get(solve_key):
                continue
            if factor.ftype.initializers.get(k) is None:
                continue
            others_ready = all(
                recs[j].initialized.get(solve_key) for j in range(len(recs)) if j != k
            )
            if not others_ready and len(recs) > 1:
                continue
            pts = [
                np.asarray(
                    r.points.get(solve_key, np.asarray(r.manifold.identity())),
                    dtype=np.float64,
                )
                for r in recs
            ]
            fn = self._jitted_initializer(factor.ftype, k, rec.manifold)
            newpt = np.asarray(fn(factor.params, pts), dtype=np.float64)
            self.set_point(rec.label, newpt, solve_key)

    @on_host
    def init_all(self, solve_key: str = "parametric", max_sweeps: int = 1000):
        """initAll! analogue: spanning-tree style propagation — repeated
        sweeps of closed-form initializer propagation; whenever a sweep makes
        no progress, seed the first remaining uninitialized variable with the
        manifold identity (the gauge root) and continue. This avoids the
        all-points-identical degenerate start (an exact saddle of the LM
        objective for symmetric graphs)."""
        remaining = [
            fl
            for fl in self._fct_order
            if not all(
                self.variables[v].initialized.get(solve_key, False)
                for v in self.factors[fl].variables
            )
        ]
        for _ in range(max_sweeps):
            progress = False
            still = []
            for flabel in remaining:
                factor = self.factors[flabel]
                before = [
                    self.variables[v].initialized.get(solve_key, False)
                    for v in factor.variables
                ]
                if all(before):
                    continue
                self._graphinit_factor(factor, solve_key)
                after = [
                    self.variables[v].initialized.get(solve_key, False)
                    for v in factor.variables
                ]
                if before != after:
                    progress = True
                if not all(after):
                    still.append(flabel)
            remaining = still
            if not remaining:
                break
            if not progress:
                # seed a root: first uninitialized variable in insertion order
                seeded = False
                for label in self._var_order:
                    rec = self.variables[label]
                    if not rec.initialized.get(solve_key):
                        rec.points[solve_key] = np.asarray(
                            rec.manifold.identity(), dtype=np.float64
                        )
                        rec.initialized[solve_key] = True
                        seeded = True
                        break
                if not seeded:
                    break
        for label, rec in self.variables.items():
            if not rec.initialized.get(solve_key):
                rec.points[solve_key] = np.asarray(rec.manifold.identity(), dtype=np.float64)
                rec.initialized[solve_key] = True

    # ------------------------------------------------------------------
    def __repr__(self):
        return (
            f"FactorGraph(session={self.session!r}, {self.num_variables} variables, "
            f"{self.num_factors} factors)"
        )


# Reference-style free functions ------------------------------------------------

def addVariable(fg: FactorGraph, label, vtype, **kw):
    return fg.add_variable(label, vtype, **kw)


def addFactor(fg: FactorGraph, var_labels, factor: Factor, **kw):
    return fg.add_factor(var_labels, factor, **kw)
