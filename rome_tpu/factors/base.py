"""Factor-type machinery: typed residual kernels + instance records.

Design (SURVEY.md §7): the reference dispatches per-factor Julia
functors (``CalcFactor`` closures); here each factor *type* is one pure
residual kernel ``residual(params, *points) -> (zdim,)`` and all instances of
a type stack into a dense batch that the solver vmaps in a single fused XLA
computation. ``params`` is a dict of per-factor arrays; the canonical keys are

  ``z``         (zdim,)        measurement mean in tangent/measurement coords
  ``sqrt_info`` (zdim, zdim)   whitening matrix S with S^T S = inv(cov)

plus factor-specific extras (dt, preintegrated deltas, ...). Residuals return
RAW (unwhitened) tangent-coordinate errors exactly like the reference's
functors (e.g. Pose2D.jl:48-67); the solver applies ``sqrt_info``.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from rome_tpu.distributions import Distribution
from rome_tpu.variables import VariableType


@dataclass(frozen=True)
class FactorType:
    """A factor family: fixed variable signature + one residual kernel."""

    name: str
    variable_types: tuple  # tuple[VariableType, ...]
    zdim: int
    residual: Callable  # (params: dict, *points) -> (zdim,) raw residual
    # closed-form solve of slot k given the measurement and the other
    # variables' points: {slot: fn(params, points) -> point}; used by
    # graph init and the nonparametric convolution fast path.
    initializers: dict = field(default_factory=dict, compare=False)
    # measurement coordinate types ('e' euclidean / 'c' circular) for the
    # KDE layer (cf. reference Deprecated.jl:64-73 coordinate tuples)
    coord_types: tuple = ()
    # reference `partial=` semantics: which tangent dims of the LAST variable
    # the factor constrains (PartialPose3.jl:12-46); None = all dims
    partial: Optional[tuple] = None
    # reference `cfo.fullvariables[k].nstime` semantics (DynPoint2D.jl:25):
    # when True, addFactor! injects params["dt"] = (t_last - t_first) seconds
    # from the bound variables' timestamps (unless the ctor already set it)
    needs_dt: bool = False
    doc: str = ""

    @property
    def arity(self) -> int:
        return len(self.variable_types)

    @property
    def is_prior(self) -> bool:
        return self.arity == 1

    def __repr__(self):
        return f"FactorType({self.name})"


_FACTOR_REGISTRY: dict = {}


def register_factor_type(ft: FactorType) -> FactorType:
    _FACTOR_REGISTRY[ft.name] = ft
    return ft


def get_factor_type(name: str) -> FactorType:
    return _FACTOR_REGISTRY[name]


def list_factor_types():
    return sorted(_FACTOR_REGISTRY)


_label_counter = itertools.count()


@dataclass
class Factor:
    """One factor instance (host-side record; lowered to batches at solve).

    Mirrors the reference ``addFactor!`` kwargs surface: multihypo / nullhypo
    / solvable / tags / inflation (SURVEY.md §5 config table).
    """

    ftype: FactorType
    variables: tuple  # tuple[str, ...] labels
    params: dict  # str -> np.ndarray, stacked later
    dists: tuple = ()  # measurement Distribution objects (sampling engine)
    label: str = ""
    multihypo: Optional[Sequence[float]] = None
    nullhypo: float = 0.0
    solvable: int = 1
    tags: tuple = ()
    timestamp_ns: int = 0
    inflation: Optional[float] = None

    def __post_init__(self):
        if not self.label:
            self.label = (
                self.ftype.name.lower() + "_" + "_".join(self.variables)
            )
        # standardize params to float64 numpy (lowered to device dtype later)
        self.params = {
            k: np.asarray(v, dtype=np.float64) for k, v in self.params.items()
        }

    def __repr__(self):
        return f"{self.ftype.name}({','.join(self.variables)})"


def gaussian_params(mean, cov) -> dict:
    """Standard (z, sqrt_info) params from a Gaussian measurement model."""
    mean = np.asarray(mean, dtype=np.float64).reshape(-1)
    cov = np.asarray(cov, dtype=np.float64)
    cov = 0.5 * (cov + cov.T)
    L = np.linalg.cholesky(cov + 1e-14 * np.eye(cov.shape[0]))
    sqrt_info = np.linalg.inv(L)  # S with S^T S = inv(cov)
    return {"z": mean, "sqrt_info": sqrt_info}


def make_gaussian_factor(ftype: FactorType, variables, dist: Distribution, extra_params=None, **kw) -> Factor:
    """Build a Factor whose measurement model is a single Gaussian-like belief."""
    params = gaussian_params(dist.mean(), dist.cov())
    if extra_params:
        params.update(extra_params)
    return Factor(ftype=ftype, variables=tuple(variables), params=params, dists=(dist,), **kw)
