"""rome_tpu — SLAM factor-graph state-estimation framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
JuliaRobotics/RoME.jl and its solver stack (IncrementalInference /
DistributedFactorGraphs / ApproxManifoldProducts): manifold variable types,
a vmapped factor library, batched Gauss-Newton/Levenberg-Marquardt parametric
solving, a nonparametric multimodal belief engine, g2o I/O, canonical graph
generators, and front-end runtime utilities. See SURVEY.md for the blueprint.
"""

from rome_tpu.variables import (
    BearingRange2,
    DynPoint2,
    DynPose2,
    IMUBias,
    Point2,
    Point3,
    Polar,
    Pose2,
    Pose3,
    Rotation3,
    RotVelPos,
    VelPos3,
    get_variable_type,
    list_variable_types,
    register_variable_type,
)
from rome_tpu.distributions import (
    Categorical,
    Mixture,
    MvNormal,
    Normal,
    Uniform,
)
from rome_tpu.graph.graph import FactorGraph, SolverParams, addFactor, addVariable
from rome_tpu.factors import *  # noqa: F401,F403 — registers + exports factor ctors
from rome_tpu.factors.base import (
    Factor,
    FactorType,
    get_factor_type,
    list_factor_types,
    register_factor_type,
)
from rome_tpu.io import (
    export_g2o,
    import_g2o,
    load_dfg,
    load_g2o,
    loadDFG,
    save_dfg,
    saveDFG,
)
from rome_tpu.solvers.parametric import solve_graph_parametric, solveGraphParametric
from rome_tpu.solvers.gauss_newton import GNOptions
from rome_tpu.utils.compile_cache import enable as enable_compile_cache

__version__ = "0.1.0"
