"""Multi-host runtime initialization (SURVEY.md §2.7).

The reference scales out with Julia ``Distributed.addprocs`` worker
processes on one machine (testBeehiveGrow.jl:7-12). The JAX equivalent is
one process driving every GPU of a host, or one JAX process per host joined
through ``jax.distributed``, with the factor-sharded solve of
:mod:`rome_tpu.parallel.sharding` running over the global mesh — gradient/HVP
psums are collectives across the mesh.

On a single machine this module is exercised in degenerate form
(num_processes=1); the same entry points drive several hosts.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

logger = logging.getLogger("rome_tpu")

_INITIALIZED = False


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
) -> bool:
    """Initialize the multi-host JAX runtime (idempotent).

    Arguments default from the standard env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID) so launchers can stay generic.
    Returns True when a multi-process runtime was initialized, False for
    the single-process fallback (nothing to do).
    """
    global _INITIALIZED
    if _INITIALIZED:
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    num_processes = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    process_id = (
        process_id
        if process_id is not None
        else int(os.environ.get("JAX_PROCESS_ID", "0"))
    )
    if num_processes <= 1 or not coordinator_address:
        logger.info("single-process runtime (no jax.distributed init)")
        return False
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    _INITIALIZED = True
    logger.info(
        "jax.distributed initialized: process %d/%d via %s",
        process_id,
        num_processes,
        coordinator_address,
    )
    return True


def global_mesh(axis: str = "f"):
    """1-D mesh over ALL devices visible to the distributed runtime (local
    devices on a single host; every host's devices after init_distributed)."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    devs = np.array(jax.devices())
    return Mesh(devs, (axis,))


def solve_graph_distributed(fg, mesh=None, solve_key: str = "parametric",
                            chordal_init: bool = False, **kw):
    """End-to-end distributed parametric solve of a FactorGraph: lower,
    optionally chordal-initialize the Pose2 block, shard factor batches over
    the mesh, run the fused on-device LM loop, write results back. The
    multi-device analogue of solve_graph_parametric. Values are carried in
    f64 when x64 is live, as the single-device ndchol/dense32 solvers carry
    them."""
    import jax
    import jax.numpy as jnp

    from rome_tpu.graph.lower import lower, write_back
    from rome_tpu.parallel.sharding import solve_distributed

    mesh = mesh or global_mesh()
    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    ga = lower(fg, solve_key, dtype=dtype)
    values = ga.values0
    if chordal_init and ga.counts.get("Pose2", 0) > 2:
        from rome_tpu.solvers.init2d import chordal_init_pose2

        values = chordal_init_pose2(ga, values)
    values, stats = solve_distributed(ga, mesh, values=values, **kw)
    write_back(fg, ga, values, solve_key)
    return {"stats": stats, "mesh": tuple(mesh.shape.items())}
