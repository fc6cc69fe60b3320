"""Precompile the benchmark-shaped solver programs into the persistent XLA
cache — the analogue of the reference's precompile workload
(/root/reference/src/RoME.jl:145-148 warmUpSolverJIT + the PackageCompiler
sysimage): pay each program's compile once per machine, ever.

Run this once after boot (or let any solve populate the cache); every later
process start then deserializes instead of compiling.

Usage: python tools/warmup.py [--quick]
  --quick: only the small fixtures (octagon), skip M3500/MIT.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from rome_tpu.utils.compile_cache import enable as enable_compile_cache

enable_compile_cache()
jax.config.update("jax_enable_x64", True)


def main(quick=False):
    # import AFTER config so x64 is live for every traced program
    import bench

    datasets = [(bench.OCTAGON, bench._opts()["small"])]
    if not quick:
        datasets += [
            (bench.MANHATTAN, bench._opts()["big"]),
            (bench.MIT, bench._opts()["big"]),
            (bench.CITYGRID, bench._opts()["big"]),
        ]
    for path, opts in datasets:
        t0 = time.time()
        fg = bench._build_graph(path)
        from rome_tpu import solve_graph_parametric

        res = solve_graph_parametric(
            fg, init=False, options=opts, chordal_init=True, schedule="fused"
        )
        print(
            f"warmed {os.path.basename(path)}: {time.time() - t0:.1f}s "
            f"(iters={res['stats'].iterations}, "
            f"converged={res['stats'].converged})",
            flush=True,
        )


if __name__ == "__main__":
    main(quick="--quick" in sys.argv)
