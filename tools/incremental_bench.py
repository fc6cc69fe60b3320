"""Incremental + fixed-lag solve benchmark on the device.

Captures the reference's incremental re-solve story
(/root/reference/examples/ManhattanDatasetIncremental.jl:97-115 per-step
timing + clique-recycle counters; fixed-lag testFixedLagFG.jl:34-121) as a
JSON record:

- FULL manhattan.g2o (5,453 instructions, stride 10 -> 545 solves) with
  fixed-lag on, reporting per-step latency, program-recycle rate, frozen
  drift, convergence reason codes, and end-state ATE vs the batch solve.
- an incremental (no fixed-lag) tier on the first 600 instructions, with
  reason codes on every row (GNOptions.ftol resolves per working dtype, so
  an f32 solve can converge on ftol).
- the shape-bucket ladder is pre-traced by the persistent XLA compile
  cache: run the bench twice (or tools/warmup.py) and the second pass is
  compile-free; rows report compiles-per-step so recycling is auditable.

Writes results/INCREMENTAL.json:
  python tools/incremental_bench.py
"""
import json
import logging
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from rome_tpu.utils.compile_cache import enable as enable_compile_cache

enable_compile_cache()
import jax

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_log_compiles", True)

MANHATTAN = "/root/reference/examples/manhattan.g2o"


class CompileCounter(logging.Handler):
    def __init__(self):
        super().__init__()
        self.count = 0

    def emit(self, record):
        msg = record.getMessage()
        if "Compiling" in msg or "compiling" in msg:
            self.count += 1


def _mk_fg():
    from rome_tpu import FactorGraph, MvNormal, Pose2, PriorPose2

    fg = FactorGraph()
    fg.params.graphinit = False
    fg.add_variable("x0", Pose2)
    fg.add_factor(["x0"], PriorPose2(MvNormal([0, 0, 0], [0.1, 0.1, 0.05])))
    fg.init_variable("x0", [0.0, 0.0, 0.0])
    return fg


def run_incremental(instructions, stride=10, fixedlag=False, qfl=25,
                    verbose_rows=True):
    from rome_tpu import GNOptions, solve_graph_parametric
    from rome_tpu.frontend.robot_utils import fifo_freeze
    from rome_tpu.io.g2o import parse_g2o_instruction

    counter = CompileCounter()
    logging.getLogger("jax").addHandler(counter)
    fg = _mk_fg()
    if fixedlag:
        fg.params.qfl = qfl
        fg.params.isfixedlag = True
    opts = GNOptions(max_iters=30)
    rows = []
    frozen_checkpoint = {}
    max_drift = 0.0
    for i, ins in enumerate(instructions):
        parse_g2o_instruction(fg, ins, initialize=True)
        if (i + 1) % stride == 0:
            if fixedlag:
                fifo_freeze(fg)
            c0 = counter.count
            t0 = time.time()
            res = solve_graph_parametric(
                fg, init=False, options=opts, chordal_init=False, pad=True
            )
            dt = time.time() - t0
            st = res["stats"]
            drift = 0.0
            if fixedlag:
                for lbl, prev in frozen_checkpoint.items():
                    drift = max(
                        drift, float(np.abs(fg.get_coords(lbl) - prev).max())
                    )
                max_drift = max(max_drift, drift)
                for lbl in fg.ls(r"^x\d+$"):
                    if fg.variables[lbl].solvable == 0:
                        frozen_checkpoint[lbl] = fg.get_coords(lbl).copy()
            rows.append(
                dict(
                    step=i + 1,
                    n_vars=fg.num_variables,
                    solve_s=round(dt, 4),
                    iters=st.iterations,
                    converged=st.converged,
                    reason=st.reason,
                    final_cost=round(st.final_cost, 6),
                    compiles=counter.count - c0,
                    **(dict(frozen_drift=drift) if fixedlag else {}),
                )
            )
            if verbose_rows:
                print(json.dumps(rows[-1]), flush=True)
    logging.getLogger("jax").removeHandler(counter)
    return fg, rows, max_drift


def _summary(rows):
    recycled = sum(1 for r in rows if r["compiles"] == 0)
    steady = [r["solve_s"] for r in rows if r["compiles"] == 0]
    unconverged = [r for r in rows if not r["converged"]]
    return dict(
        steps=len(rows),
        steps_recycled_program=recycled,
        recycle_rate=round(recycled / max(1, len(rows)), 3),
        steady_step_latency_s=dict(
            median=round(float(np.median(steady)), 4) if steady else None,
            p90=round(float(np.percentile(steady, 90)), 4) if steady else None,
        ),
        unconverged_steps=len(unconverged),
        unconverged_reasons=sorted(
            {r["reason"] for r in unconverged}
        ),
    )


def _end_state_ate(fg, gt_file):
    gt = np.load(gt_file)["poses"]
    errs = []
    for lbl in fg.ls(r"^x\d+$"):
        i = int(lbl[1:])
        est = fg.get_coords(lbl)
        errs.append(np.sum((est[:2] - gt[i][:2]) ** 2))
    return float(np.sqrt(np.mean(errs)))


def main():
    from rome_tpu.io.g2o import import_g2o

    instructions = import_g2o(MANHATTAN)
    n_inc = int(sys.argv[1]) if len(sys.argv) > 1 else 600
    dev = str(jax.devices()[0])
    print("device:", dev, flush=True)
    gt_file = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "manhattan_gt.npz")

    # tier 1: full dataset, fixed-lag on (the production long-horizon mode)
    t0 = time.time()
    fg_fl, fl_rows, max_drift = run_incremental(
        instructions, fixedlag=True, verbose_rows=False
    )
    fl_wall = time.time() - t0
    fl_sum = _summary(fl_rows)
    print("fixedlag full:", json.dumps(fl_sum), flush=True)

    # tier 2: incremental (growing active window) on the first n_inc
    t0 = time.time()
    fg_inc, inc_rows, _ = run_incremental(
        instructions[:n_inc], fixedlag=False, verbose_rows=False
    )
    inc_wall = time.time() - t0
    inc_sum = _summary(inc_rows)
    print("incremental:", json.dumps(inc_sum), flush=True)

    out = dict(
        device=dev,
        fixedlag_full=dict(
            workload=f"manhattan.g2o ALL {len(instructions)} instructions, "
                     "stride 10, qfl=25",
            wall_s=round(fl_wall, 2),
            **fl_sum,
            max_frozen_drift=max_drift,
            bit_stable=bool(max_drift == 0.0),
            end_state_ate_vs_batch_gt_m=round(
                _end_state_ate(fg_fl, gt_file), 4
            ),
            note=(
                "end-state ATE compares the fixed-lag (frozen-history) "
                "estimate against the full-batch f64 optimum; fixed-lag "
                "freezes poses at their filtered estimates so this bounds "
                "the cost of the lag window, it does not gate"
            ),
        ),
        incremental=dict(
            workload=f"manhattan.g2o first {n_inc} instructions, stride 10",
            wall_s=round(inc_wall, 2),
            **inc_sum,
            rows=inc_rows,
        ),
        fixedlag_rows=fl_rows,
        note=(
            "compiles column counts XLA compilations during that step; 0 = "
            "the shape-bucketed compiled LM program was reused (the "
            "analogue of solveTree! clique recycling, "
            "ManhattanDatasetIncremental.jl:112-115). The persistent XLA "
            "cache pre-traces the bucket ladder across runs."
        ),
    )
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "results", "INCREMENTAL.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", path, flush=True)


if __name__ == "__main__":
    main()
