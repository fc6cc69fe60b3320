"""Manhattan incremental solve driver.

Mirrors /root/reference/examples/ManhattanDatasetIncremental.jl: parse g2o
instructions one at a time, re-solve every ``stride`` instructions with
warm-started values (the analogue of solveTree! tree recycling), report
per-step timing, and checkpoint the graph at solve boundaries.

    python examples/manhattan_incremental.py [g2o_path] [max_instructions] [stride]
"""

import sys
import time

from rome_tpu import FactorGraph, GNOptions, MvNormal, PriorPose2, solve_graph_parametric
from rome_tpu.io.g2o import import_g2o, parse_g2o_instruction
from rome_tpu.io.serialization import save_dfg

DEFAULT = "/root/reference/examples/manhattan.g2o"


def main(path=DEFAULT, max_instructions="300", stride="10"):
    max_instructions, stride = int(max_instructions), int(stride)
    instructions = import_g2o(path)[:max_instructions]

    fg = FactorGraph()
    fg.params.graphinit = False
    fg.add_variable("x0", __import__("rome_tpu").Pose2)
    fg.add_factor(["x0"], PriorPose2(MvNormal([0, 0, 0], [0.1, 0.1, 0.05])))
    fg.init_variable("x0", [0.0, 0.0, 0.0])

    opts = GNOptions(max_iters=15)
    for i, ins in enumerate(instructions):
        parse_g2o_instruction(fg, ins, initialize=True)
        if (i + 1) % stride == 0:
            t0 = time.time()
            # warm start from current estimates + bucketed shapes: the
            # compiled LM program is reused within a shape bucket (the
            # analogue of solveTree! tree recycling)
            res = solve_graph_parametric(fg, init=False, options=opts,
                                         chordal_init=False, pad=True)
            dt = time.time() - t0
            st = res["stats"]
            print(f"step {i + 1}: {fg.num_variables} vars, solve {dt:.3f}s, "
                  f"{st.iterations} iters, cost={st.final_cost:.3f}")
    save_dfg(fg, "/tmp/manhattan_incremental_final")
    print("saved final graph to /tmp/manhattan_incremental_final")


if __name__ == "__main__":
    main(*sys.argv[1:])
