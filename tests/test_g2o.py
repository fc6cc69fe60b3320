"""g2o import/export tests (reference: test/testG2oParser.jl,
testG2oExportSE3.jl). Fixtures are synthesized octagon-style rings."""

import numpy as np
import pytest

from rome_tpu import FactorGraph, solve_graph_parametric
from rome_tpu.io.g2o import (
    export_g2o,
    import_g2o,
    load_g2o,
    parse_g2o_instruction,
)
from rome_tpu.utils.math import sym_rem


def _octagon_lines(tmp_path, info=(100.0, 0.0, 0.0, 400.0, 0.0, 1000.0)):
    """8-pose ring, unit legs turned by pi/4 — same shape as the reference
    test/octagon.g2o smoke fixture (synthesized, not copied)."""
    lines = []
    for i in range(8):
        j = (i + 1) % 8
        lines.append(
            f"EDGE_SE2 {i} {j} 1.0 0.0 0.7853981633974483 "
            + " ".join(str(v) for v in info)
        )
    p = tmp_path / "octagon.g2o"
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def test_import_g2o_octagon(tmp_path):
    path = _octagon_lines(tmp_path)
    ins = import_g2o(path)
    assert len(ins) == 8
    fg = load_g2o(None, path)
    assert fg.num_variables == 8
    assert fg.num_factors == 8
    # covariance = inv(info), hermitian-repaired
    f = fg.factors[fg._fct_order[0]]
    cov = f.dists[0].cov()
    info = np.array([[100.0, 0, 0], [0, 400.0, 0], [0, 0, 1000.0]])
    np.testing.assert_allclose(cov, np.linalg.inv(info), atol=1e-12)


@pytest.mark.slow
def test_octagon_parametric_solve(tmp_path):
    """Solve the ring; loop closure closes and every leg is consistent
    (TestPoseAndPoint2Constraints-style parametric accuracy)."""
    path = _octagon_lines(tmp_path)
    fg = load_g2o(None, path)
    res = solve_graph_parametric(fg)
    assert res["stats"].converged
    # ring geometry: radius = 0.5/sin(pi/8)
    R = 0.5 / np.sin(np.pi / 8)
    c0 = fg.get_coords("x0")
    c4 = fg.get_coords("x4")
    dist = np.linalg.norm(c4[:2] - c0[:2])
    np.testing.assert_allclose(dist, 2 * R, rtol=1e-3)
    # consecutive relative poses all equal the measurement
    for i in range(8):
        a = fg.get_point(f"x{i}")
        b = fg.get_point(f"x{(i+1) % 8}")
        from rome_tpu.manifolds.base import SE2_

        rel = np.asarray(SE2_.local(a, b))
        np.testing.assert_allclose(rel, [1.0, 0.0, np.pi / 4], atol=1e-3)


def test_vertex_initialization(tmp_path):
    p = tmp_path / "v.g2o"
    p.write_text(
        "VERTEX_SE2 0 1.0 2.0 0.5\n"
        "VERTEX_SE2 1 2.0 3.0 0.7\n"
        "EDGE_SE2 0 1 1.0 0.0 0.2 100 0 0 100 0 100\n"
    )
    fg = load_g2o(None, str(p))
    # f32 quantization through manifold exp/log is by design (f32 graphs)
    np.testing.assert_allclose(fg.get_coords("x0"), [1, 2, 0.5], atol=1e-6)
    np.testing.assert_allclose(fg.get_coords("x1"), [2, 3, 0.7], atol=1e-6)


def test_se3_edge_parse(tmp_path):
    # rotation of 0.2 rad about z: quat (x,y,z,w) = (0,0,sin(.1),cos(.1))
    qz, qw = np.sin(0.1), np.cos(0.1)
    info_vals = []
    info = np.diag([100.0, 100, 100, 400, 400, 400])
    for i in range(6):
        for j in range(i, 6):
            info_vals.append(info[i, j])
    p = tmp_path / "se3.g2o"
    p.write_text(
        f"EDGE_SE3:QUAT 0 1 1.0 2.0 3.0 0 0 {qz} {qw} "
        + " ".join(str(v) for v in info_vals)
        + "\n"
    )
    fg = load_g2o(None, str(p))
    assert fg.variables["x0"].vtype.name == "Pose3"
    f = fg.factors[fg._fct_order[0]]
    np.testing.assert_allclose(f.params["z"], [1, 2, 3, 0, 0, 0.2], atol=1e-6)
    np.testing.assert_allclose(f.dists[0].cov(), np.linalg.inv(info), atol=1e-12)


def test_export_roundtrip(tmp_path):
    path = _octagon_lines(tmp_path)
    fg = load_g2o(None, path)
    out = export_g2o(fg, str(tmp_path / "out.g2o"))
    fg2 = load_g2o(None, out)
    assert fg2.num_factors == fg.num_factors
    for fl1, fl2 in zip(fg._fct_order, fg2._fct_order):
        f1, f2 = fg.factors[fl1], fg2.factors[fl2]
        np.testing.assert_allclose(f1.params["z"], f2.params["z"], atol=1e-9)
        np.testing.assert_allclose(
            f1.dists[0].cov(), f2.dists[0].cov(), atol=1e-9
        )


def test_export_vertices_with_solvekey(tmp_path):
    path = _octagon_lines(tmp_path)
    fg = load_g2o(None, path)
    solve_graph_parametric(fg)
    out = export_g2o(fg, str(tmp_path / "outv.g2o"), solve_key="parametric")
    lines = open(out).read().splitlines()
    n_vert = sum(1 for ln in lines if ln.startswith("VERTEX_SE2"))
    assert n_vert == 8
