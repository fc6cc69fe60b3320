"""chip_smoke.py: refuses to run anywhere but on a GPU."""

import os
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def test_device_check_refuses_cpu():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu()
    assert exc.value.code not in (0, None)


def test_smoke_script_on_cpu_exits_nonzero_without_ok():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


@pytest.mark.gpu
def test_scoring_phase_on_gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU")
    chip_smoke.phase_scoring(jax.devices()[0].device_kind)
