"""The port's copies of the examples (``examples/torch_*.py``) run on the
CPU with ``--device cpu``, each as its own process, and report what the
JAX package's examples report within the same bounds."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _run(script: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples" / script), *args,
         "--device", "cpu"], capture_output=True, text=True, env=env,
        timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def _number(pattern: str, text: str) -> float:
    m = re.search(pattern, text)
    assert m is not None, (pattern, text)
    return float(m.group(1))


def test_quickstart_reconstructs_and_fuses_the_lazy_chain():
    out = _run("torch_quickstart.py")
    assert _number(r"reconstruction max-error: (\S+)", out) <= 1e-5
    assert _number(r"max \|G - I\| = (\S+)", out) <= 1e-5
    # G = Q.T @ Q, submitted in one burst, ran as one fused task
    assert "(1 fused task)" in out
    assert "engine now serves 2 client sessions" in out


def test_ocean_svd_agrees_with_the_client_side_svd():
    out = _run("torch_ocean_svd.py")
    assert _number(r"sigma agreement \(case1 vs case2\): (\S+)", out) <= 1e-5
    assert len(re.findall(r"x\d: \S+s -> weak-scaled", out)) == 3


@pytest.mark.parametrize("rows,rf", [(4_000, 512)])
def test_speech_cg_classifies_and_agrees_with_the_client_side_solve(rows,
                                                                    rf):
    out = _run("torch_speech_cg.py", "--rows", str(rows), "--rf", str(rf))
    assert _number(r"test accuracy (\S+)", out) >= 0.95
    assert _number(r"solutions agree to (\S+)", out) <= 1e-4
    assert 0 < _number(r"\((\d+) CG iters", out) < 200
