"""The port's benchmark copies (``torch_benchmarks/``) run on the CPU with
``--device cpu`` at their smallest size, each as its own process, and
exit 0; ``compile_warmup`` holds its zero-request-path contract, in one
process and across two."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _run(script: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO)]))
    proc = subprocess.run(
        [sys.executable, str(REPO / "torch_benchmarks" / script), *args,
         "--device", "cpu"], capture_output=True, text=True, env=env,
        timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


@pytest.mark.parametrize("script", [
    "table2_cg.py", "table3_transfer.py", "table5_svd.py",
    "fig3_weak_scaling.py", "backend_fusion.py"])
def test_benchmark_copy_runs_its_smoke_on_the_cpu(script):
    out = _run(script, "--smoke")
    assert "# ===" in out


def test_compile_warmup_smoke_absorbs_the_mix_on_the_cpu():
    out = _run("compile_warmup.py", "--smoke")
    assert "smoke OK: warm-restart absorbed the tenant mix (zero " \
        "request-path compiles)" in out
    assert "asserted >= 5.0x on a card only" in out


def test_compile_warmup_two_process_round_trip_on_the_cpu():
    out = _run("compile_warmup.py", "--two-process")
    assert "two-process OK" in out


def test_benchmark_copies_import_neither_jax_nor_the_jax_package():
    import re
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\b|"
                         r"from repro[ .]|from benchmarks)", re.M)
    scripts = sorted((REPO / "torch_benchmarks").glob("*.py"))
    assert {p.name for p in scripts} >= {
        "common.py", "compile_warmup.py", "backend_fusion.py",
        "table2_cg.py", "table3_transfer.py", "table5_svd.py",
        "fig3_weak_scaling.py"}
    for p in scripts:
        assert not pattern.search(p.read_text()), p
