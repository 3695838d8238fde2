"""The port's multi-client throughput sweep
(``torch_benchmarks/multiclient_throughput.py --smoke``: one heavy SVD
tenant beside 0, 1 and 3 light tenants, a one-worker FIFO engine against
the async pool, three interleaved reps of 2 s each) on the CPU with
``--device cpu``, in its own file: its time boxes take about 40 s."""
import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def test_multiclient_smoke_overlaps_the_tenants_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO)]))
    proc = subprocess.run(
        [sys.executable, str(REPO / "torch_benchmarks"
                             / "multiclient_throughput.py"),
         "--smoke", "--device", "cpu"], capture_output=True, text=True,
        env=env, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    rows = re.findall(r"^(\d+),([\d.]+),([\d.]+),", out, re.M)
    assert [r[0] for r in rows] == ["1", "2", "4"]
    assert all(float(s) > 0 and float(a) > 0 for _, s, a in rows)
    # the async pool ran two tasks at once with 2 and 4 clients
    overlap = re.findall(r"^multiclient/overlap_observed,([\d.]+),", out,
                         re.M)
    assert [float(v) for v in overlap] == [2.0, 2.0]
