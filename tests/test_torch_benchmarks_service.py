"""The port's multi-tenant QoS, cache and chain benchmarks
(``torch_benchmarks/{multiclient_throughput,cache_amortization,
chain_pipelining}.py``) run their ``--smoke`` on the CPU with ``--device
cpu``, in memory and over TCP, each as its own process, and hold the
reference's smoke assertions: the QoS quota engages (the light tenants'
p99 within 2x of solo is printed here and asserted on a card only: the
tenants share the test run's loaded cores); the cold tenant never hits
the cache, every warm tenant hits it three times with zero-byte dedup'd
uploads and no upload frame on the wire, at least 5x faster; the lazy
chain makes one submit a stage and one wait, with the eager chain's
result."""
import os
import re
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


@pytest.mark.parametrize("bridge", ["inmemory", "socket"])
def test_qos_smoke_engages_the_quota(bridge):
    out = _run("multiclient_throughput.py", "--qos", "--smoke",
               "--bridge", bridge)
    rows = dict(re.findall(r"^(solo|off|on),(.*)$", out, re.M))
    assert set(rows) == {"solo", "off", "on"}
    # light_ops,heavy_ops,p50,p99,rejected,preempted,giveups
    on = rows["on"].split(",")
    assert int(on[0]) > 0 and int(on[4]) > 0
    assert int(rows["solo"].split(",")[1]) == 0
    assert "qos/light_p99_ratio_on," in out
    assert "asserted <= 2.0x solo on a card only" in out


@pytest.mark.parametrize("bridge", ["inmemory", "socket"])
def test_cache_amortization_smoke_holds_the_warm_path(bridge):
    out = _run("cache_amortization.py", "--smoke", "--bridge", bridge)
    assert "smoke OK:" in out and "FAIL" not in out
    assert "cache/warm_upload_modeled_bytes,0.0," in out
    if bridge == "socket":
        assert "cache/warm_upload_wire_frames,0.0," in out


def test_chain_pipelining_smoke_holds_the_crossing_contract():
    out = _run("chain_pipelining.py", "--smoke")
    assert "chain_pipelining --smoke OK" in out
    # stages,eager_s,lazy_s,lazy_submit_s,eager_crossings,lazy_crossings
    for stages in (4, 16):
        m = re.search(rf"^{stages},[^,]+,[^,]+,[^,]+,(\d+),(\d+),", out,
                      re.M)
        assert m and (int(m.group(1)), int(m.group(2))) == \
            (2 * stages, stages + 1)
