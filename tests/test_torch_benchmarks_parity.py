"""Table 4's modeled rows and kernel_bench's plain versions against the
JAX package: the port's cost model prices the paper's six feature counts
as ``repro.core.costmodel`` does (rtol 1e-12), and at kernel_bench's
shapes (``torch_benchmarks/kernel_bench.py``), on inputs from its numpy
seeds, each plain version matches the JAX package's ``ref`` within the
tolerances of the JAX kernel tests (tests/test_kernels.py:22,35,52,
tests/test_extensions.py:24, tests/test_lru_loss_kernels.py:30), the
refs jitted (lru_scan's associative scan takes 10 s eagerly, 1 s
jitted). The script itself runs on the CPU and times the plain
versions."""
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.costmodel import alchemist_cg_iteration_seconds
from repro.kernels.gram.ref import gram_ref
from repro.kernels.lru_scan.ref import lru_scan_ref
from repro.kernels.normal_matvec.ref import normal_matvec_ref
from repro.kernels.rf_map.ref import rf_map_ref
from repro.kernels.swa.ref import swa_ref
from repro_torch.interop import tensor_to_host

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
kernel_bench = importlib.import_module("torch_benchmarks.kernel_bench")
table4 = importlib.import_module("torch_benchmarks.table4_cg_features")


def test_table4_modeled_rows_are_the_jax_cost_model():
    got = table4.modeled_iteration_seconds()
    assert sorted(got) == [10_000, 20_000, 30_000, 40_000, 50_000, 60_000]
    for feats, seconds in got.items():
        want = alchemist_cg_iteration_seconds(30, 2_251_569, feats)
        assert seconds == pytest.approx(want, rel=1e-12), feats


def _jax_ref(name, arrays):
    window = kernel_bench.SHAPES["swa"][-1]
    if name == "gram":
        return gram_ref(jnp.asarray(arrays["a"]))
    if name == "rf_map":
        return rf_map_ref(*(jnp.asarray(arrays[k]) for k in "xwb"))
    if name == "swa":
        q = jnp.asarray(arrays["q"], jnp.bfloat16)
        return jax.jit(swa_ref, static_argnums=3)(q, q, q, window)
    if name == "normal_matvec":
        return normal_matvec_ref(jnp.asarray(arrays["x"]),
                                 jnp.asarray(arrays["w"]))
    return jax.jit(lru_scan_ref)(*(jnp.asarray(arrays[k])
                                   for k in ("a", "b", "h0")))


# (rtol, atol, atol relative to max |want|)
TOL = {"gram": (2e-5, 2e-5, True), "rf_map": (1e-5, 1e-5, False),
       "swa": (3e-2, 3e-2, False), "normal_matvec": (3e-5, 3e-5, True),
       "lru_scan": (1e-5, 1e-5, False)}


@pytest.mark.parametrize("name", sorted(kernel_bench.SHAPES))
def test_kernel_bench_plain_versions_match_the_jax_refs(name):
    got = tensor_to_host(kernel_bench.plain(
        name, kernel_bench.tensors(name, "cpu")))
    want = np.asarray(_jax_ref(name, kernel_bench.inputs(name)), np.float32)
    assert got.shape == want.shape
    rtol, atol, relative = TOL[name]
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=atol * float(np.abs(want).max()) if relative else atol)


def test_kernel_bench_times_the_plain_versions_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO)]))
    proc = subprocess.run(
        [sys.executable, str(REPO / "torch_benchmarks" / "kernel_bench.py"),
         "--device", "cpu"], capture_output=True, text=True, env=env,
        timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for row in kernel_bench.ROW_NAMES.values():
        assert f"{row}," in proc.stdout
    assert "bound" not in proc.stdout.split("===")[-1]


def test_kernel_bench_bounds_are_the_h100s():
    """The bounds the card run prints: gram's and rf_map's operations on
    3xTF32; normal_matvec (3xTF32), swa (bf16) and lru_scan move more
    bytes at these shapes than they compute."""
    us = {n: kernel_bench.bound_us(n) for n in kernel_bench.SHAPES}
    assert {n: by for n, (_, by) in us.items()} == {
        "gram": "operations", "rf_map": "operations", "swa": "bytes",
        "normal_matvec": "bytes", "lru_scan": "bytes"}
    assert us["gram"][0] == pytest.approx(
        3 * 8192 * 512 * 513 / 495e12 * 1e6)
    assert us["lru_scan"][0] == pytest.approx(
        4.0 * (3 * 2 * 4096 * 4096 + 2 * 4096) / 3.35e12 * 1e6)
    assert us["swa"][0] == pytest.approx(2.0 * 4 * 8 * 2048 * 128
                                         / 3.35e12 * 1e6)
    assert us["rf_map"][0] == pytest.approx(
        3 * 2.0 * 4096 * 440 * 4096 / 495e12 * 1e6)
