"""The port's benchmark copies (``torch_benchmarks/``) run on the CPU with
``--device cpu`` at their smallest size, each as its own process, and
exit 0; ``compile_warmup`` holds its zero-request-path contract, in one
process and across two; ``run.py`` knows the reference's names; with
``device="cuda"`` and no card every copy raises. The multi-tenant, cache
and chain smokes are in ``test_torch_benchmarks_service.py`` and
``test_torch_benchmarks_multiclient.py``; Table 4's modeled rows and
kernel_bench's plain versions against the JAX package in
``test_torch_benchmarks_parity.py``."""
import importlib
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


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


def test_table4_smoke_prints_the_reference_rows():
    out = _run("table4_cg_features.py", "--smoke")
    for rf in (128, 256, 512, 1024):
        assert f"table4/measured_iter_rf{rf}," in out
    assert re.search(r"table4/linearity_ratio,0\.0,t\(1024\)/t\(128\)="
                     r"\S+ \(ideal 8\.0\)", out), out
    for k in range(10, 70, 10):
        assert f"table4/modeled_iter_{k}k," in out


def test_roofline_table_renders_the_dry_runs_records(tmp_path, capsys):
    """One record of ``launch/dryrun.py``: its compute and memory terms,
    no collective column; an empty directory says what to run."""
    from repro_torch.launch import dryrun
    roofline_table = importlib.import_module(
        "torch_benchmarks.roofline_table")
    rec = dryrun.run_one("qwen3-4b", "decode_32k", out_dir=str(tmp_path),
                         verbose=False)
    rows = roofline_table.run("cpu", str(tmp_path))
    out = capsys.readouterr().out
    assert [r["name"] for r in rows] == ["qwen3-4b|decode_32k|1xH100"]
    r = rec["roofline"]
    line = next(ln for ln in out.splitlines()
                if ln.startswith("roofline/qwen3-4b|decode_32k|1xH100,"))
    assert float(line.split(",")[1]) == pytest.approx(
        max(r["compute_s"], r["memory_s"]) * 1e6, rel=1e-3)
    assert f"dominant={r['dominant']}" in line
    assert "collective" not in out
    assert roofline_table.run("cpu", str(tmp_path / "none")) == []
    assert "no dry-run artifacts" in capsys.readouterr().out


def test_run_names_every_benchmark_of_the_reference_and_writes_no_json(
        tmp_path):
    """The reference's names, each bound to a copy; a run writes
    ``BENCH_*.json`` only under ``--json-dir``."""
    names = re.findall(r'^    "(\w+)": ', (REPO / "benchmarks" / "run.py")
                       .read_text(), re.M)
    run = importlib.import_module("torch_benchmarks.run")
    assert set(run.ALL) == set(names) and len(names) == 15
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO)]))
    proc = subprocess.run(
        [sys.executable, "-m", "torch_benchmarks.run", "chain",
         "compile_warmup", "--device", "cpu"], capture_output=True,
        text=True, env=env, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("name,us_per_call,derived")
    assert "first_call_warm_total," in proc.stdout
    assert not list(tmp_path.rglob("*.json"))
    assert run._json(None, "x") is None
    assert run._json(str(tmp_path / "j"), "compile_warmup") == str(
        tmp_path / "j" / "BENCH_compile_warmup.json")


# each copy's entry with device="cuda"
CUDA_CALLS = {
    "table2_cg": lambda m: m.run("cuda", smoke=True),
    "table3_transfer": lambda m: m.run("cuda", smoke=True),
    "table4_cg_features": lambda m: m.run("cuda", smoke=True),
    "table5_svd": lambda m: m.run("cuda", smoke=True),
    "fig3_weak_scaling": lambda m: m.run("cuda", smoke=True),
    "backend_fusion": lambda m: m.run([4], "cuda"),
    "compile_warmup": lambda m: m.run(smoke=True, device="cuda"),
    "multiclient_throughput": lambda m: m.run([1], 0.1, 8, 1,
                                              device="cuda"),
    "cache_amortization": lambda m: m.run(2, (64, 16), 4, True,
                                          device="cuda"),
    "chain_pipelining": lambda m: m.run([2], device="cuda"),
    "kernel_bench": lambda m: m.run("cuda"),
    "roofline_table": lambda m: m.run("cuda"),
    "run": lambda m: m.main(["--device", "cuda", "table4"]),
}


@pytest.mark.parametrize("name", sorted(CUDA_CALLS))
def test_benchmark_copy_raises_on_cuda_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    module = importlib.import_module(f"torch_benchmarks.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CUDA_CALLS[name](module)


def test_compile_warmup_smoke_absorbs_the_mix_on_the_cpu():
    out = _run("compile_warmup.py", "--smoke")
    assert "smoke OK: warm-restart absorbed the tenant mix (zero " \
        "request-path compiles)" in out
    assert "asserted >= 5.0x on a card only" in out


def test_compile_warmup_two_process_round_trip_on_the_cpu():
    out = _run("compile_warmup.py", "--two-process")
    assert "two-process OK" in out


def test_benchmark_copies_import_neither_jax_nor_the_jax_package():
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\b|"
                         r"from repro[ .]|from benchmarks)", re.M)
    scripts = sorted((REPO / "torch_benchmarks").glob("*.py"))
    assert {p.name for p in scripts} >= {
        "common.py", "compile_warmup.py", "backend_fusion.py",
        "table2_cg.py", "table3_transfer.py", "table5_svd.py",
        "fig3_weak_scaling.py", "table4_cg_features.py",
        "multiclient_throughput.py", "cache_amortization.py",
        "chain_pipelining.py", "kernel_bench.py", "roofline_table.py",
        "run.py"}
    assert {p.stem for p in scripts} == set(CUDA_CALLS) | {"common"}
    for p in scripts:
        assert not pattern.search(p.read_text()), p
