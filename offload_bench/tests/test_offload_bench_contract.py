"""The benchmark's own checks on the CPU: ``BENCHMARK.json`` and the files
it names, the import rules, the counts at the cells' shapes, a tiny run of
every cell through the harness, and the controls and planted faults that
the limits must fail.

    python -m pytest -q offload_bench/tests
"""
from __future__ import annotations

import ast
import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "offload_bench"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from offload_bench import counts, harness  # noqa: E402
from offload_bench.loops.closed_loop import resolve_args  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 2**31 + 12345

# the cells at a size a CPU test run holds; widths are cut here only
SMALL = {
    "timit_cg": {"rows": 4096, "rf_dim": 512,
                 "data": {"kind": "speech_like", "class_seed": 12345,
                          "noise": 0.8, "block_rows": 1024}},
    "ocean_svd": {"rows": 8192, "d": 256,
                  "data": {"kind": "ocean_like", "modes": 24,
                           "span_days": 2010.0, "noise": 0.05,
                           "block_rows": 2048}},
}


def small_cell(name: str) -> harness.Cell:
    config = {w["name"]: w["config"] for w in BENCH["workloads"]}[name]
    return harness.load_cell(BENCH, name, config_overrides=SMALL[config])


def run_small(name: str, traced: bool = False, device: str = "cpu") -> dict:
    import time
    return harness.run_cell(small_cell(name), SEED, 0.5, traced, device,
                            time.perf_counter(), log=lambda *_: None)


DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


@pytest.fixture(params=DEVICES)
def device(request):
    """cpu, and cuda where there is a card (decided here, not at import)."""
    if request.param == "cuda":
        import torch
        if not torch.cuda.is_available():
            pytest.skip("no CUDA card: runs on the card only")
    return request.param


# ---------------------------------------------------------------------------
# BENCHMARK.json and the files it names
# ---------------------------------------------------------------------------
def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["offload_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert all(isinstance(w, str) and 1 <= len(w) <= 200
               for w in BENCH["command"])
    assert (ROOT / BENCH["command"][1]).is_file()


def test_names_and_units_use_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(n for n in names[:len(BENCH["configs"]) + len(CELLS)]))\
        == len(BENCH["configs"]) + len(CELLS)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in [w["why"] for w in BENCH["workloads"]] + \
            [m["layer"] for m in BENCH["per_layer"]] + \
            [c["source"] for c in BENCH["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metric_entries_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert {"setup_s", "job_s", "peak_mem_GB"} <= set(e2e)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_of_a_cell_is_found_by_name(cell):
    c = harness.load_cell(BENCH, cell)
    assert c.config["name"] == {w["name"]: w["config"]
                                for w in BENCH["workloads"]}[cell]
    assert c.config_file.with_suffix(".py").is_file()
    assert (BENCH_DIR / "loops" / f"{c.traffic['loop']}.py").is_file()
    assert c.limits["numbers"]
    for m in c.end_to_end + c.per_layer:
        assert hasattr(harness.reader(m["name"]), "read")


def test_each_config_is_used_and_files_are_its_own():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith("offload_bench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) <= set(cfg["reduced"])


# ---------------------------------------------------------------------------
# imports: nothing of JAX or the JAX package anywhere; the references and
# the shared reference helpers import nothing of the system either
# ---------------------------------------------------------------------------
def _top_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(node.args[0].value.split(".")[0])
    return out


SOURCES = sorted(p for p in BENCH_DIR.rglob("*.py"))
REFERENCES = sorted(BENCH_DIR.glob("configs/*.py")) + \
    [BENCH_DIR / "refkit.py"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_and_no_jax_package(path):
    assert not _top_imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", REFERENCES, ids=lambda p: p.name)
def test_references_import_nothing_of_the_system(path):
    assert not _top_imports(path) & {"repro_torch", "repro", "jax"}
    assert "repro_torch" not in {m for m in _top_imports(path)}


def test_forbidden_check_compares_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in harness.forbidden_modules()


# ---------------------------------------------------------------------------
# counts at the cells' shapes
# ---------------------------------------------------------------------------
def test_kernel_counts_at_the_worked_shapes():
    """The kernels' counts at 1,048,576 rows, worked by hand."""
    n = 1_048_576
    ops, nbytes = counts.normal_matvec(n, 10_000, 147)
    assert ops == pytest.approx(6.166e12, rel=1e-3)
    assert nbytes == pytest.approx(41.94e9, rel=1e-3)
    assert counts.least_seconds(ops, nbytes) * 1e3 == \
        pytest.approx(12.52, rel=1e-3)
    assert nbytes / 3.35e12 > ops / 495e12          # bytes-bound by a hair
    ops, nbytes = counts.rf_map(n, 440, 10_000)
    assert ops == pytest.approx(9.227e12, rel=1e-3)
    assert nbytes == pytest.approx(43.8e9, rel=1e-3)
    assert counts.least_seconds(ops, nbytes) * 1e3 == \
        pytest.approx(18.64, rel=1e-3)
    ops, _ = counts.gram(n, 8096)
    assert ops == pytest.approx(68.74e12, rel=1e-3)
    assert counts.least_seconds(*counts.gram(n, 8096)) * 1e3 == \
        pytest.approx(138.9, rel=1e-3)


# a job's work at the cells' rows, worked by hand: CG 2 n d D + 2 n D c +
# 20 (4 n D c) = n x 129.34e6; gram_svd n d (d + 1) + 2 n d k = n x
# 65,877,152; Lanczos (52 + 1) n d 4 bytes
JOBS = (("solve", "cg_solve", "timit_cg", 1_125_785 * 129.34e6, None),
        ("gram", "gram_svd", "ocean_svd", 2_059_195 * 65_877_152, None),
        ("lanczos", "truncated_svd", "ocean_svd", None,
         53 * 2_059_195 * 8096 * 4))


@pytest.mark.parametrize("traffic,routine,config,want_ops,want_bytes", JOBS,
                         ids=[j[0] for j in JOBS])
def test_counts_at_the_cells_shapes(traffic, routine, config, want_ops,
                                    want_bytes):
    cfg = json.loads((BENCH_DIR / f"configs/{config}.json").read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{traffic}.json")
                         .read_text())
    args = resolve_args(traffic, cfg, 1)
    got_ops = counts.job_ops(routine, cfg, args)
    got_bytes = counts.job_bytes(routine, cfg, args)
    assert (got_ops is None) == (want_ops is None)
    assert (got_bytes is None) == (want_bytes is None)
    if want_ops:
        assert got_ops == pytest.approx(want_ops, rel=1e-12)
    if want_bytes:
        assert got_bytes == want_bytes


def test_peaks_are_the_data_sheets():
    assert counts.PEAKS["tf32_flops_per_s"] == 495e12
    assert counts.PEAKS["hbm_bytes_per_s"] == 3.35e12


# ---------------------------------------------------------------------------
# tiny runs on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_prints_one_well_formed_line(cell, traced, device):
    result = run_small(cell, traced, device)
    line = json.dumps(result)
    back = json.loads(line)
    assert "\n" not in line
    assert list(back)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= \
        set(back)
    assert back["correct"] is True, back["checks"]
    assert back["attempted"] >= 1 and back["failed"] == 0
    c = small_cell(cell)
    want = {m["name"] for m in (c.per_layer if traced else c.end_to_end)}
    assert set(back["metrics"]) <= want
    if device == "cuda":
        assert back["device"]["platform"] == "gpu"
        assert set(back["metrics"]) == want
        if traced:
            assert 0 < back["device"]["busy_s"] <= back["device"]["window_s"]
            for name, m in back["metrics"].items():
                if name.startswith("roofline") or "mfu" in name:
                    assert 0 < m["value"] <= 100, (name, m)
        return
    assert back["device"]["platform"] == "cpu"
    if not traced:
        # no device number from a CPU run
        assert {"job_s", "setup_s"} == set(back["metrics"])
    else:
        assert {"fetch_ms", "outside_engine_ms"} <= set(back["metrics"])
        assert not any(k.startswith("roofline") or k == "device_idle_pct"
                       for k in back["metrics"])
    for name, chk in back["checks"].items():
        assert chk["value"] <= chk["limit"], name


@pytest.mark.parametrize("cell", CELLS)
def test_traffic_holds_only_what_the_loop_reads(cell):
    c = harness.load_cell(BENCH, cell)
    assert set(c.traffic) == {"why", "loop", "library", "routine", "inputs",
                              "args", "outputs"}


# what each cell's spies read in its judged job
SPIED = {"timit_cg.solve": {"z_rows", "p", "ap"},
         "ocean_svd.gram": {"g_rows"}, "ocean_svd.lanczos": set()}


@pytest.mark.parametrize("cell", CELLS)
def test_judged_job_runs_after_the_window_with_its_spies(cell):
    """No window job runs with a spy; the judged job runs afterwards on the
    same engine and inputs, with them."""
    from offload_bench import hooks as hooks_mod
    c = small_cell(cell)
    ref = harness.config_module(c)
    loop = harness.loop_module(c).Loop(c.config, c.traffic, SEED, "cpu",
                                       ref.make_inputs)
    loop.setup()
    try:
        spies = hooks_mod.Hooks(ref.spies(c.config, c.traffic, SEED), set())
        jobs = loop.window(0.2)
        assert jobs and not any(j.error for j in jobs)
        assert loop.answer == {} and spies.store == {}
        engine, handles = loop.engine, dict(loop.handles)
        loop.judged_job(spies)
        assert loop.engine is engine and loop.handles == handles
        assert loop.answer["spy"] is spies.store
        assert set(spies.store) == SPIED[cell]
        assert set(loop.answer["outputs"]) == set(c.traffic["outputs"])
        assert not loop.answer["error"]
        for mod, attr, _ in spies._saved:
            raise AssertionError(f"{mod.__name__}.{attr} left wrapped")
    finally:
        loop.close()


def test_cli_needs_a_card():
    proc = subprocess.run(
        [sys.executable, str(BENCH_DIR / "run.py"), "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


# ---------------------------------------------------------------------------
# the controls and the faults the limits must fail
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, device):
    c = small_cell(cell)
    ref = harness.config_module(c)
    args = resolve_args(c.traffic, c.config, SEED)
    answer = ref.control(c.config, c.traffic, args, SEED, device)
    checks = harness.compare(
        ref.judge(c.config, c.traffic, args, SEED, answer, device), c.limits)
    assert any(v["value"] > v["limit"] for v in checks.values()), checks


def _altered(impl, key):
    """The routine's output ``key`` with one answer altered as it is made."""
    def fn(*args, **kwargs):
        out = dict(impl.fn(*args, **kwargs))
        t = out[key].clone()
        flat = t.view(-1)
        flat[0] += 0.1 * flat.abs().max()
        out[key] = t
        return out
    return dataclasses.replace(impl, fn=fn)


FAULTS = {
    "timit_cg.solve": ["unchanged_step", "half_batch", "altered"],
    "ocean_svd.gram": ["half_batch", "altered", "wrong_top_k"],
    "ocean_svd.lanczos": ["unchanged_step", "half_batch", "altered",
                          "wrong_top_k"],
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items()
                                        for f in fs])
def test_planted_fault_is_not_correct(cell, fault, monkeypatch):
    from repro_torch.core.backends import torch_backend as tb
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.normal_matvec import ops as nm_ops
    routine = {"timit_cg.solve": "cg_solve", "ocean_svd.gram": "gram_svd",
               "ocean_svd.lanczos": "truncated_svd"}[cell]
    library = "skylark" if routine == "cg_solve" else "elemental"
    if fault == "unchanged_step" and routine == "cg_solve":
        monkeypatch.setattr(tb, "_cg_step", lambda x, lam_n, state: state)
    elif fault == "unchanged_step":
        # each Lanczos matvec hands its vector back unchanged
        monkeypatch.setattr(tb, "_lanczos_gram", _unchanged_lanczos(
            tb._lanczos_gram))
    elif fault == "half_batch" and routine == "cg_solve":
        orig = nm_ops.normal_matvec
        monkeypatch.setattr(nm_ops, "normal_matvec", lambda x, w: 2 * orig(
            x[:x.shape[0] // 2].contiguous(), w))
    elif fault == "half_batch" and routine == "gram_svd":
        orig = gram_ops.gram
        monkeypatch.setattr(gram_ops, "gram", lambda a: 2 * orig(
            a[:a.shape[0] // 2].contiguous()))
    elif fault == "half_batch":
        monkeypatch.setitem(tb.TorchBackend._registered,
                            ("elemental", "truncated_svd"),
                            _half_lanczos(tb._lanczos_gram, tb))
    elif fault == "wrong_top_k":
        key = (library, routine)
        monkeypatch.setitem(tb.TorchBackend._registered, key,
                            _wrong_top_k(tb.TorchBackend._registered[key]))
    else:
        key = (library, routine)
        impl = tb.TorchBackend._registered[key]
        monkeypatch.setitem(tb.TorchBackend._registered, key,
                            _altered(impl, "W" if routine == "cg_solve"
                                     else "U"))
    result = run_small(cell)
    assert result["correct"] is False, result["checks"]


def _wrong_top_k(impl):
    """An SVD that hands back the (k + 1)-th triplet in place of the k-th:
    U, S and V agree with one another and G is right, so only the
    comparison of S and V with the reference can fail it."""
    def fn(A, k, *args, **kwargs):
        out = impl.fn(A, k + 1, *args, **kwargs)
        keep = list(range(k - 1)) + [k]
        return {"U": out["U"][:, keep], "S": out["S"][keep],
                "V": out["V"][:, keep]}
    return dataclasses.replace(impl, fn=fn)


def _unchanged_lanczos(lanczos):
    """Lanczos whose every matvec hands its vector back unchanged."""
    def fn(matvec, d, k, m, q0):
        return lanczos(lambda q: q, d, k, m, q0)
    return fn


def _half_lanczos(lanczos, tb):
    """truncated_svd whose Lanczos operator leaves out the second half of
    the rows and doubles the rest (U is still taken over every row)."""
    import torch
    impl = tb.TorchBackend._registered[("elemental", "truncated_svd")]

    def fn(A, *args, **kwargs):
        h = A.shape[0] // 2

        def half(matvec, d, k, m, q0):
            def mv(q):
                qd = torch.from_numpy(q).to(A)
                return (2 * (A[:h].T @ (A[:h] @ qd))).double().numpy()
            return lanczos(mv, d, k, m, q0)

        saved, tb._lanczos_gram = tb._lanczos_gram, half
        try:
            return impl.fn(A, *args, **kwargs)
        finally:
            tb._lanczos_gram = saved
    return dataclasses.replace(impl, fn=fn)


def test_trace_ties_calls_to_their_launches():
    """A call's device time is what the runtime launched on its thread
    inside it, with the wall clock tied to the trace by the jobs' ranges."""
    from offload_bench import trace

    def ev(name, cat, ts, dur, tid=1, corr=None):
        e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
             "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [
        ev(trace.JOB_RANGE, "user_annotation", 1000.0, 3000.0),
        ev(trace.JOB_RANGE, "user_annotation", 5000.0, 3000.0),
        ev("cudaLaunchKernel", "cuda_runtime", 1200.0, 5.0, tid=7, corr=1),
        ev("k", "kernel", 1300.0, 50.0, tid=99, corr=1),
        ev("cudaLaunchKernel", "cuda_runtime", 3000.0, 5.0, tid=7, corr=2),
        ev("k", "kernel", 3100.0, 400.0, tid=99, corr=2),
        ev("cudaLaunchKernel", "cuda_runtime", 1250.0, 5.0, tid=8, corr=3),
        ev("other", "kernel", 1400.0, 20.0, tid=99, corr=3),
    ]
    # the wall clock runs 1,000 us behind the trace's
    marks = [2_000_000, 6_000_000]
    calls = {"m:f": [{"args": [], "tid": 7, "t0_ns": 2_100_000,
                      "t1_ns": 2_500_000}]}
    view = trace.read(events, marks, calls)
    assert view.entries == {"m:f": pytest.approx(50e-6)}
    assert view.window_s == pytest.approx(7000e-6)
    assert view.busy_s == pytest.approx(470e-6)
    assert view.device_ops[0] == ["k", pytest.approx(450e-6)]
