"""The port's copies of the examples (``examples/torch_*.py``) run on the
CPU with ``--device cpu``, each as its own process, and report what the
JAX package's examples report within the same bounds; none imports JAX,
the JAX package or the reference's benchmarks, and with ``--device
cuda`` and no card each raises. The training and serving examples'
parity with the JAX package is in ``test_torch_examples_parity.py``."""
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


def load_example(name: str):
    """``examples/<name>.py`` as a module (the directory is no package)."""
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


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


@pytest.mark.parametrize("arch", ["qwen3-4b", "paligemma-3b",
                                  "whisper-medium"])
def test_serve_decode_serves_every_request(arch, capsys):
    load_example("torch_serve_decode").main(["--arch", arch, "--device",
                                             "cpu"])
    out = capsys.readouterr().out
    assert f"arch={arch}: served 6 requests, 72 new tokens" in out
    assert "'prefills': 2" in out
    assert len(re.findall(r"req\d: prompt\[\d+\] -> \[", out)) == 3


def test_train_lm_refreshes_galore_and_restores_its_checkpoint(tmp_path):
    """The smallest preset, a few short steps, GaLore refreshed through
    the engine after every step, and the checkpoint read back bit for
    bit."""
    ckpt = tmp_path / "ckpt.npz"
    out = _run("torch_train_lm.py", "--preset", "20m", "--steps", "3",
               "--batch", "2", "--seq", "32", "--galore-rank", "4",
               "--galore-refresh", "1", "--ckpt", str(ckpt))
    assert "model lm-20m: ~20M params on cpu" in out
    assert "galore: projecting 20 tensors to rank 4" in out
    assert out.count("[galore refresh via Alchemist]") == 2
    losses = [float(v) for v in re.findall(r"loss (\S+)", out)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert f"checkpoint -> {ckpt} (restored bit for bit)" in out
    assert ckpt.exists()


def test_train_lm_checkpoint_defaults_to_an_ignored_directory():
    mod = load_example("torch_train_lm")
    directory = os.path.dirname(mod.DEFAULT_CKPT) + "/"
    assert directory in (REPO / ".gitignore").read_text().splitlines()


@pytest.mark.parametrize("name", ["torch_train_lm", "torch_serve_decode"])
def test_example_raises_on_cuda_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_example(name).main([])


def test_examples_import_neither_jax_nor_the_jax_package():
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\b|"
                         r"from repro[ .]|from benchmarks)", re.M)
    scripts = sorted((REPO / "examples").glob("torch_*.py"))
    assert {p.name for p in scripts} == {
        "torch_quickstart.py", "torch_ocean_svd.py", "torch_speech_cg.py",
        "torch_train_lm.py", "torch_serve_decode.py"}
    for p in scripts:
        assert not pattern.search(p.read_text()), p
