"""The port's offload loop on the CPU, held against the JAX package's:
``repro_torch.AlchemistContext(device="cpu")`` and
``repro.AlchemistContext(num_workers=1)`` fed the same numpy matrices —
CG (with and without the random-feature expansion), truncated and Gram
SVD, library catalogs, handle metadata and transfer accounting — plus the
port's import isolation and its explicit-device rule."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core
from repro.core.libraries import elemental as ref_el, skylark as ref_sky
from repro.frontend.rowmatrix import RowMatrix as RefRowMatrix
from repro_torch.core.libraries import elemental, mllib, skylark
from repro_torch.frontend.rowmatrix import RowMatrix

RNG = np.random.RandomState(0)


@pytest.fixture()
def pair():
    """(port context on the CPU, JAX context on one worker), both with
    elemental and skylark loaded."""
    port = port_core.AlchemistContext(device="cpu")
    port.register_library("elemental", elemental)
    port.register_library("skylark", skylark)
    ref = ref_core.AlchemistContext(num_workers=1)
    ref.register_library("elemental", ref_el)
    ref.register_library("skylark", ref_sky)
    yield port, ref
    port.stop()
    ref.stop()


def both(pair, routine_lib, routine, arrays, backend_ref=None, **scalars):
    """Upload ``arrays`` to both engines, call, return the two results
    (outputs fetched as numpy)."""
    port, ref = pair
    if backend_ref is not None:
        ref.configure(backend=backend_ref)
    out = []
    for ac in (port, ref):
        handles = {k: ac.send_matrix(v) for k, v in arrays.items()}
        res = ac.call(routine_lib, routine, **handles, **scalars)
        out.append({k: (ac.wrap(v).to_numpy() if hasattr(v, "shape")
                        and hasattr(v, "layout") else v)
                    for k, v in res.items()})
    return out


def test_cg_without_features_matches_the_jax_backend(pair):
    x = RNG.randn(256, 24).astype(np.float32)
    y = RNG.randn(256, 2).astype(np.float32)
    port, ref = both(pair, "skylark", "cg_solve", {"X": x, "Y": y},
                     lam=1e-3, max_iters=300, tol=1e-10)
    np.testing.assert_allclose(port["W"], ref["W"], atol=1e-4)
    want = np.linalg.solve(x.T @ x + 256 * 1e-3 * np.eye(24), x.T @ y)
    np.testing.assert_allclose(port["W"], want, atol=1e-4)


def test_cg_with_features_matches_the_reference_backend(pair):
    """rf_dim > 0: the port draws (W, b) as the JAX package's reference
    backend does, so the expanded problem — and its solution — agree."""
    x = RNG.randn(200, 16).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[RNG.randint(0, 4, 200)]
    port, ref = both(pair, "skylark", "cg_solve", {"X": x, "Y": y},
                     backend_ref="reference", lam=1e-3, rf_dim=64,
                     bandwidth=4.0, max_iters=200, tol=1e-8, seed=3)
    assert port["expanded_dim"] == ref["expanded_dim"] == 64
    np.testing.assert_allclose(port["W"], ref["W"],
                               atol=1e-4 * np.abs(ref["W"]).max())
    assert port["relative_residual"] <= 1e-7


def test_truncated_svd_matches_numpy_and_jax(pair):
    x = RNG.randn(400, 60) @ np.diag(np.geomspace(10, 0.01, 60))
    port, ref = both(pair, "elemental", "truncated_svd", {"A": x}, k=8)
    want = np.linalg.svd(x, compute_uv=False)[:8]
    np.testing.assert_allclose(port["S"].ravel(), want, rtol=1e-4)
    np.testing.assert_allclose(port["S"].ravel(), ref["S"].ravel(),
                               rtol=1e-4)
    u, v, s = port["U"], port["V"], port["S"].ravel()
    full = np.linalg.svd(x)
    np.testing.assert_allclose(u @ np.diag(s) @ v.T,
                               (full[0][:, :8] * want) @ full[2][:8],
                               atol=1e-3 * want[0])


def test_gram_svd_matches_numpy_and_jax(pair):
    x = RNG.randn(512, 96) @ np.diag(np.geomspace(8, 0.05, 96))
    port, ref = both(pair, "elemental", "gram_svd", {"A": x}, k=6,
                     use_pallas=True)
    want = np.linalg.svd(x, compute_uv=False)[:6]
    np.testing.assert_allclose(port["S"].ravel(), want, rtol=1e-3)
    np.testing.assert_allclose(port["S"].ravel(), ref["S"].ravel(),
                               rtol=1e-3)


@pytest.mark.parametrize("library", ["elemental", "skylark", "_engine"])
def test_describe_catalogs_equal_through_the_wire_codecs(pair, library):
    from repro.core.libraries import spec as ref_spec
    from repro_torch.core.libraries import spec as port_spec
    port, ref = pair
    cat_p = port._describe(library)[library]
    cat_r = ref._describe(library)[library]
    assert cat_p == cat_r
    for rn, d in cat_p["routines"].items():
        assert port_spec.to_wire(port_spec.from_wire(d)) == \
            ref_spec.to_wire(ref_spec.from_wire(cat_r["routines"][rn]))


@pytest.mark.parametrize("make,chunk_rows", [
    (lambda: RNG.randn(100, 7).astype(np.float32), 16),
    (lambda: RNG.randn(64, 5), 10),                    # float64 source
    (lambda: RNG.randn(37), None),                     # 1-D
    (lambda: np.zeros((0, 4), np.float32), None),      # no rows
    ("rowmatrix", 25),
])
def test_uploads_land_alike(pair, make, chunk_rows):
    """Handle dtypes and layouts, bytes and chunk counts of an upload —
    per chunk and in aggregate — equal the JAX engine's."""
    port, ref = pair
    if make == "rowmatrix":
        a = RNG.randn(90, 6).astype(np.float32)
        srcs = (RowMatrix.from_array(a, 4), RefRowMatrix.from_array(a, 4))
    else:
        a = make()
        srcs = (a, a)
    recs = []
    for ac, src in zip((port, ref), srcs):
        n0 = len(ac.engine.transfer_log.records)
        al = ac.send_matrix(src, chunk_rows=chunk_rows, dedup=False)
        h = al.handle
        chunks = [(r.nbytes, r.chunk_index, r.num_chunks, r.direction,
                   r.modeled_socket_s)
                  for r in ac.engine.transfer_log.records[n0:]]
        back = al.to_numpy()
        recs.append((h.shape, h.dtype, h.layout, al.last_transfer.nbytes,
                     al.last_transfer.num_chunks, chunks, back))
    for p, r in zip(recs[0][:-1], recs[1][:-1]):
        assert p == r
    np.testing.assert_array_equal(recs[0][-1], recs[1][-1])


def test_float64_upload_lands_as_float32(pair):
    port, ref = pair
    x = RNG.randn(20, 3)
    for ac in (port, ref):
        al = ac.send_matrix(x)
        assert al.dtype == "float32"
        back = al.to_numpy()
        assert back.dtype == np.float32
        np.testing.assert_allclose(back, x, rtol=1e-6)
    eng = port.engine
    assert eng.get(eng.put(x)).dtype == torch.float32


def test_output_layouts_and_relayouts_match(pair):
    """Outputs land row-block (the engine's layout at one worker); an
    operand tagged block2d is relayouted once, as the JAX engine counts."""
    port, ref = pair
    a = RNG.randn(16, 16).astype(np.float32)
    layouts = []
    for ac in (port, ref):
        eng = ac.engine
        g = ac.call("elemental", "gram", A=ac.send_matrix(a))["G"]
        arr = eng.get(g)
        h = eng.put(arr, session=ac.session, layout="block2d")
        before = eng.task_log.stats().get("relayouts", 0)
        out = ac.call("elemental", "transpose", A=h)["C"]
        layouts.append((g.layout, h.layout, out.layout,
                        eng.task_log.stats().get("relayouts", 0) - before))
    assert layouts[0] == layouts[1] == ("rowblock", "block2d", "rowblock", 1)


def test_spilled_store_reloads_on_the_engine_device():
    eng = port_core.AlchemistEngine(device="cpu", memory_budget_bytes=600)
    a = torch.arange(100, dtype=torch.float32).reshape(25, 4)
    h1 = eng.put(a)
    h2 = eng.put(a * 2)
    assert eng.is_spilled(h1) and not eng.is_spilled(h2)
    assert torch.equal(eng.get(h1), a)
    assert eng.is_spilled(h2)
    eng.shutdown()


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, repro_torch, repro_torch.core\n"
            "bad = [m for m in sys.modules if m in ('jax', 'repro') or "
            "m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad\n")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env=env)


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_core.AlchemistEngine()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_core.AlchemistContext()
    eng = port_core.AlchemistEngine(device="cpu", num_workers=8)
    assert eng.num_workers == 1 and eng.device.type == "cpu"
    eng.shutdown()


def test_compile_cache_dir_is_not_in_this_slice(tmp_path):
    with pytest.raises(NotImplementedError, match="not in this slice"):
        port_core.AlchemistEngine(device="cpu",
                                  compile_cache_dir=str(tmp_path))


def test_mllib_baseline_runs_through_the_port(pair):
    port, _ = pair
    port.register_library("mllib", mllib)
    x = RNG.randn(60, 8).astype(np.float32)
    y = RNG.randn(60, 2).astype(np.float32)
    res = port.call("mllib", "cg_solve", X=port.send_matrix(x),
                    Y=port.send_matrix(y), lam=1e-3, max_iters=200,
                    tol=1e-10)
    want = np.linalg.solve(x.T @ x + 60 * 1e-3 * np.eye(8), x.T @ y)
    np.testing.assert_allclose(port.wrap(res["W"]).to_numpy(), want,
                               atol=1e-4)
