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
    code = ("import sys, repro_torch, repro_torch.core, "
            "repro_torch.core.server, "
            "repro_torch.models.model, repro_torch.serve.engine, "
            "repro_torch.launch.serve, repro_torch.interop\n"
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


def test_compile_cache_dir_opens_the_index_and_records_a_request(tmp_path):
    """``compile_cache_dir`` opens the executable index there, and a
    served bucketed request lands in it; a second engine on the same
    directory reads it back."""
    cache_dir = str(tmp_path / "cc")
    eng = port_core.AlchemistEngine(device="cpu", cache_entries=0,
                                    compile_cache_dir=cache_dir)
    try:
        assert eng.compile_cache_dir == cache_dir
        assert len(eng._exec_index) == 0
        eng.load_library("elemental", elemental)
        ac = port_core.AlchemistContext(engine=eng)
        ac.call("elemental", "gram",
                A=ac.send_matrix(RNG.randn(37, 5).astype(np.float32)))
        ac.stop()
        [rec] = eng._exec_index.entries(backend="torch")
        assert rec["label"] == "elemental.gram"
        assert rec["input_specs"] == {"i0": [[64, 32], "float32"]}
    finally:
        eng.shutdown()
    again = port_core.AlchemistEngine(device="cpu",
                                      compile_cache_dir=cache_dir)
    try:
        assert [r["key"] for r in again._exec_index.entries()] == \
            [rec["key"]]
    finally:
        again.shutdown()


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


def test_overwrite_keeps_the_layout_the_reference_derives(pair):
    """A tensor computed from an engine array keeps the store's layout
    (the reference's ``layout_of`` reads the sharding such an array
    keeps); a host array is ``replicated``."""
    port, ref = pair
    seen = []
    for ac in (port, ref):
        eng = ac.engine
        a = ac.send_matrix(np.ones((4, 4), np.float32)).handle
        eng.overwrite(a, eng.get(a) * 2)
        derived = eng.layout(a)
        eng.overwrite(a, np.full((4, 4), 3.0, np.float32))
        seen.append((derived, eng.layout(a)))
        np.testing.assert_array_equal(np.asarray(eng.get(a)), 3.0)
    assert seen[0] == seen[1] == ("rowblock", "replicated")


def test_a_bare_tensor_reads_the_layout_the_reference_derives(pair):
    """ROADMAP C3's two inputs, at one worker: a tensor computed from
    ``get`` keeps the store's ``rowblock`` through ``put``, and a fresh
    device array overwriting that store makes it ``replicated``."""
    import jax.numpy as jnp
    port, ref = pair
    seen = []
    for ac, fresh in ((port, torch.zeros), (ref, jnp.zeros)):
        eng = ac.engine
        a = ac.send_matrix(np.ones((4, 4), np.float32)).handle
        derived = eng.layout(eng.put(eng.get(a) * 2))
        eng.overwrite(a, fresh((4, 4), dtype=torch.float32 if ac is port
                               else jnp.float32))
        seen.append((derived, eng.layout(a)))
        np.testing.assert_array_equal(np.asarray(eng.get(a)), 0.0)
    assert seen[0] == seen[1] == ("rowblock", "replicated")


def test_the_layout_tag_stays_outside_the_engine():
    """``get`` hands out the store's tensor (no copy) tagged with the
    layout it carries; what routines and stores hold is a plain tensor; a
    result follows its first operand's tag where it keeps that operand's
    rank and is plain otherwise. A ``layout=`` given to ``put`` labels the
    store only: its tensor carries the tag it came with. The JAX engine
    gives the same layouts for each (ROADMAP C3')."""
    from repro_torch.core import transfer
    from repro_torch.core.layout_tag import LayoutTensor, untag
    eng = port_core.AlchemistEngine(device="cpu")
    try:
        a, _ = transfer.to_engine(eng, np.ones((4, 4), np.float32))
        b = eng.put(torch.ones(4, 4), layout="block2d")
        assert eng.layout(b) == "block2d"
        assert untag(eng.get(b))[1] == "replicated"
        got = eng.get(a)
        assert isinstance(got, LayoutTensor)
        assert got.engine_layout == "rowblock"
        assert got.layout == torch.strided
        assert got.data_ptr() == eng._resolve(a)[0].data_ptr()
        assert type(eng._resolve(a)[0]) is torch.Tensor
        assert untag(got + 1)[1] == "rowblock"
        assert untag(torch.exp(got))[1] == "rowblock"
        for other in (got.T, got[:2], got + eng.get(b)):
            assert untag(other)[1] == "rowblock"
        assert type(got.sum(0)) is torch.Tensor
        h = eng.put(got * 3)
        assert eng.layout(h) == "rowblock"
        assert type(eng._resolve(h)[0]) is torch.Tensor
        eng.overwrite(h, eng.get(b) - 1)
        assert eng.layout(h) == "replicated"
        assert type(eng._resolve(h)[0]) is torch.Tensor
        values, _ = torch.max(got, dim=0)
        assert untag(values)[1] == "replicated"
    finally:
        eng.shutdown()


# ROADMAP C3': the layout of ``put(<a tensor derived from get>)`` at one
# worker, through both packages. A is a 4 x 6 upload, v an 8-vector
# upload, ``fresh`` an untagged (4, 6) array, ``fresh_t`` an untagged
# (6, 4) one, b2 the array of a store put with layout="block2d" from a
# fresh array; ``xp`` is torch or jax.numpy.
_DERIVED = {
    "A.T": lambda A, v, f, ft, b2, xp: A.T,
    "A[:2]": lambda A, v, f, ft, b2, xp: A[:2],
    "A[:, 1:3]": lambda A, v, f, ft, b2, xp: A[:, 1:3],
    "A.reshape(6, 4)": lambda A, v, f, ft, b2, xp: A.reshape(6, 4),
    "A @ A.T": lambda A, v, f, ft, b2, xp: A @ A.T,
    "A.T @ A": lambda A, v, f, ft, b2, xp: A.T @ A,
    "A @ fresh_t": lambda A, v, f, ft, b2, xp: A @ ft,
    "A + fresh": lambda A, v, f, ft, b2, xp: A + f,
    "concatenate([A, A])": lambda A, v, f, ft, b2, xp: xp.cat([A, A]),
    "exp(A)": lambda A, v, f, ft, b2, xp: xp.exp(A),
    "v * 2": lambda A, v, f, ft, b2, xp: v * 2,
    "v[:3]": lambda A, v, f, ft, b2, xp: v[:3],
    "A.sum(0)": lambda A, v, f, ft, b2, xp: A.sum(0),
    "A.sum(1)": lambda A, v, f, ft, b2, xp: A.sum(1),
    "A.max(0)": lambda A, v, f, ft, b2, xp: xp.max0(A),
    "A.sum()": lambda A, v, f, ft, b2, xp: A.sum(),
    "A.ravel()": lambda A, v, f, ft, b2, xp: A.ravel(),
    "A[None]": lambda A, v, f, ft, b2, xp: A[None],
    "A.reshape(2, 2, 6)": lambda A, v, f, ft, b2, xp: A.reshape(2, 2, 6),
    "v.reshape(2, 4)": lambda A, v, f, ft, b2, xp: v.reshape(2, 4),
    "outer(v, v)": lambda A, v, f, ft, b2, xp: xp.outer(v, v),
    "fresh + A": lambda A, v, f, ft, b2, xp: f + A,
    "A + b2": lambda A, v, f, ft, b2, xp: A + b2,
    "b2 - 1": lambda A, v, f, ft, b2, xp: b2 - 1,
}


@pytest.fixture(scope="module")
def derived_pair():
    """Per package: (engine, the operands of _DERIVED) at one worker."""
    import types

    import jax.numpy as jnp
    from repro.core import transfer as ref_transfer
    from repro.core.engine import make_engine_mesh
    from repro_torch.core import transfer
    a = np.arange(24, dtype=np.float32).reshape(4, 6)
    v = np.arange(8, dtype=np.float32)
    out = {}
    for name, eng, tr, xp in (
            ("port", port_core.AlchemistEngine(device="cpu"), transfer,
             types.SimpleNamespace(
                 cat=torch.cat, exp=torch.exp, outer=torch.outer,
                 max0=lambda x: x.max(0).values, ones=torch.ones)),
            ("ref", ref_core.AlchemistEngine(make_engine_mesh(1)),
             ref_transfer,
             types.SimpleNamespace(
                 cat=jnp.concatenate, exp=jnp.exp, outer=jnp.outer,
                 max0=lambda x: x.max(0), ones=jnp.ones))):
        ops = (eng.get(tr.to_engine(eng, a)[0]),
               eng.get(tr.to_engine(eng, v)[0]), xp.ones((4, 6)),
               xp.ones((6, 4)),
               eng.get(eng.put(xp.ones((4, 6)), layout="block2d")), xp)
        out[name] = (eng, ops)
    yield out
    for eng, _ in out.values():
        eng.shutdown()


@pytest.mark.parametrize("case", list(_DERIVED))
def test_a_derived_tensor_reads_the_layout_the_reference_derives(
        derived_pair, case):
    """The layout ``put`` gives an array derived from ``get``: the same in
    both packages for every case (rowblock for a transpose, a slice, a
    same-rank reshape, a product, a concatenation or an elementwise op of
    A; replicated for a reduction, a flatten, a rank change, an untagged
    first operand, and the derivatives of a fresh array labelled
    block2d)."""
    seen = []
    for name in ("port", "ref"):
        eng, ops = derived_pair[name]
        seen.append(eng.layout(eng.put(_DERIVED[case](*ops))))
    assert seen[0] == seen[1], (case, seen)


def test_transfer_records_cross_between_the_packages():
    """A reference record (as its server frames it) decodes as a port
    record, field for field, and the reverse."""
    import dataclasses
    from repro.core.costmodel import TransferLog as RefLog, \
        TransferRecord as RefRecord
    from repro_torch.core.costmodel import TransferLog, TransferRecord
    ref_rec = RefLog().record(4096, "to_engine", session=3, chunk_index=1,
                              num_chunks=4, pipelined=True)
    got = TransferRecord(**dataclasses.asdict(ref_rec))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref_rec)
    assert [f.name for f in dataclasses.fields(TransferRecord)] == \
        [f.name for f in dataclasses.fields(RefRecord)]
    port_rec = TransferLog().record_dedup(512, "to_engine", session=2)
    back = RefRecord(**dataclasses.asdict(port_rec))
    assert back.modeled_reshard_s == 0.0 and back.dedup
    assert dataclasses.asdict(back) == dataclasses.asdict(port_rec)
