"""The port's TCP server (``repro_torch.core.server``) held against the
JAX package's, across the packages: a client of either package runs the
offload loop against a server of the other, the results match the
serving package's in-memory run, and for one workload both servers put
the same frames on the wire (ids and measured seconds masked; array
bodies byte for byte). Also the server's explicit device and its command
line."""
import os
import re
import signal
import subprocess
import sys

import msgpack
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core
from repro.core import wire as ref_wire
from repro.core.engine import make_engine_mesh
from repro.core.libraries import elemental as ref_el, skylark as ref_sky
from repro.core.server import AlchemistServer as RefServer
from repro_torch.core import protocol, wire
from repro_torch.core.libraries import elemental, skylark
from repro_torch.core.server import AlchemistServer

RNG = np.random.RandomState(5)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _ref_engine():
    eng = ref_core.AlchemistEngine(make_engine_mesh(1))
    eng.load_library("elemental", ref_el)
    eng.load_library("skylark", ref_sky)
    return eng


def _port_engine():
    eng = port_core.AlchemistEngine(device="cpu")
    eng.load_library("elemental", elemental)
    eng.load_library("skylark", skylark)
    return eng


PACKAGES = {
    "ref": (ref_core.AlchemistContext, RefServer, _ref_engine),
    "port": (port_core.AlchemistContext, AlchemistServer, _port_engine),
}


# =====================================================================
# the offload loop, each client against the other package's server
# =====================================================================
X_CG = RNG.randn(200, 16).astype(np.float32)
Y_CG = np.eye(4, dtype=np.float32)[RNG.randint(0, 4, 200)]
A_SVD = RNG.randn(400, 60) @ np.diag(np.geomspace(10, 0.01, 60))
A_GRAM = RNG.randn(512, 96) @ np.diag(np.geomspace(8, 0.05, 96))


def _offload_loop(ac) -> dict:
    """Upload, §4.1 CG with engine-side random features, §4.2 truncated
    and Gram SVD, and every factor streamed back."""
    out = {}
    cg = ac.call("skylark", "cg_solve", X=ac.send_matrix(X_CG, chunk_rows=64),
                 Y=ac.send_matrix(Y_CG), lam=1e-3, rf_dim=64,
                 bandwidth=4.0, max_iters=200, tol=1e-8, seed=3)
    out["W"] = ac.wrap(cg["W"]).to_numpy()
    out["expanded_dim"] = cg["expanded_dim"]
    svd = ac.call("elemental", "truncated_svd",
                  A=ac.send_matrix(A_SVD, chunk_rows=50), k=8)
    for k in ("U", "S", "V"):
        out[f"t{k}"] = ac.wrap(svd[k]).to_numpy()
    gsvd = ac.call("elemental", "gram_svd", A=ac.send_matrix(A_GRAM), k=6,
                   use_pallas=True)
    out["gS"] = ac.wrap(gsvd["S"]).to_numpy()
    return out


@pytest.mark.parametrize("client,server", [("ref", "port"),
                                           ("port", "ref")])
def test_offload_loop_crosses_between_the_packages(client, server):
    """The client of one package drives the other's server; what comes
    back matches the serving package's in-memory run, at the tolerances
    of tests/test_torch_engine.py."""
    ctx_cls, _, _ = PACKAGES[client]
    srv_ctx, srv_cls, make_engine = PACKAGES[server]
    # two engines: one engine's routine cache and upload dedup would hand
    # the second run the first one's results
    served, local = make_engine(), make_engine()
    try:
        with srv_cls(engine=served) as srv:
            with ctx_cls(address=srv.address) as ac:
                assert isinstance(ac.engine, (wire.SocketBridge,
                                              ref_wire.SocketBridge))
                got = _offload_loop(ac)
            assert srv.wire_log.stat("upload").frames_in > 0
        with srv_ctx(engine=local) as ac:
            want = _offload_loop(ac)
    finally:
        served.shutdown()
        local.shutdown()

    assert got["expanded_dim"] == want["expanded_dim"] == 64
    np.testing.assert_allclose(got["W"], want["W"],
                               atol=1e-4 * np.abs(want["W"]).max())
    np.testing.assert_allclose(got["tS"], want["tS"], rtol=1e-4)
    np.testing.assert_allclose(got["gS"], want["gS"], rtol=1e-3)
    s = got["tS"].ravel()
    np.testing.assert_allclose(got["tU"] @ np.diag(s) @ got["tV"].T,
                               want["tU"] @ np.diag(s) @ want["tV"].T,
                               atol=1e-3 * s[0])
    sigma = np.linalg.svd(A_SVD, compute_uv=False)[:8]
    np.testing.assert_allclose(s, sigma, rtol=1e-4)


# =====================================================================
# frame for frame: one client, the two servers
# =====================================================================
# fields the engines mint (session, task, upload and handle ids), the
# seconds they measure, the name of the default backend each package
# brings ("jax", "torch"), and a record's modeled TPU resharding seconds,
# which the port does not model (it records 0.0; ROADMAP A5)
_MASKED = {"session", "task", "upload", "elapsed", "wait_s", "exec_s",
           "saved_s", "_elapsed", "_wait_s", "backend", "modeled_reshard_s"}


def _mask(v, seen: list):
    """``v`` with the _MASKED fields and handle ids replaced; the masked
    reshard seconds are appended to ``seen``."""
    if isinstance(v, dict):
        if protocol._HANDLE_TAG in v:
            hid, *rest = v[protocol._HANDLE_TAG]
            return {"handle": rest}
        seen.extend(x for k, x in v.items() if k == "modeled_reshard_s")
        return {k: ("<masked>" if k in _MASKED else _mask(x, seen))
                for k, x in v.items()}
    if isinstance(v, list):
        return [_mask(x, seen) for x in v]
    return v


def _frames_of(client: str, server: str, monkeypatch) -> list:
    """(direction, frame type, masked payload) of every frame one client
    workload exchanges with ``server``: uploads of float32, float64 and
    bfloat16 sources (chunked, and a dedup hit), a routine call, fetches
    of what was uploaded, a free and the disconnect."""
    import ml_dtypes
    ctx_cls, _, _ = PACKAGES[client]
    _, srv_cls, make_engine = PACKAGES[server]
    bridge_cls = wire.SocketBridge if client == "port" \
        else ref_wire.SocketBridge
    frames, reshard = [], []
    real_send, real_recv = bridge_cls._send, bridge_cls._recv

    def send(self, endpoint, frame_type, payload):
        frames.append(("out", frame_type,
                       _mask(msgpack.unpackb(payload), reshard)))
        return real_send(self, endpoint, frame_type, payload)

    def recv(self, endpoint):
        ftype, payload = real_recv(self, endpoint)
        frames.append(("in", ftype, _mask(msgpack.unpackb(payload), reshard)))
        return ftype, payload

    monkeypatch.setattr(bridge_cls, "_send", send)
    monkeypatch.setattr(bridge_cls, "_recv", recv)
    rng = np.random.RandomState(9)
    x32 = rng.randn(30, 7).astype(np.float32)
    x64 = rng.randn(21, 5)
    xbf = (rng.randn(12, 4) * 3).astype(ml_dtypes.bfloat16)
    eng = make_engine()
    try:
        with srv_cls(engine=eng) as srv:
            with ctx_cls(address=srv.address) as ac:
                sent = [ac.send_matrix(x, chunk_rows=8)
                        for x in (x32, x64, xbf)]
                again = ac.send_matrix(x32, chunk_rows=8)
                assert again.last_transfer.dedup
                g = ac.call("elemental", "gram", A=sent[0])["G"]
                assert tuple(g.shape) == (7, 7)
                for al in sent:
                    ac.fetch(al.handle, num_partitions=3, chunk_rows=5)
                ac.free(again.handle)
    finally:
        eng.shutdown()
        monkeypatch.undo()
    if server == "port":
        assert reshard and set(reshard) == {0.0}
    return frames


@pytest.mark.parametrize("client", ["ref", "port"])
def test_both_servers_exchange_the_same_frames(client, monkeypatch):
    """One client's workload against the JAX server and the port's: the
    same frame types in the same order, and payloads equal once minted
    ids and measured seconds are masked; every chunk body (the uploads
    and the fetches of float32, float64 and bfloat16 sources) is equal
    byte for byte."""
    ref = _frames_of(client, "ref", monkeypatch)
    port = _frames_of(client, "port", monkeypatch)
    assert [(d, t) for d, t, _ in port] == [(d, t) for d, t, _ in ref]
    kinds = {t for _, t, _ in port}
    assert {wire.FRAME_UPLOAD_CHUNK, wire.FRAME_FETCH_CHUNK,
            wire.FRAME_ALIAS_LOOKUP} <= kinds
    for (d, t, p), (_, _, r) in zip(port, ref):
        assert p == r, (d, wire.FRAMES_BY_CODE[t].name, p, r)
    dtypes = {p["dtype"] for d, t, p in port
              if t == wire.FRAME_FETCH_META}
    assert dtypes == {"float32", "bfloat16"}


# =====================================================================
# the explicit device, and the command line
# =====================================================================
def test_server_without_a_device_raises_where_cuda_is_absent():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AlchemistServer()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AlchemistServer(num_workers=2)


def _server_process(*args):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.core.server", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def test_command_line_serves_on_the_cpu_and_stops_on_interrupt():
    """``python -m repro_torch.core.server --device cpu --port 0`` prints
    the reference's startup line, answers a client, and exits 0 on
    Ctrl-C."""
    proc = _server_process("--device", "cpu", "--port", "0",
                           "--workers", "4")
    try:
        line = proc.stdout.readline()
        m = re.match(r"alchemist engine serving on (\S+) \((\d+) workers\)",
                     line)
        assert m, (line, proc.stderr.read() if proc.poll() is not None
                   else "")
        assert m.group(2) == "1"            # capped at the one device
        with port_core.AlchemistContext(address=m.group(1)) as ac:
            ac.register_library("elemental", elemental)
            x = RNG.randn(40, 6).astype(np.float32)
            g = ac.call("elemental", "gram", A=ac.send_matrix(x))["G"]
            np.testing.assert_allclose(ac.wrap(g).to_numpy(), x.T @ x,
                                       rtol=1e-5, atol=1e-4)
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _serve_one_gram(address, x):
    with port_core.AlchemistContext(address=address) as ac:
        ac.register_library("elemental", elemental)
        g = ac.call("elemental", "gram", A=ac.send_matrix(x))["G"]
        got = ac.wrap(g).to_numpy()
        stats = ac.call("_engine", "compile_stats")["engine"]
    return got, stats


def test_command_line_warm_restarts_from_its_compile_cache_dir(tmp_path):
    """``--compile-cache-dir D --warmup``: the first server records the
    signature it served in D's index; a second server on D replays it in
    its warmup before serving, and the same request then compiles nothing
    on the request path (read over the wire)."""
    cache_dir = str(tmp_path / "cc")
    x = RNG.randn(40, 6).astype(np.float32)
    replayed = []
    for run in range(2):
        proc = _server_process("--device", "cpu", "--port", "0",
                               "--compile-cache-dir", cache_dir,
                               "--warmup")
        try:
            line = proc.stdout.readline()
            m = re.match(r"warmup: \d+ compiled, \d+ cached, (\d+) "
                         r"replayed from index", line)
            assert m, (line, proc.stderr.read()
                       if proc.poll() is not None else "")
            replayed.append(int(m.group(1)))
            line = proc.stdout.readline()
            address = re.match(r"alchemist engine serving on (\S+)",
                               line).group(1)
            got, stats = _serve_one_gram(address, x)
            np.testing.assert_allclose(got, x.T @ x, rtol=1e-5, atol=1e-4)
            if run == 0:
                assert stats["request_compiles"] == 1, stats
            else:
                assert stats["request_compiles"] == 0, stats
                assert stats["bucketed_request_compiles"] == 0, stats
            proc.send_signal(signal.SIGINT)
            assert proc.wait(timeout=60) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert replayed[0] == 0 and replayed[1] >= 1
    assert os.path.exists(os.path.join(cache_dir, "executables.json"))


@pytest.mark.parametrize("args,message", [
    (("--port", "0"), "CUDA is not available"),
])
def test_command_line_refuses_what_it_cannot_serve(args, message):
    """The default device is the card: without CUDA the server exits
    non-zero instead of serving on the CPU."""
    if torch.cuda.is_available() and "--device" not in args:
        pytest.skip("this check is for a machine without CUDA")
    proc = _server_process(*args)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert "serving on" not in out
    assert message in err
