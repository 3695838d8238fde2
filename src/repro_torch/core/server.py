"""The deployable TCP engine server (the standing Alchemist instance,
§3.1.1): an accept loop wrapping one :class:`AlchemistEngine`, one
handler thread per client connection.

    python -m repro_torch.core.server --port 24960 --device cuda

Each connection is one tenant's private request stream (connection-per-
session — the paper's per-driver socket): its frames are decoded by
``core/wire.py``, dispatched to the engine's existing byte-level
endpoints, and the reply framed back. The engine itself is shared and
already thread-safe, so concurrent tenants interleave exactly as
concurrent in-process contexts do — same scheduler, same caches, same
handle isolation. The frames are the JAX package's, byte for byte: a
client of either package talks to a server of either package.

The engine runs on ``device``: ``"cuda"`` by default, which raises where
CUDA is absent; only an explicit ``"cpu"`` runs on the CPU. An upload is
assembled on the device as it streams in: its chunks are copied, in
arrival order, into the rows of one tensor allocated at its first chunk
(through pinned staging buffers on a card), so the host never holds the
matrix, and a fetch copies one row block at a time back to the host.

Fault containment is per-connection by construction:

* a framing violation (bad magic, wrong version, oversized or truncated
  frame) earns the offender one typed ERROR frame and a hangup — the
  framing state of a byte stream cannot be resynchronized — while every
  other connection's thread never notices;
* a client that vanishes (EOF, reset) mid-anything gets its sessions
  disconnected through the engine's normal teardown: in-flight tasks
  drain, handles and retained results are reclaimed, half-streamed
  uploads are discarded;
* a slow or stalled reader blocks only its own handler thread.

``server.wire_log`` measures the physical cost of every logical call —
frames and bytes per endpoint, both directions — which is where the
socket bridge's "honest bytes on the wire" numbers come from.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import socket
import threading
from typing import Optional

import msgpack
import numpy as np
import torch

from repro_torch.analysis import locktrace, statemachine
from repro_torch.core import protocol, transfer, wire
from repro_torch.core.costmodel import WireLog
from repro_torch.core.engine import SYSTEM_SESSION, AlchemistEngine
from repro_torch.interop import canonical_dtype, dtype_name, numpy_dtype, \
    tensor_to_numpy

DEFAULT_PORT = 24960


def _error_result(session: int, exc: BaseException) -> bytes:
    """Engine-side exception -> error Result bytes, the same
    ``"ExcType: message"`` rendering the engine's own endpoints use."""
    return protocol.encode_result(protocol.Result(
        values={}, error=f"{type(exc).__name__}: {exc}", session=session))


@dataclasses.dataclass
class _Upload:
    """Server-side staging for one in-flight chunked upload: the device
    tensor its chunks land in (allocated at the first chunk), or the one
    whole array of a single-shot send."""
    shape: tuple
    dtype: str
    session: int
    name: Optional[str]
    num_chunks: int
    single: bool
    tensor: Optional[torch.Tensor] = None
    stager: Optional[transfer._Stager] = None
    rows: int = 0                 # rows landed so far, in arrival order
    whole: Optional[np.ndarray] = None
    sizes: list = dataclasses.field(default_factory=list)
    wire_bytes: int = 0
    error: str = ""
    reserved: int = 0      # in-flight bytes held against the QoS quota


class _Connection:
    """One client connection: a dedicated reader/dispatcher thread."""

    _ids = itertools.count(1)

    def __init__(self, server: "AlchemistServer", sock: socket.socket):
        self.server = server
        self.engine = server.engine
        self.sock = sock
        self.rfile = sock.makefile("rb")
        self.sessions: set[int] = set()
        self.uploads: dict[int, _Upload] = {}
        self._upload_ids = itertools.count(1)
        self._send_lock = locktrace.make_lock("server.send")
        # lifecycle monitor: upload streams are keyed per-connection
        # (only this connection's reader thread ever touches them)
        self._stm = statemachine.tracer()
        self.thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"alchemist-conn-{next(self._ids)}")

    def start(self) -> None:
        self.thread.start()

    # ---- framing ------------------------------------------------------
    def _send_frame(self, endpoint: str, frame_type: int,
                    payload: bytes) -> None:
        frame = wire.encode_frame(frame_type, payload)
        with self._send_lock:
            self.sock.sendall(frame)
        self.server.wire_log.record(endpoint, frames_out=1,
                                    bytes_out=len(frame))

    def _send_result(self, endpoint: str, result_bytes: bytes,
                     allow_throttle: bool = False) -> None:
        # admission-control denials ride a THROTTLE frame, not RESULT, so
        # the wire itself distinguishes "engine is full, retry_after_s"
        # from a normal reply — only on the frame types whose reply sets
        # declare THROTTLE (COMMAND, UPLOAD_BEGIN). The substring check
        # is a cheap pre-filter; the decode confirms it is really the
        # error head and not payload bytes that happen to match.
        ftype = wire.FRAME_RESULT
        if allow_throttle and b"AlchemistBusyError" in result_bytes:
            res = protocol.decode_result(result_bytes)
            if res.error.startswith("AlchemistBusyError"):
                ftype = wire.FRAME_THROTTLE
        self._send_frame(endpoint, ftype, result_bytes)

    # ---- lifecycle ----------------------------------------------------
    def _run(self) -> None:
        try:
            self._serve()
        finally:
            self._teardown()

    def _serve(self) -> None:
        while not self.server.stopping:
            try:
                got = wire.read_frame(self.rfile)
            except wire.WireError as e:
                # framing is unrecoverable on a byte stream: tell the
                # offender what it did, then hang up on it — and only it
                try:
                    self._send_frame("error", wire.FRAME_ERROR,
                                     wire.encode_error(e))
                except OSError:
                    pass
                return
            except OSError:
                return                      # reset / server shutdown
            if got is None:
                return                      # clean EOF between frames
            frame_type, payload = got
            try:
                self._dispatch(frame_type, payload)
            except OSError:
                return                      # peer vanished mid-reply

    def _teardown(self) -> None:
        for uid, up in self.uploads.items():
            # a vanished client's half-streamed uploads release their
            # in-flight quota reservations before the data is discarded
            if self._stm.enabled:
                self._stm.note("upload", (id(self), uid), "ABORTED",
                               site="_teardown")
            if up.reserved:
                try:
                    self.engine.release_upload(up.session, up.reserved)
                except Exception:
                    pass                    # engine already shut down
        self.uploads.clear()                # drop half-streamed tensors
        for sid in sorted(self.sessions):
            # the client is gone without a disconnect handshake: run the
            # engine's normal teardown for it — drain in-flight tasks,
            # reclaim handles and retained results
            try:
                self.engine.disconnect(sid)
            except Exception:
                pass                        # engine already shut down
        self.sessions.clear()
        # the makefile reader holds an io-ref on the socket: close it
        # first (and shut the socket down explicitly) so the peer sees
        # FIN now, not whenever the last reference dies
        try:
            self.rfile.close()
        except OSError:
            pass
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        self.server._forget(self)

    def close(self) -> None:
        """Server-initiated hangup (shutdown path)."""
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    # ---- dispatch -----------------------------------------------------
    # generated from the wire-protocol frame registry: request frames
    # dispatch to their registered endpoint, everything else (a client
    # sending a reply-role frame) is refused below — one source of
    # truth with wire.FRAME_TYPES and the client's expected-reply sets
    _ENDPOINTS = wire.REQUEST_ENDPOINTS

    def _dispatch(self, frame_type: int, payload: bytes) -> None:
        endpoint = self._ENDPOINTS.get(frame_type)
        if endpoint is None:
            self._send_frame("error", wire.FRAME_ERROR, wire.encode_error(
                wire.UnknownFrameType(
                    f"frame 0x{frame_type:02x} is not a request")))
            return
        self.server.wire_log.record(
            endpoint, frames_in=1,
            bytes_in=wire.HEADER_BYTES + len(payload))
        if frame_type == wire.FRAME_HANDSHAKE:
            self._do_handshake(payload)
        elif frame_type == wire.FRAME_FREE:
            self._do_free(payload)
        elif frame_type == wire.FRAME_ALIAS_LOOKUP:
            self._do_alias_lookup(payload,
                                  wire.HEADER_BYTES + len(payload))
        elif frame_type == wire.FRAME_UPLOAD_BEGIN:
            self._do_upload_begin(payload,
                                  wire.HEADER_BYTES + len(payload))
        elif frame_type == wire.FRAME_UPLOAD_CHUNK:
            self._do_upload_chunk(payload,
                                  wire.HEADER_BYTES + len(payload))
        elif frame_type == wire.FRAME_UPLOAD_COMMIT:
            self._do_upload_commit(payload,
                                   wire.HEADER_BYTES + len(payload))
        elif frame_type == wire.FRAME_FETCH:
            self._do_fetch(payload)
        else:
            # the byte-level engine endpoints: same bytes in, same bytes
            # out as the in-memory bridge — the engine itself counts the
            # logical crossing in endpoint_counts
            try:
                reply = getattr(self.engine, endpoint)(payload)
            except Exception as e:
                reply = _error_result(0, e)
            self._send_result(
                endpoint, reply,
                allow_throttle=(frame_type == wire.FRAME_COMMAND))

    def _do_handshake(self, payload: bytes) -> None:
        try:
            hs = protocol.decode_handshake(payload)
            if hs.action == protocol.DISCONNECT:
                # a client may ask to disconnect with uploads still open
                # on this connection: abort them (returning their
                # reserved bytes) BEFORE the engine forgets the session,
                # exactly as the vanished-client teardown would — a
                # stream whose session is gone can never commit anyway
                self._abort_session_uploads(hs.session)
            reply = self.engine.handshake(payload)
            res = protocol.decode_result(reply)
            if not res.error:
                if hs.action == protocol.CONNECT:
                    self.sessions.add(res.values["session"])
                elif hs.action == protocol.DISCONNECT:
                    self.sessions.discard(hs.session)
        except Exception as e:
            reply = _error_result(0, e)
        self._send_result("handshake", reply)

    def _abort_session_uploads(self, session: int) -> None:
        """Abort every open upload stream staged for ``session`` on this
        connection, releasing its in-flight quota reservation."""
        for uid in [u for u, up in self.uploads.items()
                    if up.session == session]:
            up = self.uploads.pop(uid)
            if self._stm.enabled:
                self._stm.note("upload", (id(self), uid), "ABORTED",
                               site="_abort_session_uploads")
            if up.reserved:
                try:
                    self.engine.release_upload(up.session, up.reserved)
                except Exception:
                    pass                    # engine already shut down

    def _do_free(self, payload: bytes) -> None:
        try:
            d = msgpack.unpackb(payload)
            handle = protocol._unpack_value(d["handle"])
            session = d.get("session")
            self.engine.free(handle, session=session)
            reply = protocol.encode_result(protocol.Result(
                values={}, session=session or 0))
        except Exception as e:
            reply = _error_result(0, e)
        self._send_result("free", reply)

    # ---- data plane: upload ------------------------------------------
    def _do_alias_lookup(self, payload: bytes, frame_len: int) -> None:
        try:
            d = msgpack.unpackb(payload)
            session = d["session"]
            alias = self.engine.alias_by_fingerprint(
                d["fingerprint"], tuple(d["shape"]), session=session,
                name=d.get("name"))
            if alias is None:
                values = {"hit": False}
            else:
                rec = self.engine.transfer_log.record_dedup(
                    d["logical_nbytes"], "to_engine", session=session,
                    num_chunks=d["num_chunks"], wire_nbytes=frame_len)
                self.engine.cache_log.record(
                    session, "transfer.to_engine", "dedup",
                    bytes_saved=d["logical_nbytes"])
                values = {"hit": True, "handle": alias,
                          "record": dataclasses.asdict(rec)}
            reply = protocol.encode_result(protocol.Result(
                values=values, session=session))
        except Exception as e:
            reply = _error_result(0, e)
        self._send_result("alias_lookup", reply)

    def _do_upload_begin(self, payload: bytes, frame_len: int) -> None:
        try:
            d = msgpack.unpackb(payload)
            self.engine.session(d["session"])     # fail fast, pre-stream
            shape = tuple(d["shape"])
            nbytes = int(np.prod(shape, dtype=np.int64)
                         ) * numpy_dtype(d["dtype"]).itemsize
            # end-to-end backpressure: reserve the declared bytes against
            # the tenant's in-flight quota BEFORE any chunk is staged; a
            # denial replies on a THROTTLE frame and stages nothing
            denial = self.engine.reserve_upload(d["session"], nbytes)
            if denial is not None:
                reason, retry = denial
                self._send_result("upload", protocol.encode_result(
                    protocol.Result(
                        values={}, error=f"AlchemistBusyError: {reason}",
                        session=d["session"], retry_after_s=retry)),
                    allow_throttle=True)
                return
            uid = next(self._upload_ids)
            self.uploads[uid] = _Upload(
                shape=shape, dtype=d["dtype"],
                session=d["session"], name=d.get("name"),
                num_chunks=d["num_chunks"], single=d.get("single", False),
                wire_bytes=frame_len, reserved=nbytes)
            if self._stm.enabled:
                self._stm.mint(
                    "upload", (id(self), uid), site="_do_upload_begin",
                    scope=(self.engine._stm_dom, d["session"]))
            reply = protocol.encode_result(protocol.Result(
                values={"upload": uid}, session=d["session"]))
        except Exception as e:
            reply = _error_result(0, e)
        self._send_result("upload", reply)

    def _land(self, up: _Upload, piece: np.ndarray) -> None:
        """Copy one chunk into the next rows of the upload's device
        tensor (allocated, in the declared dtype's canonical type, at the
        first chunk) — the rows the JAX server's concatenation in arrival
        order gives it."""
        if up.single:
            up.whole = piece
            return
        if up.tensor is None:
            up.tensor = torch.empty(
                up.shape, device=self.engine.device,
                dtype=transfer._torch_dtype(
                    canonical_dtype(numpy_dtype(up.dtype))))
            up.stager = transfer._Stager(up.tensor, max(1, len(piece)))
        lo = up.rows
        if piece.ndim != len(up.shape) or lo + len(piece) > up.shape[0]:
            raise ValueError(
                f"chunk of shape {piece.shape} does not fit rows {lo}.. of "
                f"the declared {up.shape}")
        up.stager.copy(lo, lo + len(piece), piece)
        up.rows = lo + len(piece)

    def _do_upload_chunk(self, payload: bytes, frame_len: int) -> None:
        # pipelined: no reply frame. Faults are remembered on the upload
        # and reported at commit — the one round trip the client reads.
        up = None
        try:
            d = msgpack.unpackb(payload)
            up = self.uploads.get(d["upload"])
            if up is None or up.error:
                return
            up.wire_bytes += frame_len
            piece = wire.unpack_ndarray(d["array"])
            self._land(up, piece)
            if not up.single:
                seq = int(d["seq"])
                up.sizes.append(piece.nbytes)
                self.engine.transfer_log.record(
                    piece.nbytes, "to_engine", session=up.session,
                    chunk_index=seq, num_chunks=up.num_chunks,
                    pipelined=(seq < up.num_chunks - 1),
                    wire_nbytes=frame_len)
        except Exception as e:
            if up is not None:
                up.error = f"{type(e).__name__}: {e}"
                up.tensor = up.stager = None    # drop what landed

    def _assemble(self, up: _Upload) -> torch.Tensor:
        """The upload's device tensor, every declared row landed."""
        if up.single:
            if up.whole is None:
                raise ValueError("single-shot upload sent no array")
            return self.engine._on_device(up.whole)
        if up.tensor is None:           # no chunks: the declared zeros
            return torch.zeros(up.shape, device=self.engine.device,
                               dtype=transfer._torch_dtype(
                                   canonical_dtype(numpy_dtype(up.dtype))))
        up.stager.finish()
        if up.rows != up.shape[0]:
            raise ValueError(f"upload ended after {up.rows} of "
                             f"{up.shape[0]} declared rows")
        return up.tensor

    def _do_upload_commit(self, payload: bytes, frame_len: int) -> None:
        session = 0
        uid = None
        up = None
        try:
            d = msgpack.unpackb(payload)
            uid = d["upload"]
            up = self.uploads.pop(uid, None)
            if up is None:
                raise KeyError(f"unknown upload #{uid}")
            if up.reserved:
                # the transfer is no longer in flight either way: the
                # commit below turns it into resident handle memory
                # (covered by the resident quota), a failure discards it
                self.engine.release_upload(up.session, up.reserved)
                up.reserved = 0
            if up.error:
                raise RuntimeError(f"upload failed mid-stream: {up.error}")
            session = up.session
            up.wire_bytes += frame_len
            arr = transfer.placed(self.engine, self._assemble(up))
            handle = self.engine.put(
                arr, name=up.name, session=session,
                fingerprint=d.get("fingerprint"))
            if up.single:
                # whole-matrix single-shot send: one plain record, like
                # the in-memory non-streamed path (records the device
                # tensor's canonical size, also like it)
                rec = self.engine.transfer_log.record(
                    arr.numel() * arr.element_size(), "to_engine",
                    session=session, wire_nbytes=up.wire_bytes)
            else:
                rec = transfer._aggregate_record(
                    self.engine.transfer_log, sum(up.sizes), "to_engine",
                    session, up.sizes)
                rec.wire_nbytes = up.wire_bytes
            reply = protocol.encode_result(protocol.Result(
                values={"handle": handle,
                        "record": dataclasses.asdict(rec)},
                session=session))
            if self._stm.enabled:
                self._stm.note("upload", (id(self), uid), "COMMITTED",
                               site="_do_upload_commit")
        except Exception as e:
            if up is not None and self._stm.enabled:
                self._stm.note("upload", (id(self), uid), "ABORTED",
                               site="_do_upload_commit")
            reply = _error_result(session, e)
        self._send_result("upload", reply)

    # ---- data plane: fetch -------------------------------------------
    def _do_fetch(self, payload: bytes) -> None:
        try:
            d = msgpack.unpackb(payload)
            handle = protocol._unpack_value(d["handle"])
            session = d.get("session")
            # the store's plain tensor: no layout-tag dispatch per chunk
            arr, _ = self.engine._resolve(handle, session=session)
        except Exception as e:
            self._send_result("fetch", _error_result(0, e))
            return
        sess = SYSTEM_SESSION if session is None else session
        log = self.engine.transfer_log

        if arr.ndim < 1 or arr.shape[0] == 0:
            body = msgpack.packb({"lo": 0, "hi": 0,
                                  "array": wire.pack_ndarray(
                                      tensor_to_numpy(arr))})
            rec = log.record(arr.numel() * arr.element_size(), "to_client",
                             session=sess,
                             wire_nbytes=wire.HEADER_BYTES + len(body))
            self._send_frame("fetch", wire.FRAME_FETCH_META, msgpack.packb(
                {"shape": list(arr.shape), "dtype": dtype_name(arr.dtype),
                 "whole": True,
                 "num_partitions": d.get("num_partitions", 8)}))
            self._send_frame("fetch", wire.FRAME_FETCH_CHUNK, body)
            self._send_frame("fetch", wire.FRAME_FETCH_END, msgpack.packb(
                {"record": dataclasses.asdict(rec)}))
            return

        chunk_rows = d.get("chunk_rows")
        if chunk_rows is None:
            chunk_rows = transfer.chunk_rows_for(tuple(arr.shape),
                                                 arr.element_size())
        chunk_rows = max(1, int(chunk_rows))
        rows = arr.shape[0]
        num_partitions = max(1, min(int(d.get("num_partitions", 8)), rows))
        base, extra = divmod(rows, num_partitions)
        psizes = [base + (1 if i < extra else 0)
                  for i in range(num_partitions)]
        pstarts = [0]
        for s in psizes:
            pstarts.append(pstarts[-1] + s)
        plan = transfer._row_plan(rows, chunk_rows, pstarts[1:-1])

        self._send_frame("fetch", wire.FRAME_FETCH_META, msgpack.packb(
            {"shape": list(arr.shape), "dtype": dtype_name(arr.dtype),
             "whole": False, "psizes": psizes,
             "num_partitions": num_partitions}))
        sizes: list[int] = []
        total = 0
        wire_total = 0
        for idx, (lo, hi) in enumerate(plan):
            block = tensor_to_numpy(arr[lo:hi])
            body = msgpack.packb({"lo": lo, "hi": hi,
                                  "array": wire.pack_ndarray(block)})
            frame_len = wire.HEADER_BYTES + len(body)
            total += block.nbytes
            sizes.append(block.nbytes)
            wire_total += frame_len
            log.record(block.nbytes, "to_client", session=sess,
                       chunk_index=idx, num_chunks=len(plan),
                       pipelined=(idx < len(plan) - 1),
                       wire_nbytes=frame_len)
            self._send_frame("fetch", wire.FRAME_FETCH_CHUNK, body)
        rec = transfer._aggregate_record(log, total, "to_client", sess,
                                         sizes)
        rec.wire_nbytes = wire_total
        self._send_frame("fetch", wire.FRAME_FETCH_END, msgpack.packb(
            {"record": dataclasses.asdict(rec)}))


class AlchemistServer:
    """A TCP front end over one engine: bind, accept, one
    :class:`_Connection` thread per client.

    ``AlchemistServer(engine).start()`` wraps an existing (possibly
    test-owned) engine without taking ownership; constructing with
    ``engine=None`` builds one on ``device`` (``"cuda"`` by default,
    which raises where CUDA is absent) with ``num_workers`` capped at
    that one device, and shuts it down with the server. Usable as a
    context manager.
    """

    def __init__(self, engine: Optional[AlchemistEngine] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 num_workers: Optional[int] = None, device="cuda"):
        self._owns_engine = engine is None
        if engine is None:
            engine = AlchemistEngine(device=device, num_workers=num_workers)
        self.engine = engine
        self.wire_log = WireLog()
        self.stopping = False
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self.host, self.port = self._listener.getsockname()[:2]
        self._conns: set[_Connection] = set()
        self._conns_lock = locktrace.make_lock("server.conns")
        self._accept_thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        """``"host:port"`` — what ``AlchemistContext(address=...)`` takes."""
        return f"{self.host}:{self.port}"

    def start(self) -> "AlchemistServer":
        """Begin accepting connections (returns self for chaining)."""
        self._listener.listen(128)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="alchemist-accept")
        self._accept_thread.start()
        return self

    def _accept_loop(self) -> None:
        while not self.stopping:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return                      # listener closed: shutdown
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Connection(self, sock)
            with self._conns_lock:
                self._conns.add(conn)
            conn.start()

    def _forget(self, conn: _Connection) -> None:
        with self._conns_lock:
            self._conns.discard(conn)

    def stop(self, shutdown_engine: Optional[bool] = None) -> None:
        """Drain and stop: hang up every connection (each handler thread
        then runs the engine's normal session teardown — in-flight tasks
        finish before state is reclaimed), close the listener, and shut
        the engine down iff this server built it (or ``shutdown_engine``
        says so explicitly). Idempotent."""
        if self.stopping:
            return
        self.stopping = True
        # closing a listening socket does not wake a thread blocked in
        # accept(); shutting it down does, so stop() needs no timeout
        for end in (lambda: self._listener.shutdown(socket.SHUT_RDWR),
                    self._listener.close):
            try:
                end()
            except OSError:
                pass
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            conn.close()
        for conn in conns:
            conn.thread.join(timeout=10.0)
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
        if shutdown_engine if shutdown_engine is not None \
                else self._owns_engine:
            self.engine.shutdown()

    def __enter__(self) -> "AlchemistServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.stop()
        return False


def main(argv: Optional[list[str]] = None) -> int:
    """``python -m repro_torch.core.server``: a standing engine on a
    port, holding its device."""
    ap = argparse.ArgumentParser(
        description="Serve an Alchemist engine over TCP")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=DEFAULT_PORT)
    ap.add_argument("--device", default="cuda",
                    help="the engine's device (default cuda, which fails "
                    "where CUDA is absent; cpu runs on the CPU)")
    ap.add_argument("--workers", type=int, default=None,
                    help="engine worker count, capped at the one device")
    ap.add_argument("--compile-cache-dir", default=None,
                    help="keep the index of the program signatures "
                    "served in this directory, so that a restart with "
                    "--warmup rebuilds them (CUDA graphs included) before "
                    "accepting traffic; programs themselves are not kept")
    ap.add_argument("--warmup", action="store_true",
                    help="run the engine's warmup of the bucketable "
                    "catalog before accepting traffic (and again, in the "
                    "background, on library loads)")
    ap.add_argument("--no-bucketing", action="store_true",
                    help="disable shape bucketing engine-wide")
    ap.add_argument("--program-cache-size", type=int, default=None,
                    help="bound on live compiled programs per backend "
                    "(LRU; default 128)")
    args = ap.parse_args(argv)
    engine = AlchemistEngine(
        device=args.device, num_workers=args.workers,
        compile_cache_dir=args.compile_cache_dir,
        bucketing=not args.no_bucketing,
        warmup_on_load=args.warmup,
        program_cache_size=args.program_cache_size)
    if args.warmup:
        stats = engine.warmup()
        print(f"warmup: {stats['compiled']} compiled, "
              f"{stats['cached']} cached, {stats['replayed']} replayed "
              f"from index in {stats['warmup_s']:.2f}s", flush=True)
    server = AlchemistServer(engine=engine, host=args.host,
                             port=args.port).start()
    server._owns_engine = True      # main() built it: shut it down on stop
    print(f"alchemist engine serving on {server.address} "
          f"({server.engine.num_workers} workers); Ctrl-C to stop",
          flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
