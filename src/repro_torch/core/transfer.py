"""The streaming transfer layer: client row-partitioned matrices <->
engine-resident distributed matrices (the paper's TCP-socket path, §3.2).

The paper never ships a matrix in one message: each Spark executor opens a
socket to each Alchemist worker and streams its rows in buffered sends,
which the workers scatter into the Elemental DistMatrix layout. This module
mirrors that: a matrix crosses the bridge as a sequence of row-block
*chunks*. A RowMatrix source is consumed partition-by-partition (peak
client memory is one partition plus one chunk, never the whole matrix),
each chunk is copied through a pinned staging buffer straight into its
rows of one device tensor allocated up front (the matrix is never held
twice on the device), and each chunk logs its own
:class:`~repro_torch.core.costmodel.TransferRecord`, so the cost model — and
``benchmarks/table3_transfer.py``'s chunk-size sweep — sees the same
per-message structure the real sockets have.

Chunk sizing and the cost models use the *source's actual dtype*
(``RowMatrix.dtype`` is tracked client-side exactly for this): a float32
matrix has half the row-bytes of a float64 one, so assuming 8-byte
elements — as this layer once did — doubles chunk sizes and doubles the
modeled socket cost.

**Upload dedup** (``dedup=True``, the default): the matrix's bytes are
digested in row-major order (chunk-boundary invariant — the same bytes
dedup whatever ``chunk_rows`` carried them) and the fingerprint is looked
up in the engine's store index. A re-upload of already-resident content —
the repeated-tenant case of the Cray deployment report — never streams:
the engine mints a handle *alias* over the existing store, and the log
records a zero-byte, zero-second crossing (``TransferRecord.dedup``) with
the avoided payload in ``logical_nbytes``.

The pre-stream hash pass walks the source once more than a plain upload —
cheap for ndarrays (slices are views) and *cached* RowMatrix RDDs
(partitions memoized), which is when it runs. An **uncached** RDD source
(e.g. a bare ``map_rows``) is consumed exactly once: re-iterating it
would recompute every partition, and a nondeterministic lineage need not
even reproduce the bytes the fingerprint was built from — so such uploads
skip the pre-stream lookup and hash inline *during* streaming instead:
the registered fingerprint always matches the bytes that actually
crossed, and later uploads of equal content still dedup against it. Pass
``dedup=False`` to skip hashing entirely (the Table-3 bandwidth sweep
does).

Uploads follow the JAX package's dtype rules (``repro_torch.interop``): a
float64 source lands as float32, exactly as it does in JAX with 64-bit
types off. Transfer records and fingerprints count the *source* bytes,
as the JAX transfer layer does. The cost model records what the same
movement would cost over the paper's sockets.
"""
from __future__ import annotations

import bisect
from typing import Optional

import numpy as np
import torch

from repro_torch.common import spans
from repro_torch.core import cache as caching, layout_tag
from repro_torch.core.costmodel import (
    TransferRecord,
    stream_transfer_seconds_from_chunks,
)
from repro_torch.core.engine import SYSTEM_SESSION, AlchemistEngine
from repro_torch.core.handles import MatrixHandle
from repro_torch.frontend.rowmatrix import RowMatrix
from repro_torch.interop import canonical_dtype, host_to_tensor, \
    numpy_dtype, tensor_to_numpy

# Default chunk size target, in bytes: roughly the socket-buffer ballpark
# the Cray deployment report tunes around. Row counts are derived from it
# per-matrix so a chunk is a whole number of rows.
DEFAULT_CHUNK_BYTES = 4 << 20


def chunk_rows_for(shape, itemsize: int,
                   chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> int:
    """Rows per chunk so a chunk is ~``chunk_bytes`` (at least one row).
    ``itemsize`` must be the source's real element size — see the float32
    note in the module docstring."""
    row_bytes = max(1, int(np.prod(shape[1:])) * itemsize)
    return max(1, chunk_bytes // row_bytes)


def _row_plan(num_rows: int, chunk_rows: int,
              boundaries: list[int]) -> list[tuple[int, int]]:
    """Split ``[0, num_rows)`` into chunks of ``chunk_rows``, additionally
    cut at every device shard boundary so no chunk straddles two shards."""
    chunk_rows = max(1, int(chunk_rows))
    cuts = {0, num_rows}
    cuts.update(b for b in boundaries if 0 < b < num_rows)
    cuts.update(range(0, num_rows, chunk_rows))
    edges = sorted(cuts)
    return list(zip(edges, edges[1:]))


class _Stager:
    """Host-to-device chunk copies through two pinned buffers, so one
    chunk's copy into pinned memory overlaps the previous chunk's DMA to
    the device (a chunk longer than a buffer crosses in buffer-sized
    pieces). On a CPU engine chunks copy straight in."""

    def __init__(self, dst: torch.Tensor, chunk_rows: int):
        self.dst = dst
        self.cuda = dst.device.type == "cuda"
        self.bufs = []
        self.events: list = [None, None]
        if self.cuda:
            shape = (min(chunk_rows, dst.shape[0]),) + tuple(dst.shape[1:])
            self.bufs = [torch.empty(shape, dtype=dst.dtype,
                                     pin_memory=True) for _ in range(2)]
        self.turn = 0

    def copy(self, lo: int, hi: int, chunk: np.ndarray) -> None:
        src = host_to_tensor(chunk, "cpu")
        if not self.cuda:
            self.dst[lo:hi].copy_(src)
            return
        step = self.bufs[0].shape[0]
        for at in range(0, hi - lo, step):
            rows = min(step, hi - lo - at)
            buf, ev = self.bufs[self.turn], self.events[self.turn]
            if ev is not None:
                ev.synchronize()        # its previous DMA has finished
            buf[:rows].copy_(src[at:at + rows])
            self.dst[lo + at:lo + at + rows].copy_(buf[:rows],
                                                   non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            self.events[self.turn] = ev
            self.turn ^= 1

    def finish(self) -> None:
        """Block until every chunk has landed on the device."""
        for ev in self.events:
            if ev is not None:
                ev.synchronize()


def placed(engine: AlchemistEngine, arr: torch.Tensor) -> torch.Tensor:
    """``arr`` placed in the engine's distributed layout, as the JAX
    transfer layer's ``device_put`` to ``dist_sharding`` places an upload:
    ``put`` reads the store's layout from it, and ``get`` hands the tensor
    out tagged so (:mod:`~repro_torch.core.layout_tag`)."""
    return layout_tag.tag(arr, engine.dist_layout(tuple(arr.shape)))


def _aggregate_record(log, nbytes: int, direction: str, session: int,
                      chunk_sizes: list[int]) -> TransferRecord:
    """Whole-stream summary record (returned to the caller, NOT logged —
    the log carries the per-chunk records). ``chunk_index=-1`` marks it as
    an aggregate. Modeled from the stream's *actual* chunk-size list, so
    it equals the sum of the per-chunk records by construction — a mean
    chunk size would disagree whenever shard-boundary cuts leave runts."""
    return TransferRecord(
        nbytes=int(nbytes),
        direction=direction,
        modeled_socket_s=stream_transfer_seconds_from_chunks(
            chunk_sizes, log.client_procs, log.engine_procs),
        modeled_reshard_s=0.0,
        session=session,
        chunk_index=-1,
        num_chunks=len(chunk_sizes),
    )


def to_engine(engine: AlchemistEngine, matrix, name: Optional[str] = None,
              session: int = SYSTEM_SESSION,
              chunk_rows: Optional[int] = None,
              dedup: bool = True
              ) -> tuple[MatrixHandle, TransferRecord]:
    """Stream a client matrix into the engine in row-block chunks (§3.2).

    Accepts a RowMatrix (the IndexedRowMatrix analogue; consumed
    partition-by-partition without collecting) or a plain array. The
    matrix crosses as ``ceil(rows / chunk_rows)`` chunks; each is copied
    into its rows of the engine's device tensor and logged as its own
    TransferRecord tagged with
    ``session`` and its chunk index. ``chunk_rows=None`` picks rows so a
    chunk is ~``DEFAULT_CHUNK_BYTES`` — sized by the source's actual
    dtype, never an assumed float64.

    With ``dedup`` (default), the chunks are content-hashed first and a
    re-upload of already-resident content short-circuits to a handle
    alias with a zero-byte logged crossing (see module docstring).

    Returns ``(handle, aggregate record)`` — the record summarizes the
    whole stream (total bytes, chunk count, stream-modeled socket cost);
    the per-chunk records live in ``engine.transfer_log``.

    A ``torch.Tensor`` input is already device-resident (an engine-side
    service handing over data, not a socket crossing) and takes the
    direct path: one move to the engine device, one record, no host
    round trip (and no content hashing).

    ``engine`` may also be a :class:`~repro_torch.core.wire.SocketBridge`: the
    same chunk plan then crosses as real frames to a remote engine
    server, and the returned record additionally carries the measured
    ``wire_nbytes``.
    """
    if not isinstance(engine, AlchemistEngine):
        return _to_engine_bridge(engine, matrix, name=name,
                                 session=session, chunk_rows=chunk_rows,
                                 dedup=dedup)
    if isinstance(matrix, torch.Tensor):
        arr = matrix.to(engine.device)
        rec = engine.transfer_log.record(arr.numel() * arr.element_size(),
                                         "to_engine", session=session)
        return engine.put(placed(engine, arr), name=name,
                          session=session), rec

    is_rm = isinstance(matrix, RowMatrix)
    if is_rm:
        shape = matrix.shape
        dtype = matrix.dtype      # lazily derived from partition 0
        src = None
    else:
        src = np.asarray(matrix)
        shape = src.shape
        dtype = src.dtype
    itemsize = dtype.itemsize

    if len(shape) < 1 or shape[0] == 0:
        arr = host_to_tensor(matrix.collect() if is_rm else src,
                             engine.device)
        rec = engine.transfer_log.record(arr.numel() * arr.element_size(),
                                         "to_engine", session=session)
        return engine.put(placed(engine, arr), name=name,
                          session=session), rec

    if chunk_rows is None:
        chunk_rows = chunk_rows_for(shape, itemsize)
    chunk_rows = max(1, int(chunk_rows))
    # one device owns every row: no shard boundary cuts the chunk plan
    plan = _row_plan(shape[0], chunk_rows, [])
    num_chunks = len(plan)

    def chunk_stream():
        if is_rm:
            return matrix.iter_sized_row_blocks(
                [hi - lo for lo, hi in plan])
        return (src[lo:hi] for lo, hi in plan)

    # Pre-stream dedup lookup only for sources that are cheap AND safe to
    # iterate twice; uncached RDD lineages hash inline during streaming
    # (see module docstring).
    fingerprint = None
    inline_hasher = None
    if dedup and (not is_rm or matrix.rdd.cached):
        # hash pass: cheap client-side digest before paying the bridge.
        # The fingerprint is chunk-boundary invariant, so digest the raw
        # memoized partitions directly (no re-running the chunk plan's
        # cross-partition concatenation); an ndarray is digested in
        # row-slice pieces — views for C-order sources, and for strided
        # ones at most a chunk-sized copy at a time, never a whole-matrix
        # staging buffer.
        hasher = caching.ContentHasher(shape, dtype)
        logical = 0
        pieces = (matrix.rdd.partition(i)
                  for i in range(matrix.rdd.num_partitions)) \
            if is_rm else (src[lo:hi] for lo, hi in plan)
        for piece in pieces:
            piece = np.asarray(piece)
            hasher.update(piece)
            logical += piece.nbytes
        fingerprint = hasher.fingerprint()
        alias = engine.alias_by_fingerprint(fingerprint, shape,
                                           session=session, name=name)
        if alias is not None:
            rec = engine.transfer_log.record_dedup(
                logical, "to_engine", session=session,
                num_chunks=num_chunks)
            engine.cache_log.record(session, "transfer.to_engine",
                                    "dedup", bytes_saved=logical)
            return alias, rec
    elif dedup:
        inline_hasher = caching.ContentHasher(shape, dtype)

    arr = torch.empty(tuple(shape), device=engine.device,
                      dtype=_torch_dtype(canonical_dtype(dtype)))
    stager = _Stager(arr, chunk_rows)
    sizes: list[int] = []
    total = 0
    for idx, ((lo, hi), chunk) in enumerate(zip(plan, chunk_stream())):
        chunk = np.ascontiguousarray(chunk)
        if inline_hasher is not None:
            inline_hasher.update(chunk)
        total += chunk.nbytes
        sizes.append(chunk.nbytes)
        engine.transfer_log.record(
            chunk.nbytes, "to_engine", session=session,
            chunk_index=idx, num_chunks=num_chunks,
            pipelined=(idx < num_chunks - 1))
        stager.copy(lo, hi, chunk)
    stager.finish()
    if inline_hasher is not None:
        fingerprint = inline_hasher.fingerprint()
    rec = _aggregate_record(
        engine.transfer_log, total, "to_engine", session, sizes)
    return engine.put(placed(engine, arr), name=name, session=session,
                      fingerprint=fingerprint), rec


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    """The torch dtype of a (canonical) numpy dtype."""
    if dtype.name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _to_engine_bridge(bridge, matrix, name: Optional[str],
                      session: int, chunk_rows: Optional[int],
                      dedup: bool) -> tuple[MatrixHandle, TransferRecord]:
    """``to_engine`` over a :class:`~repro_torch.core.wire.SocketBridge`: the
    same chunk plan and the same dedup rules, carried by real frames.

    Differences from the in-process path are exactly the ones a socket
    forces: chunks are cut purely by ``chunk_rows`` (the client cannot
    see the remote engine's layout — the server re-lays the assembled
    matrix out itself), and a device-resident ``torch.Tensor``
    cannot be handed over by reference, so it crosses as one whole-
    matrix frame (still a single logged record, like the in-memory
    direct path). Content fingerprints are computed client-side with the
    same chunk-boundary-invariant hash, so uploads dedup across bridges.
    """
    if isinstance(matrix, torch.Tensor):
        src = tensor_to_numpy(matrix)
        return bridge.upload(src.shape, src.dtype, [src],
                             session=session, name=name, single=True)

    is_rm = isinstance(matrix, RowMatrix)
    if is_rm:
        shape = matrix.shape
        dtype = matrix.dtype
        src = None
    else:
        src = np.asarray(matrix)
        shape = src.shape
        dtype = src.dtype

    if len(shape) < 1 or shape[0] == 0:
        arr = np.asarray(matrix.collect() if is_rm else src)
        return bridge.upload(arr.shape, arr.dtype, [arr],
                             session=session, name=name, single=True)

    if chunk_rows is None:
        chunk_rows = chunk_rows_for(shape, dtype.itemsize)
    plan = _row_plan(shape[0], chunk_rows, [])
    num_chunks = len(plan)

    def chunk_stream():
        if is_rm:
            return matrix.iter_sized_row_blocks([hi - lo for lo, hi in plan])
        return (src[lo:hi] for lo, hi in plan)

    fingerprint = None
    inline_hasher = None
    if dedup and (not is_rm or matrix.rdd.cached):
        hasher = caching.ContentHasher(shape, dtype)
        logical = 0
        pieces = (matrix.rdd.partition(i)
                  for i in range(matrix.rdd.num_partitions)) \
            if is_rm else (src[lo:hi] for lo, hi in plan)
        for piece in pieces:
            piece = np.asarray(piece)
            hasher.update(piece)
            logical += piece.nbytes
        fingerprint = hasher.fingerprint()
        hit = bridge.alias_lookup(fingerprint, shape, session, name,
                                  logical, num_chunks)
        if hit is not None:
            return hit
    elif dedup:
        inline_hasher = caching.ContentHasher(shape, dtype)

    def hashed_chunks():
        for chunk in chunk_stream():
            chunk = np.ascontiguousarray(chunk)
            if inline_hasher is not None:
                inline_hasher.update(chunk)
            yield chunk

    fp = fingerprint if inline_hasher is None \
        else (lambda: inline_hasher.fingerprint())
    return bridge.upload(shape, dtype, hashed_chunks(), session=session,
                         name=name, num_chunks=num_chunks, fingerprint=fp)


def to_client(engine: AlchemistEngine, handle: MatrixHandle,
              num_partitions: int = 8, session: Optional[int] = None,
              chunk_rows: Optional[int] = None
              ) -> tuple[RowMatrix, TransferRecord]:
    """Stream an engine matrix back to the client as a RowMatrix (§3.2,
    reverse direction — the paper's ``toIndexedRowMatrix()``).

    The fetch crosses in row-block chunks, one TransferRecord per chunk
    plus an aggregate record returned to the caller; ``session`` applies
    the same namespace check as routine dispatch.

    Chunks land *directly in the per-partition blocks* backing the
    returned RowMatrix (the chunk plan is additionally cut at partition
    boundaries so no chunk straddles two blocks): beyond the result's own
    storage, peak host allocation is one chunk — never a whole-matrix
    staging buffer.

    Over a :class:`~repro_torch.core.wire.SocketBridge` the same chunks arrive
    as FETCH frames and land in the same per-partition blocks.
    """
    if not isinstance(engine, AlchemistEngine):
        return _to_client_bridge(engine, handle, num_partitions,
                                 session=session, chunk_rows=chunk_rows)
    arr, _ = engine._resolve(handle, session=session)
    sess = SYSTEM_SESSION if session is None else session
    if arr.ndim < 1 or arr.shape[0] == 0:
        host = tensor_to_numpy(arr)
        rec = engine.transfer_log.record(host.nbytes, "to_client",
                                         session=sess)
        return RowMatrix.from_array(host, num_partitions), rec

    if chunk_rows is None:
        chunk_rows = chunk_rows_for(tuple(arr.shape), arr.element_size())
    chunk_rows = max(1, int(chunk_rows))
    rows = arr.shape[0]
    num_partitions = max(1, min(num_partitions, rows))
    # partition bounds exactly as np.array_split (what from_array used):
    # the first rows % P partitions carry one extra row
    base, extra = divmod(rows, num_partitions)
    psizes = [base + (1 if i < extra else 0) for i in range(num_partitions)]
    pstarts = [0]
    for s in psizes:
        pstarts.append(pstarts[-1] + s)

    plan = _row_plan(rows, chunk_rows, pstarts[1:-1])
    blocks: list[Optional[np.ndarray]] = [None] * num_partitions
    sizes: list[int] = []
    total = 0
    with spans.span("fetch", bytes=arr.numel() * arr.element_size(),
                    chunks=len(plan)):
        for idx, (lo, hi) in enumerate(plan):
            with spans.span("fetch.copy") as sp:
                block = tensor_to_numpy(arr[lo:hi])     # one chunk crosses
                sp.set(bytes=block.nbytes, pinned=False)
            p = bisect.bisect_right(pstarts, lo) - 1
            with spans.span("fetch.place", bytes=block.nbytes):
                if blocks[p] is None:
                    blocks[p] = np.empty((psizes[p],) + tuple(arr.shape[1:]),
                                         dtype=block.dtype)
                blocks[p][lo - pstarts[p]: hi - pstarts[p]] = block
            total += block.nbytes
            sizes.append(block.nbytes)
            engine.transfer_log.record(
                block.nbytes, "to_client", session=sess,
                chunk_index=idx, num_chunks=len(plan),
                pipelined=(idx < len(plan) - 1))
    rec = _aggregate_record(
        engine.transfer_log, total, "to_client", sess, sizes)
    return RowMatrix.from_blocks(blocks), rec


def _to_client_bridge(bridge, handle: MatrixHandle, num_partitions: int,
                      session: Optional[int], chunk_rows: Optional[int]
                      ) -> tuple[RowMatrix, TransferRecord]:
    """``to_client`` over a socket: one FETCH request, a stream of chunk
    frames written straight into the per-partition blocks (same
    peak-memory property as the in-process path), and the server's
    aggregate record — including measured wire bytes — from the END
    frame."""
    state: dict = {}

    def on_meta(meta):
        state["meta"] = meta
        # a bfloat16 stream needs ml_dtypes before its chunks decode
        state["dtype"] = numpy_dtype(meta["dtype"])
        if meta["whole"]:
            return
        psizes = meta["psizes"]
        pstarts = [0]
        for s in psizes:
            pstarts.append(pstarts[-1] + s)
        state["psizes"] = psizes
        state["pstarts"] = pstarts
        state["blocks"] = [None] * len(psizes)
        state["tail"] = tuple(meta["shape"][1:])

    def on_chunk(lo, hi, block):
        meta = state["meta"]
        if meta["whole"]:
            state["whole_array"] = block
            return
        pstarts = state["pstarts"]
        blocks = state["blocks"]
        p = bisect.bisect_right(pstarts, lo) - 1
        if blocks[p] is None:
            blocks[p] = np.empty(
                (state["psizes"][p],) + state["tail"],
                dtype=state["dtype"])
        blocks[p][lo - pstarts[p]: hi - pstarts[p]] = block

    # session passes through verbatim: None keeps its in-process meaning
    # (trusted global lookup) so both bridges resolve identically
    rec = bridge.fetch(handle, session=session, chunk_rows=chunk_rows,
                       num_partitions=num_partitions,
                       on_meta=on_meta, on_chunk=on_chunk)
    meta = state["meta"]
    if meta["whole"]:
        return RowMatrix.from_array(state["whole_array"],
                                    meta.get("num_partitions", 8)), rec
    return RowMatrix.from_blocks(state["blocks"]), rec
