"""RowMatrix: the IndexedRowMatrix analogue — a dense matrix stored as
row-block partitions of an RDD on the client side.

``iter_row_blocks`` exposes the matrix as a stream of fixed-size row
blocks regardless of the underlying partitioning — the client-side half of
the paper's §3.2 socket streaming, where each executor walks its partition
and emits buffered sends of a tuned size rather than one message per
partition."""
from __future__ import annotations

from typing import Callable, Iterator, Optional

import numpy as np

from repro_torch.frontend.rdd import RDD


class RowMatrix:
    def __init__(self, rdd: RDD, num_rows: int,
                 num_cols: Optional[int] = None,
                 row_offsets: Optional[list[int]] = None,
                 dtype=None):
        self.rdd = rdd
        self.num_rows = num_rows
        self._num_cols = num_cols
        self._dtype = np.dtype(dtype) if dtype is not None else None
        self.row_offsets = row_offsets

    @property
    def num_cols(self) -> int:
        """Column count; ``None`` at construction means *derive lazily*
        from the first partition on first access (a transformation like
        ``map_rows`` must not eagerly run its function just to learn the
        output width — lineage stays lazy, like Spark's)."""
        if self._num_cols is None:
            self._derive_meta()
        return self._num_cols

    @property
    def dtype(self) -> np.dtype:
        """Element dtype; ``None`` at construction means derive lazily
        from the first partition, exactly like ``num_cols`` (``map_rows``
        may change the dtype, and must not run eagerly to reveal it).
        Tracked so byte-sized consumers — ``nbytes``, the transfer
        layer's chunk sizing and cost models — never assume float64: a
        float32 matrix is half the bytes."""
        if self._dtype is None:
            self._derive_meta()
        return self._dtype

    def _derive_meta(self) -> None:
        """One partition-0 compute fills in both lazily-derived fields —
        an uncached lineage must not run twice just to reveal its width
        and then again for its dtype. The realized partition is memoized
        so the consumer that follows (e.g. a streamed upload) reuses it
        instead of recomputing — the probe costs zero extra computes
        overall, and the metadata always describes the bytes actually
        consumed."""
        part0 = self.rdd.partition(0)
        self.rdd.memoize_partition(0, part0)
        first = np.asarray(part0)
        if self._num_cols is None:
            # same convention as from_array: 1-D partitions are one column
            self._num_cols = first.shape[1] if first.ndim > 1 else 1
        if self._dtype is None:
            self._dtype = first.dtype

    @property
    def shape(self) -> tuple[int, int]:
        return (self.num_rows, self.num_cols)

    @property
    def nbytes(self) -> int:
        return self.num_rows * self.num_cols * self.dtype.itemsize

    # ---- construction ----
    @staticmethod
    def from_array(arr: np.ndarray, num_partitions: int = 8) -> "RowMatrix":
        arr = np.asarray(arr)
        num_partitions = max(1, min(num_partitions, arr.shape[0]))
        blocks = np.array_split(arr, num_partitions, axis=0)

        def compute(i):
            return blocks[i]

        rdd = RDD(num_partitions, compute, (), "from_array").cache()
        ncols = arr.shape[1] if arr.ndim > 1 else 1
        return RowMatrix(rdd, arr.shape[0], ncols, dtype=arr.dtype)

    @staticmethod
    def from_blocks(blocks: list) -> "RowMatrix":
        """Wrap pre-materialized per-partition row blocks *without
        copying* — the landing buffers of a streamed engine→client fetch
        (``transfer.to_client`` fills one block per partition chunk by
        chunk instead of staging the whole matrix in one allocation)."""
        if not blocks:
            raise ValueError("from_blocks needs at least one block")
        offsets = [0]
        for b in blocks:
            offsets.append(offsets[-1] + int(np.asarray(b).shape[0]))

        rdd = RDD(len(blocks), lambda i: blocks[i], (), "from_blocks").cache()
        first = np.asarray(blocks[0])
        ncols = first.shape[1] if first.ndim > 1 else 1
        return RowMatrix(rdd, offsets[-1], ncols, row_offsets=offsets,
                         dtype=first.dtype)

    @staticmethod
    def random(num_rows: int, num_cols: int, num_partitions: int = 8,
               seed: int = 0, scale: float = 1.0) -> "RowMatrix":
        """Lazily-generated random matrix; each partition is reproducible
        from (seed, partition index) — lineage in its purest form.
        Deliberately NOT ``.cache()``d: the matrix never needs to exist
        in client memory all at once (uploads consume it partition by
        partition; the transfer layer's dedup hash runs inline for
        uncached sources, so nothing iterates it twice)."""
        bounds = np.linspace(0, num_rows, num_partitions + 1).astype(int)

        def compute(i):
            rng = np.random.RandomState(seed + 7919 * i)
            return scale * rng.randn(bounds[i + 1] - bounds[i],
                                     num_cols)

        rdd = RDD(num_partitions, compute, (), "random")
        return RowMatrix(rdd, num_rows, num_cols, list(bounds),
                         dtype=np.float64)

    # ---- client-side ops (the "pure Spark" substrate) ----
    def map_rows(self, fn: Callable[[np.ndarray], np.ndarray]) -> "RowMatrix":
        """Apply ``fn`` per partition. Purely lazy: the output width *and
        dtype* are derived from the mapped RDD on first access instead of
        eagerly invoking ``fn`` on partition 0 a second time (which
        doubled partition-0 work and crashed on 1-D outputs)."""
        rdd = self.rdd.map_partitions(fn, "map_rows")
        return RowMatrix(rdd, self.num_rows, None)

    def collect(self) -> np.ndarray:
        return np.concatenate(self.rdd.collect(), axis=0)

    def iter_row_blocks(self, block_rows: int) -> Iterator[np.ndarray]:
        """Yield the matrix as contiguous ``block_rows``-row blocks (last
        block may be short), re-chunking across partition boundaries.
        This is the streaming source for chunked bridge transfers (§3.2):
        partition layout on the client need not match the chunk size the
        socket path was tuned for."""
        block_rows = max(1, int(block_rows))
        full, rem = divmod(self.num_rows, block_rows)
        sizes = [block_rows] * full + ([rem] if rem else [])
        return self.iter_sized_row_blocks(sizes)

    def iter_sized_row_blocks(self, sizes: list[int]
                              ) -> Iterator[np.ndarray]:
        """Yield consecutive row blocks of exactly the given sizes (which
        must sum to at most ``num_rows``), pulling partitions lazily —
        peak client memory is one partition plus one block, never the
        whole matrix. The transfer layer uses this with its chunk plan,
        whose spans also cut at engine shard boundaries."""
        pending: list[np.ndarray] = []
        have = 0
        si = 0
        for i in range(self.rdd.num_partitions):
            if si >= len(sizes):
                return
            part = np.atleast_2d(self.rdd.partition(i))
            pending.append(part)
            have += part.shape[0]
            while si < len(sizes) and have >= sizes[si]:
                buf = np.concatenate(pending, axis=0) if len(pending) > 1 \
                    else pending[0]
                yield buf[: sizes[si]]
                rest = buf[sizes[si]:]
                pending = [rest] if rest.shape[0] else []
                have = rest.shape[0]
                si += 1
        if have and si < len(sizes):
            yield np.concatenate(pending, axis=0) if len(pending) > 1 \
                else pending[0]

    def gram_times(self, w: np.ndarray) -> np.ndarray:
        """(X^T X) w computed partition-by-partition — one BSP round of the
        Spark CG baseline (treeAggregate of per-partition X_i^T (X_i w))."""
        out = np.zeros((self.num_cols, *w.shape[1:]), dtype=w.dtype)
        for i in range(self.rdd.num_partitions):
            xi = self.rdd.partition(i)
            out += xi.T @ (xi @ w)
        return out

    def t_times(self, y_blocks: "RowMatrix") -> np.ndarray:
        """X^T Y, both row-partitioned identically."""
        out = None
        for i in range(self.rdd.num_partitions):
            xi = self.rdd.partition(i)
            yi = y_blocks.rdd.partition(i)
            acc = xi.T @ yi
            out = acc if out is None else out + acc
        return out
