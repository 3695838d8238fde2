"""Matrix handles — the JAX analogue of the paper's ``AlMatrix`` proxies.

A handle names an engine-resident distributed matrix by ID. Handles are what
library routines consume and produce, so chained calls (e.g. random-feature
expansion followed by CG) compose entirely engine-side: data is only shipped
back to the client when it explicitly materializes the handle
(``AlMatrix.to_row_matrix()`` / ``AlchemistContext.fetch``), mirroring
``toIndexedRowMatrix()`` in the paper (§3.3.2).

The handle itself is an immutable value object: IDs are minted globally so
a handle is unambiguous engine-wide, while *visibility* is a session
property — the engine's session table says which namespace owns each ID,
and protocol-level resolution is confined to the issuing session (see
``engine.Session``). Lifecycle state (refcount, LRU position, spilled-to-
host status, content fingerprint) lives engine-side in the binding/store
the ID names, never in the handle, so handles can be freely copied across
the wire. Two distinct handles may *alias* one underlying store: the
content-addressed cache (``core/cache.py``) mints an alias instead of
re-crossing or recomputing when a session uploads or requests content the
engine already holds.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

_COUNTER = itertools.count(1)

# Engine-side distributed layouts (re-exported by core/backends/base.py —
# the Elemental DistMatrix vocabulary projected onto the worker mesh).
# ``MatrixHandle.layout`` is a *real* tag as of the backend ABI: the
# engine derives it from the actual device sharding at put time, backends
# declare which layouts their implementations accept, and the engine
# inserts explicit relayout steps when a consumer needs a different one
# (counted in ``costmodel.TaskLog``). The handle's copy is a snapshot;
# the authoritative layout lives in the engine's store (it can change on
# ``overwrite``) — read it with ``engine.layout(handle)``.
ROWBLOCK = "rowblock"
BLOCK2D = "block2d"
REPLICATED = "replicated"
LAYOUTS = (ROWBLOCK, BLOCK2D, REPLICATED)


@dataclasses.dataclass(frozen=True)
class MatrixHandle:
    id: int
    shape: tuple[int, ...]
    dtype: str
    layout: str = BLOCK2D          # engine-side layout tag
    name: Optional[str] = None

    @staticmethod
    def fresh(shape, dtype, layout=BLOCK2D, name=None) -> "MatrixHandle":
        return MatrixHandle(id=next(_COUNTER), shape=tuple(int(s) for s in shape),
                            dtype=str(dtype), layout=layout, name=name)

    @property
    def num_elements(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def itemsize(self) -> int:
        """Bytes per element of this handle's dtype (never assume 8 —
        float32 matrices are half that, see the transfer layer)."""
        import numpy as np

        return np.dtype(self.dtype).itemsize

    @property
    def nbytes(self) -> int:
        return self.num_elements * self.itemsize
