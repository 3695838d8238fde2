"""Content-addressed result & transfer cache — the amortization layer.

The paper's core economics are about *amortization*: matrices stay
engine-resident so chained routines never re-cross the Spark↔MPI bridge
(§3.2, §3.3.2), and the Cray deployment report (Rothauge et al., 2019)
shows transfer time dominating whenever data re-crosses. This module takes
the next step the paper's design points at but never builds: **never
recompute or re-upload what the engine has already seen.**

Two content-addressed mechanisms share the fingerprint vocabulary defined
here:

* **Routine memoization** (:class:`RoutineCache`, woven into
  ``engine.submit``/``engine._run_task``). A routine invocation is keyed by
  ``(library, routine, canonicalized params, input-handle fingerprints)``
  — :func:`routine_key`. A submitted command whose key hits returns its
  cached output handles instantly (the engine's DONE-on-submit fast path),
  skipping the scheduler entirely; a queued task re-checks at dispatch
  time, after its hazard edges drained, so a hit is always consistent with
  every write ordered before it.
* **Transfer dedup** (``transfer.to_engine``). The matrix's bytes are
  digested in row-major order (:class:`ContentHasher` — chunk-boundary
  invariant, so the same bytes dedup whatever ``chunk_rows`` carried
  them) and the fingerprint is looked up in the engine's store index
  before any byte crosses. A re-upload of an already-resident matrix —
  the repeated-tenant case — short-circuits to a handle *alias* with a
  zero-byte modeled crossing.

Fingerprints are strings with a namespace prefix so the three origins can
never collide:

* ``v:<n>`` — an opaque *version* minted for arrays whose content was
  never hashed (direct ``engine.put``). Changes on every ``overwrite``,
  which is what makes fingerprint-derived cache keys self-invalidating.
* ``c:<digest>`` — a *content* hash of a streamed upload (row-major
  bytes seeded with shape/dtype), so two uploads of equal bytes collide
  on purpose.
* ``r:<digest>`` — a *derived* fingerprint for a routine output: a hash of
  the producing cache key plus the output's name. Two engines computing
  ``gram`` of content-identical inputs mint equal output fingerprints, so
  memoization composes transitively (``svd(gram(X))`` hits even when the
  intermediate was recomputed by another tenant).

The cache itself stores no arrays — only Result ``values`` (handles +
scalars). The engine *retains* (refcounts) every cached output handle so a
client ``free`` or an LRU spill can never invalidate a live entry; entries
die only on ``overwrite`` of an input/output, on forced reclaim of an
output binding (``free_session``, trusted double-free), or by this cache's
own LRU eviction (``max_entries``), at which point the engine releases the
retained references.

Thread-safety: :class:`RoutineCache` has no lock of its own — every call
site is the engine, under ``AlchemistEngine._state_lock``.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Any, Callable, Iterable, Optional

import msgpack
import numpy as np

from repro_torch.core import protocol
from repro_torch.core.handles import MatrixHandle

_DIGEST_SIZE = 16          # blake2b-128: fast, and 2^64 collision margin


class Uncacheable(Exception):
    """Raised while canonicalizing a command that must not be memoized
    (deferred args, unresolvable handles, unserializable params)."""


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------
class ContentHasher:
    """Incremental, chunk-boundary-invariant content fingerprint.

    Seeded with (shape, dtype) — a (4,2) and an (8,1) matrix with equal
    bytes, or an f32/f64 pair, never alias — then fed the matrix's bytes
    in row-major order, in whatever chunking the transfer plan happens to
    use: the same bytes uploaded with a different ``chunk_rows`` (or a
    different shard layout) produce the *same* fingerprint, so they dedup
    against each other.

    blake2b, not sha256: the hash runs client-side on every upload (the
    real system would pay it before paying the network), so it must be
    cheap relative to the socket it can save. ``update`` hashes the array
    in place through the buffer protocol — no byte copies for contiguous
    input (a strided piece is copied contiguous first, so feed bounded
    pieces, not a whole strided matrix).
    """

    def __init__(self, shape, dtype):
        self._h = hashlib.blake2b(digest_size=_DIGEST_SIZE)
        self._h.update(repr((tuple(int(s) for s in shape),
                             str(dtype))).encode())

    def update(self, chunk: np.ndarray) -> None:
        self._h.update(np.ascontiguousarray(chunk))

    def fingerprint(self) -> str:
        return "c:" + self._h.hexdigest()


def derived_fingerprint(key: str, output_path: str) -> str:
    """Fingerprint of a memoized routine's output: deterministic in the
    (content-addressed) cache key and the output's name, so identical
    computations — whoever ran them — mint identical fingerprints."""
    h = hashlib.blake2b(digest_size=_DIGEST_SIZE)
    h.update(key.encode())
    h.update(output_path.encode())
    return "r:" + h.hexdigest()


# ---------------------------------------------------------------------------
# cache keys
# ---------------------------------------------------------------------------
def _canonical(v: Any, fp_of: Callable[[MatrixHandle], str]) -> Any:
    """Recursively rewrite an args tree into a deterministic, serializable
    structure: handles become their content fingerprints, dicts become
    sorted pair lists. Raises :class:`Uncacheable` on deferred handles
    (the output does not exist yet) and on anything msgpack cannot carry."""
    if isinstance(v, MatrixHandle):
        return ["__fp__", fp_of(v)]
    if isinstance(v, protocol.DeferredHandle):
        raise Uncacheable("deferred args have no fingerprint yet")
    if isinstance(v, dict):
        return ["__map__", [[str(k), _canonical(v[k], fp_of)]
                            for k in sorted(v, key=str)]]
    if isinstance(v, (list, tuple)):
        return [_canonical(x, fp_of) for x in v]
    if isinstance(v, (bool, int, float, str, bytes)) or v is None:
        return v
    raise Uncacheable(f"cannot canonicalize {type(v).__name__}")


def routine_key(library: str, routine: str, args: dict,
                fp_of: Callable[[MatrixHandle], str],
                scope: str = "") -> Optional[str]:
    """Content-addressed cache key for one routine invocation, or ``None``
    when the invocation is uncacheable. ``fp_of`` maps a handle to its
    current content fingerprint (raising :class:`Uncacheable`/``KeyError``
    for unresolvable handles).

    ``scope`` partitions the key space — the engine passes the issuing
    session's *execution backend* name, so a result computed by the jax
    backend is never served to a session that asked for the reference
    backend (whose whole point is recomputing with the other
    implementation). Same scope, same content ⇒ same key, which also
    makes derived output fingerprints identical for a chain whether it
    executed fused or op-by-op."""
    try:
        canon = _canonical(args, fp_of)
    except (Uncacheable, KeyError):
        return None
    payload = msgpack.packb([library, routine, canon, scope],
                            use_bin_type=True)
    return hashlib.blake2b(payload, digest_size=_DIGEST_SIZE).hexdigest()


# ---------------------------------------------------------------------------
# the routine-memoization table
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CacheEntry:
    """One memoized routine result.

    ``values`` is the routine's Result dict (handles + scalars);
    ``outputs`` the handles inside it (each carrying one engine refcount
    taken by the cache); ``inputs`` the handle IDs the key was derived
    from (overwrite-invalidation index); ``exec_s`` the original execute
    time — what a hit reports as saved seconds."""
    key: str
    values: dict
    outputs: list[MatrixHandle]
    inputs: tuple[int, ...]
    exec_s: float
    label: str = ""
    session: int = 0               # producing session (stats only)
    hits: int = 0


class RoutineCache:
    """LRU table of memoized routine results, keyed by content.

    The cache owns no engine state: the engine takes/releases the output
    refcounts and calls the ``invalidate_*`` hooks from its own lifecycle
    transitions (all under the engine state lock — see module docstring).
    """

    def __init__(self, max_entries: int = 256):
        self.max_entries = max(1, int(max_entries))
        self._entries: "collections.OrderedDict[str, CacheEntry]" = \
            collections.OrderedDict()
        self._by_output: dict[int, set[str]] = {}
        self._by_input: dict[int, set[str]] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def get(self, key: str) -> Optional[CacheEntry]:
        """Non-touching lookup: no LRU or hit-count effect. For guard
        phases that may still refuse the hit (the engine's fast path
        checks pending writers/barriers after looking up)."""
        return self._entries.get(key)

    def peek(self, key: str) -> Optional[CacheEntry]:
        """Return the entry for ``key`` (touching its LRU position and hit
        count — call only when the hit is actually served) or None."""
        entry = self._entries.get(key)
        if entry is None:
            return None
        self._entries.move_to_end(key)
        entry.hits += 1
        return entry

    def store(self, key: str, values: dict, outputs: list[MatrixHandle],
              inputs: Iterable[int], exec_s: float, label: str = "",
              session: int = 0) -> list[CacheEntry]:
        """Insert a freshly computed result; returns the entries LRU-evicted
        to stay under ``max_entries`` (the caller releases their retained
        output refcounts). A key raced in by a concurrent identical task
        is kept — the second result is simply not cached."""
        if key in self._entries:
            return []
        entry = CacheEntry(key=key, values=values, outputs=list(outputs),
                           inputs=tuple(inputs), exec_s=exec_s,
                           label=label, session=session)
        self._entries[key] = entry
        for h in entry.outputs:
            self._by_output.setdefault(h.id, set()).add(key)
        for hid in entry.inputs:
            self._by_input.setdefault(hid, set()).add(key)
        evicted = []
        while len(self._entries) > self.max_entries:
            _, old = self._entries.popitem(last=False)
            self._unindex(old)
            evicted.append(old)
        return evicted

    def invalidate_output(self, handle_id: int) -> list[CacheEntry]:
        """Drop every entry whose *outputs* include ``handle_id`` — called
        when that binding is reclaimed (the cached values would dangle).
        Returns the dropped entries for refcount release."""
        return self._drop(self._by_output.get(handle_id, ()))

    def invalidate_handle(self, handle_id: int) -> list[CacheEntry]:
        """Drop every entry touching ``handle_id`` as input *or* output —
        the ``overwrite`` hook. Output entries are a correctness matter
        (their cached handles now name different content); input entries
        are hygiene (their key can only match if the old content
        reappears, but they pin retained outputs for no likely benefit)."""
        keys = set(self._by_output.get(handle_id, ())) | \
            set(self._by_input.get(handle_id, ()))
        return self._drop(keys)

    def invalidate_library(self, library: str) -> list[CacheEntry]:
        """Drop every entry produced by ``library``'s routines — the
        ``load_library`` hook. Keys hash the library *name*, not its
        code, so re-registering a library under the same name would
        otherwise keep serving the old implementation's results."""
        prefix = library + "."
        return self._drop([k for k, e in self._entries.items()
                           if e.label.startswith(prefix)])

    def clear(self) -> list[CacheEntry]:
        """Drop everything (engine shutdown)."""
        dropped = list(self._entries.values())
        self._entries.clear()
        self._by_output.clear()
        self._by_input.clear()
        return dropped

    def stats(self) -> dict:
        return {
            "entries": len(self._entries),
            "max_entries": self.max_entries,
            "hits": sum(e.hits for e in self._entries.values()),
        }

    def _drop(self, keys: Iterable[str]) -> list[CacheEntry]:
        dropped = []
        for key in list(keys):
            entry = self._entries.pop(key, None)
            if entry is not None:
                self._unindex(entry)
                dropped.append(entry)
        return dropped

    def _unindex(self, entry: CacheEntry) -> None:
        for h in entry.outputs:
            keys = self._by_output.get(h.id)
            if keys is not None:
                keys.discard(entry.key)
                if not keys:
                    del self._by_output[h.id]
        for hid in entry.inputs:
            keys = self._by_input.get(hid)
            if keys is not None:
                keys.discard(entry.key)
                if not keys:
                    del self._by_input[hid]
