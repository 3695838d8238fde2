"""A minimal RDD: the client-side, high-productivity abstraction the paper
keeps (Spark's resilient distributed dataset). Partitioned, lazy, with
lineage-based fault tolerance: losing a cached partition (executor failure)
is recovered by recomputing it from its lineage — the property the paper
cites as the reason to stay in Spark-land, and which the inelastic MPI/TPU
engine side deliberately does not have.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np


class RDD:
    """Partitioned lazy dataset with lineage."""

    def __init__(self, num_partitions: int,
                 compute: Callable[[int], Any],
                 lineage: tuple = (), name: str = "rdd"):
        self.num_partitions = num_partitions
        self._compute = compute
        self.lineage = lineage          # parent RDDs (for documentation/tests)
        self.name = name
        self._cache: dict[int, Any] = {}
        self._cached = False

    # ---- construction ----
    @staticmethod
    def from_generator(num_partitions: int,
                       gen: Callable[[int], Any], name="source") -> "RDD":
        return RDD(num_partitions, gen, (), name)

    @staticmethod
    def parallelize(items: list, num_partitions: int) -> "RDD":
        chunks = np.array_split(np.arange(len(items)), num_partitions)

        def compute(i):
            return [items[j] for j in chunks[i]]

        return RDD(num_partitions, compute, (), "parallelize")

    # ---- transformations (lazy) ----
    def map_partitions(self, fn: Callable[[Any], Any], name="map") -> "RDD":
        parent = self

        def compute(i):
            return fn(parent.partition(i))

        return RDD(self.num_partitions, compute, (parent,), name)

    def map(self, fn: Callable[[Any], Any]) -> "RDD":
        return self.map_partitions(
            lambda part: [fn(x) for x in part] if isinstance(part, list)
            else fn(part), "map")

    def zip_partitions(self, other: "RDD",
                       fn: Callable[[Any, Any], Any]) -> "RDD":
        assert self.num_partitions == other.num_partitions
        parent, parent2 = self, other

        def compute(i):
            return fn(parent.partition(i), parent2.partition(i))

        return RDD(self.num_partitions, compute, (parent, parent2), "zip")

    # ---- actions / caching ----
    def cache(self) -> "RDD":
        self._cached = True
        return self

    @property
    def cached(self) -> bool:
        """True if partitions are memoized on first compute. Consumers
        that would otherwise iterate the data twice (e.g. the transfer
        layer's dedup hash pass) check this: re-iterating an *uncached*
        RDD recomputes every partition — and need not even reproduce the
        same bytes if the lineage is nondeterministic."""
        return self._cached

    def partition(self, i: int) -> Any:
        if i in self._cache:
            return self._cache[i]
        data = self._compute(i)
        if self._cached:
            self._cache[i] = data
        return data

    def memoize_partition(self, i: int, data: Any) -> None:
        """Pin one already-computed partition, even on an uncached RDD.

        For a consumer that had to realize a partition early (RowMatrix's
        lazy width/dtype probe): the later full iteration reuses that
        exact realization instead of recomputing it — which for a
        nondeterministic lineage would not even be the same bytes. A
        ``lose_partition`` still drops it back to lineage recompute."""
        self._cache[i] = data

    def collect(self) -> list:
        return [self.partition(i) for i in range(self.num_partitions)]

    # ---- fault injection (tests) ----
    def lose_partition(self, i: int) -> None:
        """Simulate an executor loss: drop the cached partition. The next
        access recomputes it from lineage."""
        self._cache.pop(i, None)

    def unpersist(self) -> None:
        self._cache.clear()
        self._cached = False
