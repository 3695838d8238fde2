"""The port's client-side frontend (``repro_torch.frontend``) under the tests
of ``tests/test_frontend.py``, test for test.

Client-side substrate: RDD lineage/fault-tolerance and RowMatrix ops."""
import numpy as np

from repro_torch.frontend.rdd import RDD
from repro_torch.frontend.rowmatrix import RowMatrix


def test_rdd_lineage_recomputes_lost_partition():
    calls = {"n": 0}

    def gen(i):
        calls["n"] += 1
        rng = np.random.RandomState(i)
        return rng.randn(4, 3)

    rdd = RDD.from_generator(4, gen).cache()
    data = rdd.collect()
    assert calls["n"] == 4
    rdd.partition(2)                        # cached: no recompute
    assert calls["n"] == 4
    rdd.lose_partition(2)                   # executor failure
    recovered = rdd.partition(2)
    assert calls["n"] == 5
    np.testing.assert_array_equal(recovered, data[2])  # lineage-identical


def test_rdd_map_is_lazy_and_composes():
    evals = {"n": 0}

    def gen(i):
        evals["n"] += 1
        return np.full((2, 2), float(i))

    doubled = RDD.from_generator(3, gen).map_partitions(lambda x: 2 * x)
    assert evals["n"] == 0                  # nothing computed yet
    out = doubled.collect()
    assert evals["n"] == 3
    np.testing.assert_array_equal(out[2], np.full((2, 2), 4.0))


def test_rowmatrix_roundtrip_and_gram():
    a = np.random.RandomState(0).randn(50, 7)
    m = RowMatrix.from_array(a, 5)
    np.testing.assert_array_equal(m.collect(), a)
    w = np.random.RandomState(1).randn(7, 2)
    np.testing.assert_allclose(m.gram_times(w), a.T @ (a @ w), atol=1e-10)


def test_rowmatrix_random_is_reproducible():
    m1 = RowMatrix.random(40, 5, num_partitions=4, seed=3)
    m2 = RowMatrix.random(40, 5, num_partitions=4, seed=3)
    np.testing.assert_array_equal(m1.collect(), m2.collect())
    m1.rdd.lose_partition(1)
    np.testing.assert_array_equal(m1.collect(), m2.collect())


def test_map_rows_is_lazy_and_derives_width_from_output():
    """map_rows must not eagerly re-invoke fn on partition 0; the output
    width comes from the mapped lineage (1-D outputs count as 1 col)."""
    import numpy as np
    from repro_torch.frontend.rowmatrix import RowMatrix

    x = np.arange(24, dtype=np.float64).reshape(12, 2)
    rm = RowMatrix.from_array(x, num_partitions=3)
    calls = []

    def double_cols(block):
        calls.append(block.shape)
        return np.hstack([block, block])

    mapped = rm.map_rows(double_cols)
    assert calls == []                     # construction ran nothing
    assert mapped.num_cols == 4            # lazily derived on access
    np.testing.assert_array_equal(mapped.collect(), np.hstack([x, x]))
    # fn ran exactly once per partition: the num_cols peek memoizes the
    # partition-0 realization it forced, and collect() reuses it
    assert len(calls) == 3

    # 1-D outputs no longer crash: convention matches from_array
    norms = rm.map_rows(lambda b: np.linalg.norm(b, axis=1))
    assert norms.num_cols == 1
