"""The port's kernel wrappers on the CPU, held against the JAX package's
kernels run as its own tests run them (Pallas in interpret mode), at the
shapes, dtypes and tolerances of tests/test_kernels.py and
tests/test_extensions.py. On the CPU every wrapper takes its plain
PyTorch version and launches nothing; the CUDA kernels themselves are
held against the same plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backends.reference import _np_rf_map
from repro.kernels.gram.ops import gram as jax_gram
from repro.kernels.normal_matvec.ops import normal_matvec as jax_nm
from repro.kernels.rf_map.ops import rf_map_apply as jax_rf_apply
from repro.kernels.rf_map.ref import rf_weights as jax_rf_weights
from repro_torch import interop
from repro_torch.kernels import device, launch_counters
from repro_torch.kernels.gram.gram import gram_slabs
from repro_torch.kernels.gram.ops import gram
from repro_torch.kernels.normal_matvec.normal_matvec import \
    normal_matvec_slabs
from repro_torch.kernels.normal_matvec.ops import normal_matvec
from repro_torch.kernels.rf_map.ops import rf_map, rf_map_apply
from repro_torch.kernels.rf_map.ref import rf_weights

DTYPES = [jnp.float32, jnp.bfloat16]


def _inputs(seed, shape, dtype):
    """The same seeded values as a JAX array and as a port tensor."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    aj = jnp.asarray(a, dtype)
    return aj, interop.from_reference({"a": np.asarray(aj)}, "cpu")["a"]


def _tol(dtype, f32, bf16):
    return f32 if dtype == jnp.float32 else bf16


@pytest.mark.parametrize("n,d", [(256, 128), (512, 256), (384, 200),
                                 (1000, 64), (128, 384)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gram_matches_jax_kernel(n, d, dtype):
    aj, at = _inputs(n + d, (n, d), dtype)
    want = np.asarray(jax_gram(aj, use_pallas=True, bm=256, bn=128))
    got = gram(at).numpy()
    tol = _tol(dtype, 2e-5, 2e-2)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("n,d,dd", [(256, 128, 256), (300, 70, 200),
                                    (512, 440, 1024), (100, 33, 77)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rf_map_matches_jax_kernel(n, d, dd, dtype):
    xj, xt = _inputs(0, (n, d), dtype)
    wj, bj = jax_rf_weights(d, dd, bandwidth=2.0, seed=1)
    wb = interop.from_reference({"w": np.asarray(wj), "b": np.asarray(bj)},
                                "cpu")
    want = np.asarray(jax_rf_apply(xj, wj, bj, use_pallas=True))
    got = rf_map_apply(xt, wb["w"], wb["b"]).numpy()
    tol = _tol(dtype, 1e-5, 2e-2)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("n,d,c", [(256, 64, 4), (300, 128, 1),
                                   (512, 440, 16), (1000, 37, 3)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_normal_matvec_matches_jax_kernel(n, d, c, dtype):
    xj, xt = _inputs(n + d + c, (n, d), dtype)
    wj, wt = _inputs(1, (d, c), jnp.float32)
    want = np.asarray(jax_nm(xj, wj, use_pallas=True, bm=128))
    got = normal_matvec(xt, wt).numpy()
    tol = _tol(dtype, 3e-5, 3e-2)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def test_normal_matvec_130_rows_matches_padded_jax_kernel():
    """The JAX wrapper pads 130 rows to 256 with zero rows; the port takes
    any row count and must agree."""
    xj, xt = _inputs(0, (130, 32), jnp.float32)
    wj, wt = _inputs(1, (32, 2), jnp.float32)
    want = np.asarray(jax_nm(xj, wj, use_pallas=True, bm=128))
    np.testing.assert_allclose(normal_matvec(xt, wt).numpy(), want,
                               rtol=2e-5, atol=2e-4)


def test_rf_weights_are_the_reference_backend_draws():
    """rf_map draws (W, b) with numpy default_rng exactly as the JAX
    package's reference backend does, so the expansions agree."""
    x = np.random.default_rng(3).standard_normal((64, 20)).astype(np.float32)
    want = _np_rf_map(x, 48, 1.5, 7)
    got = rf_map(torch.from_numpy(x), 48, bandwidth=1.5, seed=7).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    w, b = rf_weights(20, 48, 1.5, 7)
    assert w.dtype == np.float32 and b.dtype == np.float32
    assert w.shape == (20, 48) and b.shape == (48,)


def test_cpu_wrappers_launch_nothing():
    counters = launch_counters()
    for c in counters.values():
        c.reset()
    x = torch.randn(40, 8)
    gram(x)
    normal_matvec(x, torch.randn(8, 2))
    rf_map(x, 16)
    assert {k: c.value for k, c in counters.items()} == \
        {"gram": 0, "normal_matvec": 0, "rf_map": 0}


@pytest.mark.parametrize("bad,err", [
    (lambda: gram(torch.randn(8, 4).T), ValueError),          # strided
    (lambda: gram(torch.randn(8, 4, dtype=torch.float64)), TypeError),
    (lambda: gram(torch.randn(8)), ValueError),
    (lambda: normal_matvec(torch.randn(8, 4),
                           torch.randn(4, 2, dtype=torch.bfloat16)),
     TypeError),
    (lambda: normal_matvec(torch.randn(8, 4), torch.randn(5, 2)),
     ValueError),
    (lambda: rf_map_apply(torch.randn(8, 4), torch.randn(4, 6),
                          torch.randn(5)), ValueError),
    (lambda: gram(torch.empty(8, 4, device="meta")), ValueError),
])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad, err):
    with pytest.raises(err):
        bad()


def test_split_reductions_only_when_tiles_cannot_fill_the_card():
    # d = 8,096: 2,080 upper tiles of 128 fill 132 SMs twice over
    assert gram_slabs(device.MAX_SLAB_ROWS, 8096, 132) == 1
    # d = 440: 10 upper tiles -> split rows into fixed slabs
    assert gram_slabs(1 << 20, 440, 132) == 53
    # normal_matvec's X^T t at d = 10,000, c = 147: 158 tiles
    assert normal_matvec_slabs(1 << 18, 10_000, 147, 132) == 4
    # a short matrix keeps at least MIN_SLAB_ROWS rows per slab
    assert gram_slabs(1000, 440, 132) == 1000 // device.MIN_SLAB_ROWS
    assert gram_slabs(100, 440, 132) == 1


def test_no_slab_runs_longer_than_the_accuracy_cap():
    # 1,048,576 rows: 16 slabs of 65,536 whatever the tiles
    assert gram_slabs(1 << 20, 8096, 132) == 16
    assert normal_matvec_slabs(1 << 20, 10_000, 147, 132) == 16
    assert gram_slabs((1 << 20) + 1, 8096, 132) == 17
    assert gram_slabs(1 << 20, 440, 132) == 53


def test_interop_follows_jax_dtype_rules():
    got = interop.from_reference({"f64": np.ones((3, 2)),
                                  "i64": np.arange(4),
                                  "bf16": np.asarray(jnp.arange(
                                      5, dtype=jnp.bfloat16))}, "cpu")
    assert got["f64"].dtype == torch.float32
    assert got["i64"].dtype == torch.int32
    assert got["bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["bf16"].float().numpy(),
                                  np.arange(5, dtype=np.float32))
    assert interop.dtype_name(torch.bfloat16) == "bfloat16"
    back = interop.tensor_to_host(got["bf16"])
    assert back.dtype == np.float32

