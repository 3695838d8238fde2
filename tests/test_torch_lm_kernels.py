"""The port's swa and lru_scan wrappers on the CPU, held against the JAX
package's kernels run as its own tests run them (Pallas in interpret
mode) and against its plain ``ref.py`` versions, at the shapes, dtypes and
tolerances of tests/test_kernels.py and tests/test_lru_loss_kernels.py,
plus a sequence that is not a multiple of 64 and MQA (one kv head). On
the CPU each wrapper takes its plain PyTorch version; the CUDA kernels
are held against the same plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lru_scan.ops import lru_scan as jax_lru_scan
from repro.kernels.lru_scan.ref import lru_scan_ref as jax_lru_ref
from repro.kernels.swa.ops import swa_attention as jax_swa
from repro.kernels.swa.ref import swa_ref as jax_swa_ref
from repro_torch import interop
from repro_torch.kernels import launch_counters
from repro_torch.kernels.lru_scan import ops as lru_ops
from repro_torch.kernels.lru_scan.ops import lru_scan
from repro_torch.kernels.swa import ops as swa_ops
from repro_torch.kernels.swa.ops import swa_attention

DTYPES = [jnp.float32, jnp.bfloat16]


def _pair(a: np.ndarray, dtype):
    """The same values as a JAX array of ``dtype`` and as a port tensor."""
    aj = jnp.asarray(a, dtype)
    return aj, interop.from_reference({"a": np.asarray(aj)}, "cpu")["a"]


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return interop.tensor_to_host(x)
    return np.asarray(x, np.float32)


def _qkv(seed, b, h, kh, s, d, dtype):
    rng = np.random.default_rng(seed)
    return [_pair(rng.standard_normal(shape).astype(np.float32), dtype)
            for shape in ((b, h, s, d), (b, kh, s, d), (b, kh, s, d))]


@pytest.mark.parametrize("s,window,bq,bk,kh", [
    (128, 32, 64, 64, 2), (256, 96, 64, 64, 2), (256, 256, 128, 128, 2),
    (512, 128, 128, 64, 2),
    (200, 48, 40, 40, 2),      # S not a multiple of 64
    (192, 64, 64, 64, 1),      # MQA: one kv head for all four
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_swa_matches_jax_kernel_and_ref(s, window, bq, bk, kh, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(s + window + kh, 2, 4, kh, s, 32,
                                        dtype)
    got = swa_attention(qt, kt, vt, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    tol = 2e-5 if dtype == jnp.float32 else 3e-2
    pallas = jax_swa(qj, kj, vj, window=window, use_pallas=True, bq=bq,
                     bk=bk)
    rep = 4 // kh
    ref = jax_swa_ref(qj, jnp.repeat(kj, rep, axis=1),
                      jnp.repeat(vj, rep, axis=1), window)
    for want in (pallas, ref):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol,
                                   atol=tol)


def test_swa_equals_causal_attention_when_window_covers_seq():
    """window >= S must reduce to plain causal attention, as the JAX
    kernel's test has it."""
    q = np.array(jax.random.normal(jax.random.PRNGKey(7), (1, 2, 128, 32),
                                   jnp.float32))
    qt = torch.from_numpy(q)
    for window in (128, 1000):
        got = swa_attention(qt, qt, qt, window=window).numpy()
        scores = np.einsum("bhqd,bhkd->bhqk", q, q) * 32 ** -0.5
        scores = np.where(np.tril(np.ones((128, 128), bool)), scores, -2e38)
        p = np.exp(scores - scores.max(-1, keepdims=True))
        want = np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), q)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        pallas = jax_swa(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q),
                         window=128, use_pallas=True, bq=64, bk=64)
        np.testing.assert_allclose(got, np.asarray(pallas), rtol=2e-5,
                                   atol=2e-5)


def test_swa_takes_strided_views_of_the_model_layout():
    """The model holds (B, S, H, D) and passes transposed views: same
    result as contiguous (B, H, S, D) operands."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 70, 4, 32),
                                             dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 70, 1, 32),
                                             dtype=np.float32))
    got = swa_attention(q.transpose(1, 2), k.transpose(1, 2),
                        k.transpose(1, 2), window=9)
    want = swa_attention(q.transpose(1, 2).contiguous(),
                         k.transpose(1, 2).contiguous(),
                         k.transpose(1, 2).contiguous(), window=9)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("b,s,w,bt,bw", [
    (2, 64, 128, 32, 64), (1, 100, 96, 128, 512), (3, 128, 512, 64, 256),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_lru_scan_matches_jax_kernel_and_ref(b, s, w, bt, bw, dtype):
    rng = np.random.default_rng(b + s + w)
    # decays in (0, 1) like RG-LRU's a_t
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, w))))
    aj, at = _pair(a.astype(np.float32), dtype)
    bj, bt_ = _pair((0.1 * rng.standard_normal((b, s, w))).astype(
        np.float32), dtype)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    got = lru_scan(at, bt_, torch.from_numpy(h0))
    assert got.dtype == torch.float32 and got.shape == (b, s, w)
    tol = 1e-5 if dtype == jnp.float32 else 3e-2
    pallas = jax_lru_scan(aj, bj, jnp.asarray(h0), use_pallas=True, bt=bt,
                          bw=bw)
    for want in (pallas, jax.jit(jax_lru_ref)(aj, bj, jnp.asarray(h0))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)


def test_lru_scan_carries_initial_state():
    got = lru_scan(torch.full((1, 4, 8), 0.5), torch.zeros((1, 4, 8)),
                   torch.full((1, 8), 16.0))
    np.testing.assert_allclose(got[0, :, 0].numpy(), [8.0, 4.0, 2.0, 1.0],
                               rtol=1e-6)
    want = jax_lru_scan(jnp.ones((1, 4, 8)) * 0.5, jnp.zeros((1, 4, 8)),
                        jnp.ones((1, 8)) * 16.0, use_pallas=True, bt=2,
                        bw=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_cpu_calls_take_the_plain_versions_and_launch_nothing(monkeypatch):
    counters = launch_counters()
    for c in counters.values():
        c.reset()
    calls = []
    swa_plain, lru_plain = swa_ops.swa_ref, lru_ops.lru_scan_ref
    monkeypatch.setattr(swa_ops, "swa_ref",
                        lambda *a: calls.append("swa") or swa_plain(*a))
    monkeypatch.setattr(lru_ops, "lru_scan_ref",
                        lambda *a: calls.append("lru_scan") or lru_plain(*a))
    x = torch.randn(1, 2, 16, 32)
    swa_attention(x, x, x, window=4)
    lru_scan(torch.rand(1, 5, 8), torch.rand(1, 5, 8), torch.zeros(1, 8))
    assert calls == ["swa", "lru_scan"]
    assert all(c.value == 0 for c in counters.values())


@pytest.mark.parametrize("bad,err", [
    (lambda: swa_attention(torch.randn(1, 3, 8, 32), torch.randn(1, 2, 8, 32),
                           torch.randn(1, 2, 8, 32), window=4), ValueError),
    (lambda: swa_attention(torch.randn(1, 2, 8, 32), torch.randn(1, 2, 9, 32),
                           torch.randn(1, 2, 9, 32), window=4), ValueError),
    (lambda: swa_attention(torch.randn(1, 2, 8, 32), torch.randn(1, 2, 8, 32),
                           torch.randn(1, 2, 8, 32), window=0), ValueError),
    # a prefix is an int in [0, S]
    (lambda: swa_attention(torch.randn(1, 2, 8, 32), torch.randn(1, 2, 8, 32),
                           torch.randn(1, 2, 8, 32), window=8, prefix=-1),
     ValueError),
    (lambda: swa_attention(torch.randn(1, 2, 8, 32), torch.randn(1, 2, 8, 32),
                           torch.randn(1, 2, 8, 32), window=8, prefix=9),
     ValueError),
    (lambda: swa_attention(torch.randn(1, 2, 8, 32), torch.randn(1, 2, 8, 32),
                           torch.randn(1, 2, 8, 32), window=8, prefix=True),
     ValueError),
    (lambda: swa_attention(torch.randn(1, 2, 8, 32), torch.randn(1, 2, 8, 32),
                           torch.randn(1, 2, 8, 32), window=8, prefix=2.0),
     ValueError),
    (lambda: swa_attention(torch.randn(1, 2, 8, 32),
                           torch.randn(1, 2, 8, 32, dtype=torch.bfloat16),
                           torch.randn(1, 2, 8, 32), window=4), TypeError),
    (lambda: swa_attention(torch.randn(2, 8, 32), torch.randn(2, 8, 32),
                           torch.randn(2, 8, 32), window=4), ValueError),
    (lambda: lru_scan(torch.rand(1, 4, 8), torch.rand(1, 4, 7),
                      torch.zeros(1, 8)), ValueError),
    (lambda: lru_scan(torch.rand(1, 4, 8), torch.rand(1, 4, 8),
                      torch.zeros(2, 8)), ValueError),
    (lambda: lru_scan(torch.rand(1, 4, 8), torch.rand(1, 4, 8),
                      torch.zeros(1, 8, dtype=torch.bfloat16)), TypeError),
    (lambda: lru_scan(torch.rand(1, 8, 4).transpose(1, 2),
                      torch.rand(1, 4, 8), torch.zeros(1, 8)), ValueError),
    # meta operands take the dry run's shape rule; a mix of meta and CPU
    # operands is refused
    (lambda: lru_scan(torch.empty(1, 4, 8, device="meta"),
                      torch.rand(1, 4, 8),
                      torch.empty(1, 8, device="meta")), ValueError),
])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad, err):
    with pytest.raises(err):
        bad()
