"""The association of the CUDA linear recurrence (``csrc/lru_scan.cu``:
time cut into chunks, a chunk into one run per warp, a chained carry) on
the CPU, through its exact emulation ``lru_scan_chunked_ref``: held
against the JAX package's ``lru_scan_ref`` (its associative scan), its
Pallas kernel in interpret mode and ``jax.vjp`` of its ref, and against
the port's sequential plain versions, at the chunk edges (S = 1, S short
of a chunk, S off and on a chunk's end, W = 33, a = 0 on a chunk's
first step, a nonzero h0), fp32 and bf16. The card holds the kernel's
bits to the emulation's (tests/test_torch_cuda.py, chip_smoke.py)."""
import re
from fractions import Fraction
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lru_scan.ops import lru_scan as jax_lru_scan
from repro.kernels.lru_scan.ref import lru_scan_ref as jax_lru_ref
from repro_torch import interop
from repro_torch.kernels import device
from repro_torch.kernels.lru_scan import ops as lru_ops
from repro_torch.kernels.lru_scan.lru_scan import CHUNK, WARPS, \
    workspace_words
from repro_torch.kernels.lru_scan.ops import lru_scan, lru_scan_reverse
from repro_torch.kernels.lru_scan.ref import _fma32, lru_scan_chunked_ref, \
    lru_scan_ref, lru_scan_reverse_ref

# (B, S, W, chunk, warps, zero_a): the kernel's configuration at its
# edges, then small chunks so a short S crosses many of them
CASES = [
    (2, 1, 64, CHUNK, WARPS, False),          # one step
    (2, 100, 64, CHUNK, WARPS, False),        # S short of one chunk
    (2, 600, 40, CHUNK, WARPS, False),        # S off a chunk's end
    (1, 512, 32, CHUNK, WARPS, False),        # the last chunk ends at S
    (2, 300, 64, 128, 8, False),
    (1, 1100, 32, 512, 16, False),
    (3, 77, 33, 16, 4, False),                # W = 33: a short lane group
    (2, 64, 48, 16, 2, True),                 # a = 0 on each chunk's start
]
DTYPES = [(torch.float32, jnp.float32, 1e-5),
          (torch.bfloat16, jnp.bfloat16, 3e-2)]


def _inputs(b, s, w, zero_a, dtype):
    """a in (0, 1) like RG-LRU's decays, b small, h0 nonzero; the values
    of the port's tensors (bf16-rounded for bf16) as fp32 JAX arrays."""
    rng = np.random.default_rng(b * 1000 + s + w)
    a = 1 / (1 + np.exp(-rng.standard_normal((b, s, w))))
    if zero_a:
        a[:, 16::16] = 0.0
    x = 0.1 * rng.standard_normal((b, s, w))
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    ta, tx = (torch.from_numpy(v.astype(np.float32)).to(dtype)
              for v in (a, x))
    return ta, tx, torch.from_numpy(h0)


def _jax(t):
    return jnp.asarray(interop.tensor_to_host(t))


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@jax.jit
def _jax_vjp(a, x, h0, g):
    want, vjp = jax.vjp(jax_lru_ref, a, x, h0)
    return want, vjp(g)


@pytest.mark.parametrize("b,s,w,chunk,warps,zero_a", CASES)
@pytest.mark.parametrize("dtype,jdtype,tol", DTYPES)
def test_chunked_forward_matches_jax_ref_and_pallas(b, s, w, chunk, warps,
                                                     zero_a, dtype, jdtype,
                                                     tol):
    a, x, h0 = _inputs(b, s, w, zero_a, dtype)
    got = lru_scan_chunked_ref(a, x, h0, chunk, warps)
    assert got.dtype == torch.float32 and got.shape == (b, s, w)
    aj, xj = (_jax(t).astype(jdtype) for t in (a, x))
    for want in (jax.jit(jax_lru_ref)(aj, xj, _jax(h0)),
                 jax_lru_scan(aj, xj, _jax(h0), use_pallas=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)
    if zero_a:   # a = 0 cuts the carry: the state is that step's b exactly
        torch.testing.assert_close(got[:, 16::16], x[:, 16::16].float(),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("b,s,w,chunk,warps,zero_a", CASES)
@pytest.mark.parametrize("dtype,jdtype,tol", DTYPES)
def test_chunked_reverse_and_da_match_jax_vjp(b, s, w, chunk, warps, zero_a,
                                              dtype, jdtype, tol):
    """The reverse launch as the backward runs it: a, the states' gradient
    g, a zero carry, and the forward's states (in the kernel's
    association) for da; db = lambda, dh0 = a_0 lambda_0."""
    a, x, h0 = _inputs(b, s, w, zero_a, dtype)
    g = torch.from_numpy(np.random.default_rng(s).standard_normal(
        (b, s, w)).astype(np.float32))
    hs = lru_scan_chunked_ref(a, x, h0, chunk, warps)
    lam, da = lru_scan_chunked_ref(a.float(), g, torch.zeros_like(h0),
                                   chunk, warps, reverse=True, h=hs,
                                   h_init=h0)
    _, (want_da, want_db, want_dh0) = _jax_vjp(
        _jax(a), _jax(x), _jax(h0), jnp.asarray(g.numpy()))
    assert _rel(lam, want_db) <= tol
    assert _rel(da, want_da) <= tol
    assert _rel(a[:, 0].float() * lam[:, 0], want_dh0) <= tol


@pytest.mark.parametrize("b,s,w,chunk,warps,zero_a", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_matches_the_sequential_plain_versions(b, s, w, chunk,
                                                       warps, zero_a, dtype):
    """Both directions (the reverse with a carry and with da) within 1e-5
    of the plain loops: the same fp32 arithmetic on the same values in
    another order."""
    a, x, h0 = _inputs(b, s, w, zero_a, dtype)
    hs = lru_scan_ref(a, x, h0)
    torch.testing.assert_close(lru_scan_chunked_ref(a, x, h0, chunk, warps),
                               hs, rtol=1e-5, atol=1e-5)
    got = lru_scan_chunked_ref(a, x, h0, chunk, warps, reverse=True, h=hs,
                               h_init=h0)
    for g, want in zip(got, lru_scan_reverse_ref(a, x, h0, hs, h0)):
        torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        lru_scan_chunked_ref(a, x, h0, chunk, warps, reverse=True), got[0],
        rtol=0, atol=0)


def test_chunked_ref_rejects_a_chunk_the_warps_do_not_divide():
    a = torch.ones(1, 4, 2)
    with pytest.raises(ValueError, match="not a multiple"):
        lru_scan_chunked_ref(a, a, torch.zeros(1, 2), 12, 8)


def _fp32_round(q: Fraction) -> float:
    """The fp32 nearest to the rational q, ties to even, exactly."""
    c = np.float32(float(q))
    cands = [np.nextafter(c, np.float32(-np.inf)), c,
             np.nextafter(c, np.float32(np.inf))]
    best = min(cands, key=lambda v: (abs(Fraction(float(v)) - q),
                                     int(np.float32(v).view(np.int32)) & 1))
    return float(best)


def test_fma32_rounds_once():
    """The emulation's fmaf is one correct rounding of the exact x y + z,
    also where a plain float64 sum lands on an fp32 tie and rounding it
    again would go the wrong way."""
    tie = 1 + 2.0 ** -12           # tie^2 = 1 + 2^-11 + 2^-24: a tie
    xs = [tie, tie, tie, 0.75]
    ys = [tie, tie, tie, 3.0]
    zs = [2.0 ** -60, -2.0 ** -60, 0.0, 2.0 ** -30]
    rng = np.random.default_rng(0)
    r = rng.standard_normal((3, 2000)).astype(np.float32)
    xs += r[0].tolist()
    ys += r[1].tolist()
    zs += (r[2] * 1e-3).tolist()
    x, y, z = (torch.tensor(v, dtype=torch.float32).double()
               for v in (xs, ys, zs))
    got = _fma32(x, y, z)
    want = [_fp32_round(Fraction(xi) * Fraction(yi) + Fraction(zi))
            for xi, yi, zi in zip(x.tolist(), y.tolist(), z.tolist())]
    assert got.tolist() == want
    # the plain float64 sum rounded again misses the first tie
    assert float((x[0] * y[0] + z[0]).float()) != want[0]


def test_reverse_with_states_returns_lambda_and_da():
    """``lru_scan_reverse`` with the forward's states and h0 returns
    (lambda, da), da_t = lambda_t h_{t-1} with h_{-1} = h0; h and h_init
    come together and take the forward's shapes."""
    a, x, h0 = _inputs(2, 9, 5, False, torch.float32)
    hs = lru_scan(a, x, h0)
    lam, da = lru_scan_reverse(a, x, h0, h=hs, h_init=h0)
    torch.testing.assert_close(lam, lru_scan_reverse(a, x, h0), rtol=0,
                               atol=0)
    prev = torch.cat([h0[:, None], hs[:, :-1]], dim=1)
    torch.testing.assert_close(da, lam * prev, rtol=0, atol=0)
    with pytest.raises(ValueError, match="come together"):
        lru_scan_reverse(a, x, h0, h=hs)
    with pytest.raises(ValueError, match="not a's"):
        lru_scan_reverse(a, x, h0, h=hs[:, :-1].contiguous(), h_init=h0)
    with pytest.raises(TypeError, match="h dtype"):
        lru_scan_reverse(a, x, h0, h=hs.double(), h_init=h0)


def test_backward_takes_da_from_the_reverse_launch(monkeypatch):
    """The autograd backward asks the reverse launch for da when a needs a
    gradient (one pass over a, g and h, no concatenation), and for lambda
    alone otherwise."""
    calls = []
    real = lru_ops.lru_scan_reverse_ref

    def spy(a, b, h0, h=None, h_init=None):
        calls.append(h is not None)
        return real(a, b, h0, h, h_init)

    monkeypatch.setattr(lru_ops, "lru_scan_reverse_ref", spy)
    a, x, h0 = _inputs(1, 6, 4, False, torch.float32)
    for grad_a in (True, False):
        a.grad = x.grad = None
        a.requires_grad_(grad_a)
        x.requires_grad_(True)
        lru_scan(a, x, h0).sum().backward()
        assert (a.grad is not None) == grad_a
    assert calls == [True, False]


def test_workspace_and_grid_follow_the_chunks():
    """The workspace holds the ticket and one carry word per (chunk, batch
    row, channel padded to 32), chunks of the kernel's 256 steps unless
    told otherwise; the grid's x axis takes up to 2**31 - 1
    blocks, y and z 65,535."""
    assert workspace_words(2, 4096, 4096, 256) == 1 + 2 * 4096 * 16
    assert workspace_words(3, 77, 33, 16) == 1 + 3 * 64 * 5
    assert workspace_words(1, 257, 32) == 1 + 32 * 2
    device.require_grid("k", blocks=2 ** 31 - 1, axis="x")
    with pytest.raises(ValueError, match="x axis"):
        device.require_grid("k", blocks=2 ** 31, axis="x")
    with pytest.raises(ValueError, match="y axis"):
        device.require_grid("k", batch=65_536)


def test_chunk_constants_are_the_kernels():
    """The launcher's CHUNK and WARPS, which the emulation and the
    workspace use, are the compile-time constants of the CUDA source."""
    src = (Path(lru_ops.__file__).parents[2] / "csrc" / "lru_scan.cu")
    m = re.search(r"constexpr int ROWS = (\d+), WARPS = (\d+), "
                  r"CHUNK = ROWS \* WARPS;", src.read_text())
    assert m is not None
    assert (int(m[1]) * int(m[2]), int(m[2])) == (CHUNK, WARPS)
