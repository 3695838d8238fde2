"""The port's CUDA kernels on the card, against their plain PyTorch
versions at the JAX tests' tolerances. Every test here needs a CUDA card
and skips without one; on a machine with one:

    python -m pytest -m cuda tests/test_torch_cuda.py

This file imports neither jax nor the JAX package: the card's machine
need not have them."""
import pytest
import torch

from repro_torch.kernels import launch_counters
from repro_torch.kernels.gram.ops import gram
from repro_torch.kernels.normal_matvec.ops import normal_matvec
from repro_torch.kernels.rf_map.ops import rf_map_apply
from repro_torch.kernels.rf_map.ref import rf_weights


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc and "
                    "run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tols", [
    (torch.float32, {"gram": 2e-5, "nm": 3e-5, "rf": 1e-5}),
    (torch.bfloat16, {"gram": 2e-2, "nm": 3e-2, "rf": 2e-2}),
])
def test_cuda_kernels_match_their_plain_versions(cuda, dtype, tols):
    from repro_torch.kernels.gram.ref import gram_ref
    from repro_torch.kernels.normal_matvec.ref import normal_matvec_ref
    from repro_torch.kernels.rf_map.ref import rf_map_ref
    counters = launch_counters()
    for c in counters.values():
        c.reset()
    g = torch.Generator().manual_seed(0)
    a = torch.randn(1000, 200, generator=g).to(cuda, dtype)
    want = gram_ref(a)
    torch.testing.assert_close(gram(a), want, rtol=tols["gram"],
                               atol=tols["gram"] * float(want.abs().max()))
    w = torch.randn(200, 3, generator=g).to(cuda)
    want = normal_matvec_ref(a, w)
    torch.testing.assert_close(normal_matvec(a, w), want, rtol=tols["nm"],
                               atol=tols["nm"] * float(want.abs().max()))
    wr, br = (torch.from_numpy(v).to(cuda) for v in rf_weights(200, 77, 2.0,
                                                                1))
    torch.testing.assert_close(rf_map_apply(a, wr, br),
                               rf_map_ref(a, wr, br), rtol=tols["rf"],
                               atol=tols["rf"])
    assert {k: c.value for k, c in counters.items()} == \
        {"gram": 1, "normal_matvec": 1, "rf_map": 1, "swa": 0,
         "lru_scan": 0}


SWA_CASES = [  # (s, window, kv heads): the JAX sweep, then the port's own
    (128, 32, 2), (256, 96, 2), (256, 256, 2), (512, 128, 2),
    (200, 48, 2), (192, 64, 1), (128, 1000, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
def test_cuda_swa_and_lru_scan_match_their_plain_versions(cuda, dtype, tol):
    from repro_torch.kernels.lru_scan.ops import lru_scan
    from repro_torch.kernels.lru_scan.ref import lru_scan_ref
    from repro_torch.kernels.swa.ops import swa_attention
    from repro_torch.kernels.swa.ref import swa_ref
    counters = launch_counters()
    for c in counters.values():
        c.reset()
    g = torch.Generator().manual_seed(1)
    for s, window, kh in SWA_CASES:
        q, k, v = (torch.randn(2, h, s, 32, generator=g).to(cuda, dtype)
                   for h in (4, kh, kh))
        torch.testing.assert_close(swa_attention(q, k, v, window=window),
                                   swa_ref(q, k, v, window), rtol=tol,
                                   atol=tol)
    # the model's layout at RecurrentGemma's head_dim: (B, S, H, D) views
    q = torch.randn(2, 300, 16, 256, generator=g).to(cuda, dtype)
    k = torch.randn(2, 300, 1, 256, generator=g).to(cuda, dtype)
    qh, kh_ = q.transpose(1, 2), k.transpose(1, 2)
    got = swa_attention(qh, kh_, kh_, window=100)
    assert got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(got, swa_ref(qh, kh_, kh_, 100), rtol=tol,
                               atol=tol)
    for b, s, w in [(2, 64, 128), (1, 100, 96), (3, 128, 512)]:
        a = torch.sigmoid(torch.randn(b, s, w, generator=g)).to(cuda, dtype)
        x = (0.1 * torch.randn(b, s, w, generator=g)).to(cuda, dtype)
        h0 = torch.randn(b, w, generator=g).to(cuda)
        torch.testing.assert_close(lru_scan(a, x, h0),
                                   lru_scan_ref(a, x, h0), rtol=tol,
                                   atol=tol)
    got = lru_scan(torch.full((1, 4, 8), 0.5, device=cuda, dtype=dtype),
                   torch.zeros((1, 4, 8), device=cuda, dtype=dtype),
                   torch.full((1, 8), 16.0, device=cuda))
    torch.testing.assert_close(got[0, :, 0].cpu(),
                               torch.tensor([8.0, 4.0, 2.0, 1.0]))
    torch.cuda.synchronize()
    assert {k: c.value for k, c in counters.items()} == \
        {"gram": 0, "normal_matvec": 0, "rf_map": 0,
         "swa": len(SWA_CASES) + 1, "lru_scan": 4}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-5),
                                       (torch.bfloat16, 3e-2)])
def test_cuda_normal_matvec_column_tiles(cuda, dtype, tol):
    """The tensor-core normal_matvec where its tiling bites: c = 147 and
    160 (one column tile), 161 (two), row counts off the 128-row tile, an
    odd d (rows not 16-byte aligned: 4-byte copies or plain loads), and a
    split reduction (4,100 rows, d = 64: few output tiles)."""
    from repro_torch.kernels.normal_matvec.ref import normal_matvec_ref
    g = torch.Generator().manual_seed(2)
    cases = [(1000, 200, 147), (777, 256, 160), (300, 70, 161),
             (1000, 37, 147), (4100, 64, 147)]
    for n, d, c in cases:
        x = torch.randn(n, d, generator=g).to(cuda, dtype)
        w = torch.randn(d, c, generator=g).to(cuda)
        want = normal_matvec_ref(x, w)
        torch.testing.assert_close(normal_matvec(x, w), want, rtol=tol,
                                   atol=tol * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [32, 64, 128, 256])
def test_cuda_swa_routes_by_dtype(cuda, head_dim):
    """bf16 on the tensor cores and fp32 on the CUDA cores, at S = 300 on
    (B, S, H, D) views: bf16 within chip_smoke.py's main-shape limit
    against the plain version on fp32 copies, fp32 within the JAX tests'
    2e-5 (which a bf16 rounding of the probabilities would miss)."""
    from chip_smoke import swa_excess
    from repro_torch.kernels.swa.ops import swa_attention
    from repro_torch.kernels.swa.ref import swa_ref
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 300, 8, head_dim, generator=g).to(cuda)
    k = torch.randn(2, 300, 2, head_dim, generator=g).to(cuda)
    v = torch.randn(2, 300, 2, head_dim, generator=g).to(cuda)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    for window in (100, 300):
        got = swa_attention(qh, kh, vh, window=window)
        torch.testing.assert_close(got, swa_ref(qh, kh, vh, window),
                                   rtol=2e-5, atol=2e-5)
        qb, kb, vb = (t.bfloat16() for t in (qh, kh, vh))
        got = swa_attention(qb, kb, vb, window=window)
        assert got.dtype == torch.bfloat16
        assert got.transpose(1, 2).is_contiguous()
        want = swa_ref(qb.float(), kb.float(), vb.float(), window)
        assert swa_excess(got, want)[1] <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_rf_map_tile_edges(cuda, dtype, tol):
    """The tensor-core rf_map where its tiling bites: D = 77, 161 and
    10,000 (partial 128-column tiles), n = 130 (a partial 128-row tile),
    d = 33 (rows not 16-byte aligned: 4-byte copies or plain loads) and
    d = 440 (a short last 32-deep stage), one launch each."""
    from repro_torch.kernels.rf_map.ref import rf_map_ref
    counters = launch_counters()
    counters["rf_map"].reset()
    g = torch.Generator().manual_seed(4)
    cases = [(130, 440, 77), (130, 33, 161), (300, 440, 10_000),
             (130, 33, 10_000)]
    for n, d, dd in cases:
        x = torch.randn(n, d, generator=g).to(cuda, dtype)
        w, b = (torch.from_numpy(v).to(cuda) for v in rf_weights(d, dd, 2.0,
                                                                  1))
        torch.testing.assert_close(rf_map_apply(x, w, b),
                                   rf_map_ref(x, w, b), rtol=tol, atol=tol)
    assert counters["rf_map"].value == len(cases)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
def test_cuda_lru_scan_ring_edges(cuda, dtype, tol):
    """The copy-ring lru_scan where its tiles bite: S = 1, S off the
    32-step tile, W off the 32-channel group (and rows not 16-byte
    aligned: element copies), B = 3; then the h0 carry across tiles."""
    from repro_torch.kernels.lru_scan.ops import lru_scan
    from repro_torch.kernels.lru_scan.ref import lru_scan_ref
    g = torch.Generator().manual_seed(5)
    for b, s, w in [(1, 1, 64), (2, 77, 128), (1, 100, 100), (3, 64, 33),
                    (3, 300, 4096)]:
        a = torch.sigmoid(torch.randn(b, s, w, generator=g)).to(cuda, dtype)
        x = (0.1 * torch.randn(b, s, w, generator=g)).to(cuda, dtype)
        h0 = torch.randn(b, w, generator=g).to(cuda)
        torch.testing.assert_close(lru_scan(a, x, h0),
                                   lru_scan_ref(a, x, h0), rtol=tol,
                                   atol=tol)
    got = lru_scan(torch.full((2, 70, 40), 0.5, device=cuda, dtype=dtype),
                   torch.zeros((2, 70, 40), device=cuda, dtype=dtype),
                   torch.full((2, 40), 2.0 ** 20, device=cuda))
    want = 2.0 ** (19 - torch.arange(70, dtype=torch.float64))
    torch.testing.assert_close(got[1, :, 39].cpu().double(), want,
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_lru_scan_is_the_sequential_fma_scan(cuda, dtype):
    """The copy ring changes where a and b come from, not the arithmetic:
    each state is one rounding of a_t h_{t-1} + b_t to fp32 (fmaf), as in
    the one-thread-per-channel kernel before it, so the states are the same
    bits. The emulation forms a h exactly in float64 and rounds the sum
    once more; it could differ only where that sum lands on an fp32 tie,
    which this data does not reach. Bulk copies (W 96) and element copies
    (W 33)."""
    from repro_torch.kernels.lru_scan.ops import lru_scan
    g = torch.Generator().manual_seed(6)
    for b, s, w in [(2, 300, 96), (1, 77, 33)]:
        a = torch.sigmoid(torch.randn(b, s, w, generator=g)).to(dtype)
        x = (0.1 * torch.randn(b, s, w, generator=g)).to(dtype)
        h0 = torch.randn(b, w, generator=g)
        want = torch.empty(b, s, w)
        h = h0
        for t in range(s):
            h = (a[:, t].double() * h.double() + x[:, t].double()).float()
            want[:, t] = h
        got = lru_scan(a.to(cuda), x.to(cuda), h0.to(cuda)).cpu()
        assert torch.equal(got, want)
