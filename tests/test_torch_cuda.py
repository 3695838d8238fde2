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
from repro_torch.kernels.normal_matvec.ops import route as nm_route
from repro_torch.kernels.rf_map.ops import rf_map_apply
from repro_torch.kernels.rf_map.ref import rf_weights
from repro_torch.launch.normal_matvec_check import \
    SWEEP_CASES as STREAM_CASES


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
        {"gram": 1, "normal_matvec": 1, "normal_matvec_stream": 0,
         "rf_map": 1, "swa": 0, "swa_bwd": 0, "lru_scan": 0,
         "lru_scan_reverse": 0}


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
        {"gram": 0, "normal_matvec": 0, "normal_matvec_stream": 0,
         "rf_map": 0, "swa": len(SWA_CASES) + 1, "swa_bwd": 0,
         "lru_scan": 4, "lru_scan_reverse": 0}


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,c,offset", STREAM_CASES)
def test_cuda_normal_matvec_stream_route_matches_float64(cuda, dtype, n, d,
                                                         c, offset):
    """normal_matvec at narrow w (normal_matvec_check.SWEEP_CASES: ragged
    n, one row, d off 16 bytes, a base off 16 bytes, short rows, d = 8,096
    and 8,192, c = 1 and past it) against X^T (X w) in float64 at fp32's
    tolerance for both dtypes (a bf16 X is exact in fp32 and the route's
    arithmetic is fp32); the route its shape picks ran (the stream route
    for every c = 1 case), and a second call gives the same bits."""
    g = torch.Generator().manual_seed(n + d + c)
    x = torch.randn(n * d + offset, generator=g).to(cuda, dtype)[offset:] \
        .view(n, d)
    w = torch.randn(d, c, generator=g).to(cuda)
    counters = launch_counters()
    for counter in counters.values():
        counter.reset()
    got = normal_matvec(x, w)
    stream = nm_route(d, c, dtype) == "stream"
    assert stream or c > 1
    assert (counters["normal_matvec_stream"].value,
            counters["normal_matvec"].value) == ((1, 0) if stream else (0, 1))
    want = x.double().T @ (x.double() @ w.double())
    tol = 3e-5
    torch.testing.assert_close(got.double(), want, rtol=tol,
                               atol=tol * float(want.abs().max()))
    assert torch.equal(got, normal_matvec(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [32, 64, 128, 256])
def test_cuda_swa_routes_by_dtype(cuda, head_dim):
    """bf16 on the tensor cores (wgmma) and fp32 on the CUDA cores, at S =
    300 on (B, S, H, D) views: bf16 within chip_smoke.py's main-shape limit
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
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("head_dim", [32, 64, 128, 256])
def test_cuda_swa_tile_edges(cuda, dtype, head_dim):
    """The bf16 wgmma kernel at its tile edges (and the fp32 route at the
    same shapes): S of 1, 127, 128, 129 and 300 at windows of 1, 63, 127,
    129 and S, prefixes of 1, 127, 129 and S, GQA groups of 1, 4, 7 and
    16, on (B, S, H, D) views. Each output within chip_smoke.py's limit
    (bf16) or 2e-5 of max |want| (fp32) of the plain version on fp32
    copies, lse within 2e-5 of max |lse|, and two launches the same
    bits."""
    from repro_torch.launch.forward_check import check_case, edge_cases
    g = torch.Generator(cuda).manual_seed(head_dim)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=cuda)
    bad = [rec for rec in (check_case(rn, dtype, *c) for c in edge_cases()
                           if c[4] == head_dim) if not rec["ok"]]
    assert not bad, bad[:3]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_gram_edges(cuda, dtype):
    """The tensor-core gram at the JAX tests' shapes and its edges
    (launch/gram_check.py EDGE_SHAPES: d = 33 and 130, whose rows TMA
    cannot describe; ragged last tiles up to d = 8,096; n = 1; rows off
    the 32-row stage; many slabs): each within 2e-5 (fp32) or 2e-2 (bf16)
    of the plain version, exactly symmetric, and the same bits from two
    launches, one launch counted each."""
    from repro_torch.launch.gram_check import EDGE_SHAPES, TEST_SHAPES, \
        check_case
    counters = launch_counters()
    counters["gram"].reset()
    g = torch.Generator(cuda).manual_seed(5)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=cuda)
    shapes = TEST_SHAPES + EDGE_SHAPES
    bad = [rec for rec in (check_case(rn, dtype, n, d) for n, d in shapes)
           if not rec["ok"]]
    assert not bad, bad[:3]
    assert counters["gram"].value == 2 * len(shapes)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [0, -32, 48])
def test_cuda_gram_entry_refuses_a_slab_off_the_stage(cuda, rows):
    """The C entry launches nothing for slab rows that are not a positive
    multiple of the 32-row stage: a TMA stage loads 32 rows unmasked, so a
    slab ending inside one would count the next slab's rows twice."""
    from repro_torch.kernels import build, device
    a = torch.ones(96, 64, device=cuda)
    out = torch.full((64, 64), 7.0, device=cuda)
    part = torch.zeros(4, 64, 64, device=cuda)
    lib = build.load("gram")
    with torch.cuda.device(a.device):
        err = lib.gram_launch(0, a.data_ptr(), part.data_ptr(),
                              out.data_ptr(), 96, 64, rows,
                              device.stream_ptr(a))
    torch.cuda.synchronize()
    assert err == 1            # cudaErrorInvalidValue
    assert bool((out == 7.0).all()) and not bool(part.any())


@pytest.mark.cuda
def test_cuda_gram_launches_from_a_fresh_thread(cuda):
    """The first gram of a thread that has made no CUDA call yet (an
    engine worker's): its launcher makes the device's context current
    before the driver encodes the tensor map (the encoder refused the map
    with CUDA_ERROR_INVALID_CONTEXT otherwise)."""
    import threading
    from repro_torch.kernels.gram.ref import gram_ref
    a = torch.randn(300, 256, generator=torch.Generator().manual_seed(6))
    a = a.to(cuda)
    want = gram_ref(a)
    torch.cuda.synchronize()
    out = {}

    def run():
        try:
            out["g"] = gram(a)
            torch.cuda.synchronize()
        except Exception as e:   # reported below, in the test's thread
            out["error"] = e
    worker = threading.Thread(target=run)
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive()
    assert "error" not in out, out.get("error")
    torch.testing.assert_close(out["g"], want, rtol=2e-5,
                               atol=2e-5 * float(want.abs().max()))


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
    """The chunked lru_scan where its chunks and lane groups bite: S = 1,
    S short of a chunk, off a chunk's end and on it, W off the 32-channel
    group (33, 100), B = 3; both directions, the reverse with its fused da
    against the plain version; then the h0 carry across chunk boundaries,
    exactly, in both directions."""
    from repro_torch.kernels.lru_scan.ops import lru_scan, lru_scan_reverse
    from repro_torch.kernels.lru_scan.ref import lru_scan_ref, \
        lru_scan_reverse_ref
    g = torch.Generator().manual_seed(5)
    for b, s, w in [(1, 1, 64), (2, 77, 128), (1, 100, 100), (3, 64, 33),
                    (3, 300, 4096), (1, 256, 64), (2, 513, 40),
                    (1, 1100, 96)]:
        a = torch.sigmoid(torch.randn(b, s, w, generator=g)).to(cuda, dtype)
        x = (0.1 * torch.randn(b, s, w, generator=g)).to(cuda, dtype)
        h0 = torch.randn(b, w, generator=g).to(cuda)
        hs = lru_scan(a, x, h0)
        torch.testing.assert_close(hs, lru_scan_ref(a, x, h0), rtol=tol,
                                   atol=tol)
        got = lru_scan_reverse(a, x, h0, h=hs, h_init=h0)
        for gg, want in zip(got, lru_scan_reverse_ref(a, x, h0, hs, h0)):
            torch.testing.assert_close(gg, want, rtol=tol, atol=tol)
    # a = 1, b = 0 keeps every state exactly h0 at any S in both types, so
    # a carry lost or read from the wrong slot at the chunk boundaries
    # (t = 256, 512) shows exactly; the reverse carries h0 the same way
    a1 = torch.ones((2, 700, 40), device=cuda, dtype=dtype)
    x0 = torch.zeros((2, 700, 40), device=cuda, dtype=dtype)
    h0 = torch.randn(2, 40, generator=g).to(cuda)
    want = h0[:, None, :].expand(2, 700, 40)
    assert torch.equal(lru_scan(a1, x0, h0), want)
    assert torch.equal(lru_scan_reverse(a1, x0, h0), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_lru_scan_is_the_sequential_fma_scan(cuda, dtype):
    """Since the kernel splits time into chunks its states are no longer
    the sequential walk's bits: every step is still one fmaf, in the
    chunked association that ``lru_scan_chunked_ref`` emulates. Both
    directions (the reverse with da) are those bits, at the kernel's one
    chunk configuration, and the same bits at a second launch; and within
    the fp32 tolerance of the sequential walk in float64. Full chunks, a short last chunk, W 33 (a short lane group)."""
    from repro_torch.kernels.lru_scan.lru_scan import CHUNK, WARPS
    from repro_torch.kernels.lru_scan.ops import lru_scan, lru_scan_reverse
    from repro_torch.kernels.lru_scan.ref import lru_scan_chunked_ref
    g = torch.Generator().manual_seed(6)
    for b, s, w in [(2, 1030, 96), (1, 77, 33), (2, 512, 64)]:
        a = torch.sigmoid(torch.randn(b, s, w, generator=g)).to(dtype)
        x = (0.1 * torch.randn(b, s, w, generator=g)).to(dtype)
        h0 = torch.randn(b, w, generator=g)
        want = torch.empty(b, s, w, dtype=torch.float64)
        h = h0.double()
        for t in range(s):
            h = a[:, t].double() * h + x[:, t].double()
            want[:, t] = h
        ac, xc, h0c = a.to(cuda), x.to(cuda), h0.to(cuda)
        got = lru_scan(ac, xc, h0c)
        torch.testing.assert_close(got.cpu().double(), want, rtol=1e-5,
                                   atol=1e-5)
        emul = lru_scan_chunked_ref(a, x, h0, CHUNK, WARPS)
        assert torch.equal(got.cpu(), emul)
        assert torch.equal(lru_scan(ac, xc, h0c), got)
        rev = lru_scan_reverse(ac, xc, h0c, h=got, h_init=h0c)
        emul = lru_scan_chunked_ref(a, x, h0, CHUNK, WARPS, reverse=True,
                                    h=got.cpu(), h_init=h0)
        again = lru_scan_reverse(ac, xc, h0c, h=got, h_init=h0c)
        for r, e, r2 in zip(rev, emul, again):
            assert torch.equal(r.cpu(), e) and torch.equal(r, r2)


# ---------------------------------------------------------------------------
# chain fusion on the card: a burst chain replays from one CUDA graph
# ---------------------------------------------------------------------------
def _fusion_engine(cuda, **kw):
    from repro_torch.core import AlchemistContext, AlchemistEngine
    from repro_torch.core.libraries import elemental
    engine = AlchemistEngine(device=cuda, cache_entries=0, **kw)
    engine.load_library("elemental", elemental)
    return engine, AlchemistContext(engine=engine)


def _burst(engine, ac, al):
    """G = gram(A), Gt = G^T, S = G + Gt, P = S S, submitted in one burst;
    returns the four outputs as device tensors."""
    el = ac.library("elemental")
    engine.scheduler.pause()
    g = el.gram(A=al)
    gt = el.transpose(A=g)
    s = el.add(A=g, B=gt)
    p = el.multiply(A=s, B=s)
    engine.scheduler.resume()
    p.result()
    return [_resident(engine, ac, x) for x in (g, gt, s, p)]


def _resident(engine, ac, al):
    return engine._resolve(al.handle, session=ac.session)[0]


@pytest.mark.cuda
def test_cuda_burst_chain_replays_from_one_graph_and_counts_gram(cuda):
    """Capture on the first run, replay on the second: one dispatched task
    and four fused ops each time, one program holding one graph, no
    capture failure, and the outputs equal the unfused chain's within the
    fp32 kernel tolerance. The input is a small slot, so the first run
    builds static buffers, runs the chain on them (one gram launch),
    captures it and replays it (the replay adds what the capture recorded:
    one more); every later run is one replay, one launch."""
    from repro_torch.kernels.gram.ops import LAUNCHES
    engine, ac = _fusion_engine(cuda)
    backend = engine.backends["torch"]
    try:
        g = torch.Generator().manual_seed(11)
        al = ac.send_matrix(torch.randn(4096, 256, generator=g).numpy(),
                            dedup=False)
        for run in range(2):
            before, launches = engine.task_log.stats(), LAUNCHES.value
            outs = _burst(engine, ac, al)
            after = engine.task_log.stats()
            assert after["dispatched"] - before["dispatched"] == 1
            assert after["fused_ops"] - before["fused_ops"] == 4
            assert LAUNCHES.value - launches == (2 if run == 0 else 1), run
            assert backend.program_cache_info()["programs"] == 1
            assert backend.graphs() == 1
            assert backend.capture_failures == 0
        ac.configure(fusion=False)
        want = _burst(engine, ac, al)
        for got, ref in zip(outs, want):
            torch.testing.assert_close(got, ref, rtol=2e-5,
                                       atol=2e-5 * float(ref.abs().max()))
    finally:
        ac.stop()
        engine.shutdown()


@pytest.mark.cuda
def test_cuda_replay_leaves_earlier_outputs_intact(cuda):
    """The graph writes its outputs into its own pool at every replay: each
    run hands out copies, so a replay after the input changed in place
    (same address, new contents) computes from the new contents and
    leaves the earlier runs' outputs as they were. The chain's first step
    is a transpose of the input, an output the capture copies into the
    graph instead of keeping a view of the input."""
    engine, ac = _fusion_engine(cuda)
    try:
        el = ac.library("elemental")
        g = torch.Generator().manual_seed(12)
        x = torch.randn(300, 300, generator=g)
        al = ac.send_matrix(x.numpy(), dedup=False)
        resident = _resident(engine, ac, al)
        ptr = resident.data_ptr()
        live, kept = [], []
        for scale in (1.0, 2.0, 3.0):
            resident.copy_(x.to(cuda) * scale)        # same address
            engine.scheduler.pause()
            t = el.transpose(A=al)
            s = el.add(A=t, B=al)
            p = el.multiply(A=s, B=al)
            engine.scheduler.resume()
            p.result()
            outs = [_resident(engine, ac, h) for h in (t, s, p)]
            live.append(outs)
            kept.append([o.clone() for o in outs])
            assert _resident(engine, ac, al).data_ptr() == ptr
        assert engine.backends["torch"].program_cache_info()["programs"] \
            == 1
        for scale, outs, copies in zip((1.0, 2.0, 3.0), live, kept):
            xs = x.to(cuda) * scale
            want = [xs.T, xs.T + xs, (xs.T + xs) @ xs]
            for got, copy, ref in zip(outs, copies, want):
                assert torch.equal(got, copy)       # never overwritten
                torch.testing.assert_close(got, ref, rtol=2e-5,
                                           atol=2e-5 * float(
                                               ref.abs().max()))
    finally:
        ac.stop()
        engine.shutdown()


@pytest.mark.cuda
def test_cuda_program_lru_and_shutdown_release_the_graph_pools(cuda):
    """A new signature is a new capture; past the bound the oldest
    program is released (its graph reset, its pool and its buffers
    returned), and shutdown releases the rest."""
    engine, ac = _fusion_engine(cuda, program_cache_size=1)
    backend = engine.backends["torch"]
    try:
        g = torch.Generator().manual_seed(13)
        a1 = ac.send_matrix(torch.randn(2048, 512, generator=g).numpy(),
                            dedup=False)
        a2 = ac.send_matrix(torch.randn(1024, 512, generator=g).numpy(),
                            dedup=False)
        _burst(engine, ac, a1)
        _burst(engine, ac, a2)
        info = backend.program_cache_info()
        # what release frees is the live program's buffer (1024 x 512)
        # and its outputs in its pool: G, S and P (Gt is a view of G); the
        # evicted program's went with it (kept, release would free more)
        out = 512 * 512 * 4
        held = backend.held_bytes()
        assert held == 1024 * 512 * 4 + 3 * out, held
        quarter = torch.cuda.get_device_properties(cuda).total_memory // 4
        assert info == {"programs": 1, "max_programs": 1, "held_bytes": held,
                        "max_program_bytes": quarter, "evictions": 1}
        assert backend.capture_failures == 0 and backend.graphs() == 1
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        backend.release()
        freed = before - torch.cuda.memory_allocated()
        assert held <= freed < 2 * held, (held, freed)
        _burst(engine, ac, a1)                    # captured anew
        assert backend.program_cache_info()["programs"] == 1
    finally:
        ac.stop()
        engine.shutdown()
    assert backend.program_cache_info()["programs"] == 0


@pytest.mark.cuda
def test_cuda_captures_while_other_workers_launch_and_synchronise(cuda):
    """Captures run on a side stream in ``thread_local`` mode: another
    worker's eager launches and device synchronisations, running all the
    while, neither break a capture nor are broken by one."""
    import threading
    from repro_torch.core import AlchemistContext
    # six shapes, six signatures, six captures; unbucketed, so the other
    # worker's products run eagerly, outside the program cache
    engine, ac = _fusion_engine(cuda, bucketing=False)
    ac2 = AlchemistContext(engine=engine)
    backend = engine.backends["torch"]
    try:
        g = torch.Generator().manual_seed(14)
        mats = [ac.send_matrix(torch.randn(1024 + 32 * i, 256,
                                           generator=g).numpy(),
                               dedup=False) for i in range(6)]
        other = ac2.send_matrix(torch.randn(512, 512, generator=g).numpy(),
                                dedup=False)
        stop, errors, calls = threading.Event(), [], [0]

        def eager_traffic():
            try:
                while not stop.is_set():
                    ac2.call("elemental", "multiply", A=other, B=other)
                    calls[0] += 1
            except Exception as e:          # reported below
                errors.append(e)

        t = threading.Thread(target=eager_traffic)
        t.start()
        try:
            runs = [(_burst(engine, ac, al), al) for al in mats]
        finally:
            stop.set()
            t.join(timeout=120)
        assert not t.is_alive() and not errors and calls[0] > 0
        assert backend.capture_failures == 0
        assert backend.program_cache_info()["programs"] == len(mats)
        assert backend.graphs() == len(mats)
        for outs, al in runs:
            x = _resident(engine, ac, al)
            gram = x.T @ x
            s = gram + gram.T
            for got, ref in zip(outs, (gram, gram.T, s, s @ s)):
                torch.testing.assert_close(
                    got, ref, rtol=2e-5, atol=2e-5 * float(ref.abs().max()))
    finally:
        ac2.stop()
        ac.stop()
        engine.shutdown()


# ---------------------------------------------------------------------------
# the compile cache on the card: warmup, static buffers, the warm restart
# ---------------------------------------------------------------------------
def _f64_close(got, want64, rtol=2e-5):
    """``got`` against a float64 result at the fp32 kernel tolerance."""
    want = want64.to(got.dtype)
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=rtol * float(want.abs().max()))


def _chain_plan(backend, specs):
    """multiply(i0, i1), its transpose, and the gram of that: a capturable
    three-step plan."""
    from repro_torch.core.backends import base as bb
    impl = backend.routine_impl
    return bb.ExecutionPlan(steps=[
        bb.PlanStep(library="elemental", routine="multiply",
                    args={"A": bb.Input("i0"), "B": bb.Input("i1")},
                    impl=impl("elemental", "multiply")),
        bb.PlanStep(library="elemental", routine="transpose",
                    args={"A": bb.StepRef(0, "C")},
                    impl=impl("elemental", "transpose")),
        bb.PlanStep(library="elemental", routine="gram",
                    args={"A": bb.StepRef(1, "C")},
                    impl=impl("elemental", "gram"))],
        input_specs={s: (shape, "float32") for s, shape in specs.items()})


def _card_backend(cuda, **kw):
    from repro_torch.core.backends.torch_backend import TorchBackend
    backend = TorchBackend(**kw)
    backend.device = cuda
    return backend


@pytest.mark.cuda
def test_cuda_warmed_buckets_absorb_odd_first_calls(cuda):
    """After warmup at the engine's bucket grid, first calls at odd shapes
    of every bucketable routine compile nothing on the request path and
    capture nothing; their results hold against float64."""
    engine, ac = _fusion_engine(cuda, bucket_grid=(64, 128))
    backend = engine.backends["torch"]
    try:
        stats = engine.warmup(grid=(64, 128))
        assert stats["compiled"] >= 4 and not stats["skipped"]
        captured = backend.capture_seconds
        g = torch.Generator().manual_seed(21)
        a = torch.randn(100, 45, generator=g)
        b = torch.randn(45, 29, generator=g)
        c = torch.randn(100, 45, generator=g)
        ha, hb, hc = (ac.send_matrix(t.numpy(), dedup=False)
                      for t in (a, b, c))
        got = {
            "multiply": ac.call("elemental", "multiply", A=ha, B=hb)["C"],
            "gram": ac.call("elemental", "gram", A=ha)["G"],
            "transpose": ac.call("elemental", "transpose", A=ha)["C"],
            "add": ac.call("elemental", "add", A=ha, B=hc)["C"]}
        log = engine.compile_log.stats()
        assert log["request_compiles"] == 0, log
        assert log["bucketed_request_compiles"] == 0, log
        assert log["bucketed_executions"] >= 4
        assert backend.capture_seconds == captured
        assert backend.capture_failures == 0
        a64, b64, c64 = (t.double().to(cuda) for t in (a, b, c))
        want = {"multiply": a64 @ b64, "gram": a64.T @ a64,
                "transpose": a64.T, "add": a64 + c64}
        for k, h in got.items():
            _f64_close(engine._resolve(h, session=ac.session)[0], want[k])
    finally:
        ac.stop()
        engine.shutdown()


@pytest.mark.cuda
def test_cuda_a_chain_from_the_index_replays_the_graph_warmup_captured(
        cuda, tmp_path):
    """An engine serves a burst chain and records it in its compile cache
    dir; a restarted engine on that dir captures the chain in warmup, and
    the same burst then replays that graph: no request-path compile, no
    new capture seconds, gram counted once (the replay)."""
    from repro_torch.kernels.gram.ops import LAUNCHES
    cache_dir = str(tmp_path / "cc")
    g = torch.Generator().manual_seed(22)
    x = torch.randn(300, 200, generator=g)
    outs = []
    for run in range(2):
        engine, ac = _fusion_engine(cuda, compile_cache_dir=cache_dir)
        backend = engine.backends["torch"]
        try:
            if run == 1:
                stats = engine.warmup(grid=(64,))
                assert stats["replayed"] >= 1, stats
                assert backend.graphs() == 1
                captured = backend.capture_seconds
                assert captured > 0
            al = ac.send_matrix(x.numpy(), dedup=False)
            launches = LAUNCHES.value
            outs.append([t.clone() for t in _burst(engine, ac, al)])
            log = engine.compile_log.stats()
            if run == 1:
                assert log["request_compiles"] == 0, log
                assert backend.capture_seconds == captured
                assert LAUNCHES.value - launches == 1
            assert backend.capture_failures == 0
        finally:
            ac.stop()
            engine.shutdown()
    x64 = x.double().to(cuda)
    gram = x64.T @ x64
    s = gram + gram.T
    for got, want in zip(outs[1], (gram, gram.T, s, s @ s)):
        _f64_close(got, want)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_a_static_buffer_program_reads_its_inputs_anew(cuda):
    """A program built from specs alone (static buffers, captured before
    any tensor exists) gives each call's own result: a new tensor, and the
    same tensor after its contents changed in place."""
    backend = _card_backend(cuda)
    try:
        plan = _chain_plan(backend, {"i0": (256, 128), "i1": (128, 64)})
        program, info = backend.get_or_compile(plan)
        assert info["aot"] and backend.graphs() == 1
        assert set(program.buffers) == {"i0", "i1"}
        g = torch.Generator().manual_seed(23)
        a = torch.randn(256, 128, generator=g).to(cuda)
        b = torch.randn(128, 64, generator=g).to(cuda)
        for step in range(3):
            if step == 1:
                a.mul_(-2.0)                   # same tensor, new contents
            if step == 2:
                a = torch.randn(256, 128, generator=g).to(cuda)
            got = program({"i0": a, "i1": b})
            c = a.double() @ b.double()
            _f64_close(got[0]["C"], c)
            _f64_close(got[2]["G"], c @ c.T)
        assert backend.capture_failures == 0
    finally:
        backend.release()


@pytest.mark.cuda
def test_cuda_a_large_slot_is_read_in_place_never_copied(cuda, monkeypatch):
    """A chain whose slot is large keeps one capture per input address;
    the graph reads the input where it lies (new contents at the same
    address show in the next replay), and no program holds a copy of it."""
    from repro_torch.core import compilecache
    monkeypatch.setattr(compilecache, "SMALL_SLOT_BYTES", 1 << 20)
    backend = _card_backend(cuda)
    try:
        plan = _chain_plan(backend, {"i0": (2048, 512), "i1": (512, 64)})
        program, info = backend.get_or_compile(plan)
        assert not info["aot"] and backend.graphs() == 0
        g = torch.Generator().manual_seed(24)
        a = torch.randn(2048, 512, generator=g).to(cuda)
        b = torch.randn(512, 64, generator=g).to(cuda)
        for step in range(2):
            if step == 1:
                a.mul_(0.5)
            got = program({"i0": a, "i1": b})
            c = a.double() @ b.double()
            _f64_close(got[2]["G"], c @ c.T)
        assert backend.graphs() == 1 and backend.capture_failures == 0
        captures = [p for p in backend._programs.values()
                    if p.graph is not None]
        assert [p.buffers for p in captures] == [{}]
        # what the capture holds is its outputs C and G, no copy of a
        assert backend.held_bytes() == (2048 * 64 + 2048 * 2048) * 4
    finally:
        backend.release()


@pytest.mark.cuda
def test_cuda_evicting_a_static_buffer_program_returns_its_bytes(cuda):
    backend = _card_backend(cuda, max_programs=1)
    try:
        plan = _chain_plan(backend, {"i0": (1024, 1024), "i1": (1024, 256)})
        backend.get_or_compile(plan)
        held = backend.held_bytes()
        # the buffers i0 and i1 and the outputs C and G (Ct is a view of C)
        assert held == (1024 * 1024 + 1024 * 256 + 1024 * 256
                        + 1024 * 1024) * 4, held
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        # a single op with a large slot: built without allocating, and
        # the bound of one drops the captured program
        from repro_torch.core.backends import base as bb
        big = bb.ExecutionPlan(steps=[bb.PlanStep(
            library="elemental", routine="gram",
            args={"A": bb.Input("i0")},
            impl=backend.routine_impl("elemental", "gram"))],
            input_specs={"i0": ((8192, 8193), "float32")})
        _, info = backend.get_or_compile(big)
        assert info["evicted"] == 1 and backend.graphs() == 0
        torch.cuda.synchronize()
        freed = before - torch.cuda.memory_allocated()
        assert freed >= held, (freed, held)
        assert backend.held_bytes() == 0
    finally:
        backend.release()


@pytest.mark.cuda
def test_cuda_a_capture_that_fails_in_warmup_is_counted(cuda, tmp_path,
                                                        monkeypatch):
    """A capture that fails while a restarted engine's warmup replays its
    index counts in ``capture_failures`` and keeps nothing; warmup goes
    on, and the request that follows captures the chain."""
    from repro_torch.core.backends import torch_backend
    cache_dir = str(tmp_path / "cc")
    g = torch.Generator().manual_seed(25)
    x = torch.randn(200, 100, generator=g)
    engine, ac = _fusion_engine(cuda, compile_cache_dir=cache_dir)
    try:
        _burst(engine, ac, ac.send_matrix(x.numpy(), dedup=False))
    finally:
        ac.stop()
        engine.shutdown()

    real = torch_backend._detached

    def synchronising(outs, inputs):
        # a stream synchronisation inside the capture: not permitted
        torch.cuda.current_stream().synchronize()
        return real(outs, inputs)

    engine, ac = _fusion_engine(cuda, compile_cache_dir=cache_dir)
    backend = engine.backends["torch"]
    try:
        monkeypatch.setattr(torch_backend, "_detached", synchronising)
        stats = engine.warmup(grid=(64,))
        monkeypatch.setattr(torch_backend, "_detached", real)
        assert stats["replayed"] == 1
        assert backend.capture_failures == 1
        assert backend.graphs() == 0
        outs = _burst(engine, ac, ac.send_matrix(x.numpy(), dedup=False))
        assert backend.graphs() == 1 and backend.capture_failures == 1
        x64 = x.double().to(cuda)
        _f64_close(outs[0], x64.T @ x64)
    finally:
        ac.stop()
        engine.shutdown()


# ---------------------------------------------------------------------------
# the invariant gate's repairs on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_program_lru_holds_static_chains_under_its_byte_bound(cuda):
    """More static-buffer chains than the byte bound holds: the LRU drops
    the oldest as each new one comes in, the live programs never hold
    more than the bound (nor does the device, beyond them), and the
    memory comes back when they are released."""
    backend = _card_backend(cuda, max_programs=64)

    def plan(i):            # i0 (256 + 8 i) x 256, i1 256 x 128
        return _chain_plan(backend, {"i0": (256 + 8 * i, 256),
                                     "i1": (256, 128)})

    try:
        # settle cuBLAS's workspace on the side stream first
        backend.get_or_compile(plan(0))
        one = backend.held_bytes()
        # the buffers i0 (256 x 256) and i1 (256 x 128) and the outputs C
        # (256 x 128) and G (256 x 256; Ct is a view of C)
        assert one == (256 * 256 + 256 * 128 + 256 * 128 + 256 * 256) * 4
        backend.release()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        bound = int(2.5 * one)
        backend.max_program_bytes = bound
        for i in range(8):
            backend.get_or_compile(plan(i))
            torch.cuda.synchronize()
            assert backend.held_bytes() <= bound
            assert torch.cuda.memory_allocated() - base <= bound + (1 << 20)
        info = backend.program_cache_info()
        assert info["max_program_bytes"] == bound
        assert info["evictions"] >= 6 and info["programs"] <= 2
        assert backend.graphs() == info["programs"]
    finally:
        backend.release()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() - base <= 1 << 20


@pytest.mark.cuda
def test_cuda_a_planted_item_in_a_capture_safe_body_fails_under_sync_debug(
        cuda):
    """What ``chip_smoke.py``'s gate runs for every capture-safe body:
    under ``set_sync_debug_mode("error")`` the registered body runs, and
    the same body with a planted ``.item()`` raises. Without the mode the
    planted sync only fails the chain's capture (counted), and the chain
    answers eagerly."""
    import dataclasses
    backend = _card_backend(cuda)
    key = ("elemental", "multiply")
    real = backend.routine_impl(*key)

    def planted(A, B):
        A.sum().item()                  # a host sync inside the body
        return real.fn(A=A, B=B)

    backend._impls[key] = dataclasses.replace(real, fn=planted)
    g = torch.Generator().manual_seed(41)
    a = torch.randn(64, 32, generator=g).to(cuda)
    b = torch.randn(32, 48, generator=g).to(cuda)
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        real.fn(A=a, B=b)
        with pytest.raises(RuntimeError, match="synchroniz"):
            backend.routine_impl(*key).fn(A=a, B=b)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    try:
        program, _ = backend.get_or_compile(
            _chain_plan(backend, {"i0": (64, 32), "i1": (32, 48)}))
        assert backend.capture_failures == 1 and backend.graphs() == 0
        outs = program({"i0": a, "i1": b})
        c64 = a.double() @ b.double()
        _f64_close(outs[2]["G"], c64 @ c64.T)
    finally:
        backend.release()


# ------------------------------------------------------------- training

def _layer_grads(layer_cls, cfg, dev, args, kwargs, seed=0):
    """The gradient of sum(out * g) by every parameter and the input of a
    layer built from a seeded generator on the CPU and moved to ``dev``."""
    torch.manual_seed(seed)
    layer = layer_cls(cfg, generator=torch.Generator().manual_seed(seed),
                      device="cpu").to(dev)
    params = {k: p.detach().clone().requires_grad_()
              for k, p in layer.named_parameters()}
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.randn(2, 300, cfg.d_model, generator=gen).to(dev)
    x.requires_grad_()
    g = torch.randn(2, 300, cfg.d_model, generator=gen).to(dev)
    out, _ = torch.func.functional_call(layer, params, (x, *args), kwargs)
    (out * g).sum().backward()
    return {"x": x.grad, **{k: p.grad for k, p in params.items()}}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("kind", ["local_attention", "rglru"])
def test_cuda_layer_gradients_equal_the_cpus(cuda, dtype, tol, kind):
    """ROADMAP C11: on the card the swa and lru_scan kernels returned
    tensors cut off from autograd, so q, k, v and the recurrence's inputs
    got no gradient. Every parameter's gradient of a local-attention and
    an RG-LRU layer on the card equals the CPU's (by its norm), and the
    backward kernels ran."""
    from repro_torch.common.config import ModelConfig
    from repro_torch.nn.attention import Attention
    from repro_torch.nn.rglru import RGLRU
    cfg = ModelConfig(name="t", num_layers=1, d_model=256, num_heads=4,
                      num_kv_heads=1, head_dim=64, d_ff=512,
                      vocab_size=100, sliding_window=100, lru_width=256)
    counters = launch_counters()
    for c in counters.values():
        c.reset()
    pos = torch.arange(300).expand(2, 300)
    if kind == "rglru":
        cls, kw = RGLRU, {"compute_dtype": dtype}
    else:
        cls, kw = Attention, {"window": 100, "compute_dtype": dtype}
    grads = {}
    for dev in ("cpu", cuda):
        a = () if kind == "rglru" else (pos.to(dev),)
        grads[str(dev)] = _layer_grads(cls, cfg, dev, a, kw)
    want, got = grads["cpu"], grads[str(cuda)]
    assert set(got) == set(want)
    for k, w in want.items():
        gk = got[k]
        assert gk is not None and bool(torch.isfinite(gk).all()), k
        assert float(gk.abs().max()) > 0, k
        err = float(torch.linalg.norm(gk.cpu().float() - w.float()))
        assert err <= tol * float(torch.linalg.norm(w.float())), k
    torch.cuda.synchronize()
    fwd, bwd = ("swa", "swa_bwd") if kind == "local_attention" else \
        ("lru_scan", "lru_scan_reverse")
    assert counters[fwd].value == 1 and counters[bwd].value == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
def test_cuda_backward_kernels_match_their_plain_versions(cuda, dtype, tol):
    """swa_bwd (GQA, MQA, S off the 32- and 64-row tiles, window >= S,
    every head dim) and the reverse lru_scan against their plain versions
    on fp32 copies, within tol of max |grad|; in bf16 also within
    chip_smoke.py's GRAD_RMS_TOL of RMS(grad)."""
    from chip_smoke import GRAD_RMS_TOL, grad_rms_ratio
    from repro_torch.kernels.lru_scan.ops import lru_scan_reverse
    from repro_torch.kernels.lru_scan.ref import lru_scan_reverse_ref
    from repro_torch.kernels.swa.ops import swa_backward, swa_forward
    from repro_torch.kernels.swa.ref import swa_backward_ref
    g = torch.Generator().manual_seed(3)
    for b, h, kh, s, d, window in [(2, 4, 2, 128, 32, 32),
                                   (2, 4, 1, 200, 64, 48),
                                   (1, 4, 2, 70, 128, 1000),
                                   (2, 16, 1, 300, 256, 100)]:
        q = torch.randn(b, s, h, d, generator=g).to(cuda, dtype)
        k, v = (torch.randn(b, s, kh, d, generator=g).to(cuda, dtype)
                for _ in range(2))
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        dout = torch.randn(b, h, s, d, generator=g).to(cuda, dtype)
        _, lse, o32 = swa_forward(q, k, v, window, with_lse=True)
        got = swa_backward(q, k, v, o32, lse, dout, window=window)
        want = swa_backward_ref(q.float(), k.float(), v.float(), o32, lse,
                                dout.float(), window)
        for gg, w, t in zip(got, want, (q, k, v)):
            assert gg.dtype == dtype and gg.stride() == t.stride()
            torch.testing.assert_close(gg.float(), w, rtol=0,
                                       atol=tol * float(w.abs().max()))
            if dtype == torch.bfloat16:
                assert grad_rms_ratio(gg, w) <= GRAD_RMS_TOL["bfloat16"]
    # the reverse lru_scan, then its chunks' edges (S on and off a chunk's
    # end), each also with the fused da from forward states
    for b, s, w in [(2, 64, 128), (1, 100, 96), (3, 77, 100), (2, 300, 33),
                    (1, 256, 64), (2, 770, 40)]:
        a = torch.rand(b, s, w, generator=g).to(cuda, dtype)
        x = torch.randn(b, s, w, generator=g).to(cuda, dtype)
        h0 = torch.randn(b, w, generator=g).to(cuda)
        hs = torch.randn(b, s, w, generator=g).to(cuda)
        torch.testing.assert_close(lru_scan_reverse(a, x, h0),
                                   lru_scan_reverse_ref(a, x, h0),
                                   rtol=1e-5, atol=1e-5)
        got = lru_scan_reverse(a, x, h0, h=hs, h_init=h0)
        for gg, want in zip(got, lru_scan_reverse_ref(a, x, h0, hs, h0)):
            torch.testing.assert_close(gg, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [32, 64, 128, 256])
def test_cuda_swa_backward_routes_by_dtype(cuda, head_dim):
    """The backward's launcher reports the route it dispatches on: bf16 to
    the tensor-core kernels, fp32 to the CUDA-core kernels. At S = 300
    (off the 64-row tile) on (B, S, H, D) views with one query head a kv
    head, GQA and MQA, fp32
    meets the JAX tests' 2e-5 of max |grad| and bf16 both GRAD_TOL and
    GRAD_RMS_TOL, against the plain version on fp32 copies."""
    from chip_smoke import GRAD_RMS_TOL, GRAD_TOL, grad_rms_ratio
    from repro_torch.kernels.swa.ops import swa_backward, swa_forward
    from repro_torch.kernels.swa.ref import swa_backward_ref
    from repro_torch.kernels.swa.swa import swa_bwd_route
    g = torch.Generator().manual_seed(6)
    for h, kh in ((8, 8), (8, 2), (8, 1)):
        q = torch.randn(2, 300, h, head_dim, generator=g).to(cuda)
        k, v = (torch.randn(2, 300, kh, head_dim, generator=g).to(cuda)
                for _ in range(2))
        dout = torch.randn(2, 300, h, head_dim, generator=g).to(cuda)
        for dtype, route in ((torch.float32, "cuda_cores"),
                             (torch.bfloat16, "tensor_cores")):
            qd, kd, vd, gd = (t.to(dtype).transpose(1, 2)
                              for t in (q, k, v, dout))
            assert swa_bwd_route(qd) == route
            _, lse, o32 = swa_forward(qd, kd, vd, 100, with_lse=True)
            got = swa_backward(qd, kd, vd, o32, lse, gd, window=100)
            want = swa_backward_ref(qd.float(), kd.float(), vd.float(),
                                    o32, lse, gd.float(), 100)
            dn = str(dtype).removeprefix("torch.")
            for gg, w in zip(got, want):
                assert gg.dtype == dtype
                err = float((gg.float() - w).abs().max())
                assert err <= GRAD_TOL[dn] * float(w.abs().max())
                if dn in GRAD_RMS_TOL:
                    assert grad_rms_ratio(gg, w) <= GRAD_RMS_TOL[dn]


@pytest.mark.cuda
def test_cuda_swa_backward_repeats_bit_for_bit(cuda):
    """Two launches of the bf16 backward at an MQA shape (16 query heads
    to one kv head: dK and dV summed over four head splits) give the same
    bits: nothing is added atomically."""
    from repro_torch.kernels.swa import ops as swa_ops
    g = torch.Generator().manual_seed(7)
    q, dout = (torch.randn(2, 1000, 16, 256, generator=g).to(
        cuda, torch.bfloat16).transpose(1, 2) for _ in range(2))
    k, v = (torch.randn(2, 1000, 1, 256, generator=g).to(
        cuda, torch.bfloat16).transpose(1, 2) for _ in range(2))
    _, lse, o32 = swa_ops.swa_forward(q, k, v, 300, with_lse=True)
    swa_ops.BWD_LAUNCHES.reset()
    first = swa_ops.swa_backward(q, k, v, o32, lse, dout, window=300)
    second = swa_ops.swa_backward(q, k, v, o32, lse, dout, window=300)
    assert swa_ops.BWD_LAUNCHES.value == 2
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_inference_launches_no_backward_and_writes_no_lse(cuda,
                                                              monkeypatch):
    """Serving's route (inference mode) launches the forward kernels only,
    as before training existed, and asks the swa kernel for neither lse
    nor its fp32 output (``swa_cuda``'s with_lse and out32)."""
    from repro_torch.kernels.lru_scan.ops import lru_scan
    from repro_torch.kernels.swa import ops as swa_ops
    asked = []
    real = swa_ops.swa_cuda
    monkeypatch.setattr(swa_ops, "swa_cuda",
                        lambda *a: asked.append((a[4], a[6])) or real(*a))
    counters = launch_counters()
    for c in counters.values():
        c.reset()
    g = torch.Generator().manual_seed(4)
    q = torch.randn(1, 2, 64, 32, generator=g).to(cuda, torch.bfloat16)
    a = torch.rand(1, 64, 32, generator=g).to(cuda)
    with torch.inference_mode():
        swa_ops.swa_attention(q, q, q, window=16)
        lru_scan(a, a, torch.zeros(1, 32, device=cuda))
    assert asked == [(False, None)]
    assert {k: c.value for k, c in counters.items() if c.value} == \
        {"swa": 1, "lru_scan": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("h,kh", [(4, 4), (8, 2), (14, 2)],
                         ids=["group1", "group4", "group7"])
def test_cuda_swa_at_window_covering_seq_is_global_attention(
        cuda, dtype, tol, head_dim, h, kh):
    """The dense families' global layers: swa and swa_bwd with window = S
    (and past it) at head dims 64 and 128, GQA groups of 1, 4 and 7 (yi's
    56 heads over 8), on (B, S, H, D) views against their plain versions
    on fp32 copies, within tol of max |.|; in bf16 the gradients also
    within GRAD_RMS_TOL of their RMS."""
    from chip_smoke import GRAD_RMS_TOL, grad_rms_ratio
    from repro_torch.kernels.swa.ops import swa_attention, swa_backward, \
        swa_forward
    from repro_torch.kernels.swa.ref import swa_backward_ref, swa_ref
    g = torch.Generator().manual_seed(h + head_dim)
    for s, window in [(200, 200), (129, 1000)]:
        q = torch.randn(2, s, h, head_dim, generator=g).to(cuda, dtype)
        k, v = (torch.randn(2, s, kh, head_dim, generator=g).to(cuda, dtype)
                for _ in range(2))
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        want = swa_ref(q.float(), k.float(), v.float(), window)
        torch.testing.assert_close(
            swa_attention(q, k, v, window=window).float(), want, rtol=0,
            atol=tol * float(want.abs().max()))
        dout = torch.randn(2, h, s, head_dim, generator=g).to(cuda, dtype)
        _, lse, o32 = swa_forward(q, k, v, window, with_lse=True)
        got = swa_backward(q, k, v, o32, lse, dout, window=window)
        want = swa_backward_ref(q.float(), k.float(), v.float(), o32, lse,
                                dout.float(), window)
        for gg, w in zip(got, want):
            torch.testing.assert_close(gg.float(), w, rtol=0,
                                       atol=tol * float(w.abs().max()))
            if dtype == torch.bfloat16:
                assert grad_rms_ratio(gg, w) <= GRAD_RMS_TOL["bfloat16"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 3e-2)])
@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-v2-lite-16b",
                                  "paligemma-3b", "whisper-medium"])
def test_cuda_family_loss_and_gradients_equal_the_cpus(cuda, dtype, tol,
                                                       arch):
    """A reduced dense family (global attention through swa and swa_bwd),
    a reduced MLA + MoE family, the reduced prefix-VLM and the reduced
    encoder-decoder (swa_bwd with a prefix): the loss, the MoE aux and
    every parameter's gradient on the card equal the CPU's (by its norm),
    from the same parameters and batch."""
    import dataclasses
    from repro_torch.common.config import ShapeConfig
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.kernels.swa import ops as swa_ops
    from repro_torch.models.model import build_model
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.optim import master_params
    cfg = dataclasses.replace(get_reduced(arch), dtype=dtype)
    batch = SyntheticLM(cfg, ShapeConfig("t", 96, 2, "train"),
                        seed=5).batch(0)
    counters = launch_counters()
    for c in counters.values():
        c.reset()
    swa_ops.BWD_PREFIX_LAUNCHES.reset()
    res = {}
    for dev in ("cpu", cuda):
        model = build_model(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(11))
        model.to(dev)
        res[str(dev)] = value_and_grad(model, master_params(model),
                                       to_device(batch, dev),
                                       cast_params=True)
    (lc, mc, gc), (lg, mg, gg) = res["cpu"], res[str(cuda)]
    assert abs(float(lg) - float(lc)) <= tol * abs(float(lc))
    assert abs(float(mg["aux"]) - float(mc["aux"])) <= \
        tol * abs(float(mc["aux"]))
    assert (float(mg["aux"]) > 0) == (cfg.moe is not None)
    for k, w in gc.items():
        err = float(torch.linalg.norm(gg[k].cpu() - w))
        assert err <= tol * float(torch.linalg.norm(w)), k
    torch.cuda.synchronize()
    attention = cfg.moe is None
    assert (counters["swa"].value > 0) == attention
    assert (counters["swa_bwd"].value > 0) == attention
    prefix = bool(cfg.prefix_len or cfg.is_encdec)
    assert (swa_ops.BWD_PREFIX_LAUNCHES.value > 0) == prefix


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("head_dim", [32, 64, 128, 256])
def test_cuda_swa_with_a_prefix_matches_its_plain_version(cuda, dtype, tol,
                                                          head_dim):
    """The prefix-LM and encoder routes: swa at window = S with prefixes
    on and off the 64-key tile (1, 63, 64, 65, 100, 256) and prefix = S
    (bidirectional), S = 300 and 320, MQA and GQA, against the plain
    version on fp32 copies within tol of max |want|; bf16 also within
    the main shape's limit."""
    from chip_smoke import swa_excess
    from repro_torch.kernels.swa.ops import swa_attention
    from repro_torch.kernels.swa.ref import swa_ref
    g = torch.Generator().manual_seed(head_dim)
    for s, h, kh in [(300, 4, 1), (320, 8, 2)]:
        q = torch.randn(2, s, h, head_dim, generator=g).to(cuda, dtype)
        k, v = (torch.randn(2, s, kh, head_dim, generator=g).to(cuda, dtype)
                for _ in range(2))
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        for prefix in (1, 63, 64, 65, 100, 256, s):
            want = swa_ref(q.float(), k.float(), v.float(), s, prefix)
            with torch.inference_mode():
                got = swa_attention(q, k, v, window=s, prefix=prefix)
            torch.testing.assert_close(got.float(), want, rtol=0,
                                       atol=tol * float(want.abs().max()))
            if dtype == torch.bfloat16:
                assert swa_excess(got, want)[1] <= 1.0, prefix


#: the prefix sweep of the backward: (S, query heads, kv heads) as the
#: forward's, windows S (PaliGemma, Whisper's encoder) and 96 (the band's
#: lower edge crossing the prefix), prefixes on and off the 64-key tile
PREFIX_BWD_CASES = [(300, 4, 1), (320, 8, 2)]
PREFIX_BWD_PREFIXES = (1, 63, 64, 65, 100, 256)


def _prefix_backward_cases(cuda, dtype, head_dim, seed):
    """(q, k, v, dout, window, prefix) over PREFIX_BWD_CASES, windows S
    and 96 and prefixes PREFIX_BWD_PREFIXES and S, as (B, S, H, D)
    views."""
    g = torch.Generator().manual_seed(seed)
    for s, h, kh in PREFIX_BWD_CASES:
        q, dout = (torch.randn(2, s, h, head_dim, generator=g).to(
            cuda, dtype).transpose(1, 2) for _ in range(2))
        k, v = (torch.randn(2, s, kh, head_dim, generator=g).to(
            cuda, dtype).transpose(1, 2) for _ in range(2))
        for window in (s, 96):
            for prefix in PREFIX_BWD_PREFIXES + (s,):
                yield q, k, v, dout, window, prefix


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("head_dim", [64, 256])
def test_cuda_swa_backward_with_a_prefix_matches_its_plain_version(
        cuda, dtype, tol, head_dim):
    """ROADMAP B.7: swa_bwd with a bidirectional prefix, prefixes 1, 63,
    64, 65, 100, 256 and S at S = 300 (MQA) and 320 (GQA), windows S and
    96, against swa_backward_ref on fp32 copies: within tol of max |grad|
    and, in bf16, GRAD_RMS_TOL of RMS(grad), from the forward's fp32
    output (what training passes)."""
    from chip_smoke import GRAD_RMS_TOL, grad_rms_ratio
    from repro_torch.kernels.swa import ops as swa_ops
    from repro_torch.kernels.swa.ref import swa_backward_ref
    swa_ops.BWD_PREFIX_LAUNCHES.reset()
    n = 0
    for q, k, v, dout, window, prefix in _prefix_backward_cases(
            cuda, dtype, head_dim, head_dim):
        _, lse, o32 = swa_ops.swa_forward(q, k, v, window, with_lse=True,
                                          prefix=prefix)
        got = swa_ops.swa_backward(q, k, v, o32, lse, dout, window=window,
                                   prefix=prefix)
        want = swa_backward_ref(q.float(), k.float(), v.float(), o32, lse,
                                dout.float(), window, prefix)
        n += 1
        for name, gg, w, t in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
            what = (name, window, prefix)
            assert gg.dtype == dtype and gg.stride() == t.stride()
            err = float((gg.float() - w).abs().max())
            assert err <= tol * float(w.abs().max()), what
            if dtype == torch.bfloat16:
                assert grad_rms_ratio(gg, w) <= GRAD_RMS_TOL["bfloat16"], \
                    what
    torch.cuda.synchronize()
    assert swa_ops.BWD_PREFIX_LAUNCHES.value == n


@pytest.mark.cuda
def test_cuda_swa_backward_with_a_prefix_repeats_bit_for_bit(cuda):
    """Two launches of the bf16 backward with PaliGemma's mask shape (16
    query heads over one kv head, prefix 256 of 700 positions, window =
    S) give the same bits: the prefix adds no atomic sum."""
    from repro_torch.kernels.swa import ops as swa_ops
    g = torch.Generator().manual_seed(8)
    q, dout = (torch.randn(2, 700, 16, 256, generator=g).to(
        cuda, torch.bfloat16).transpose(1, 2) for _ in range(2))
    k, v = (torch.randn(2, 700, 1, 256, generator=g).to(
        cuda, torch.bfloat16).transpose(1, 2) for _ in range(2))
    _, lse, o32 = swa_ops.swa_forward(q, k, v, 700, with_lse=True,
                                      prefix=256)
    first = swa_ops.swa_backward(q, k, v, o32, lse, dout, window=700,
                                 prefix=256)
    second = swa_ops.swa_backward(q, k, v, o32, lse, dout, window=700,
                                  prefix=256)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_swa_function_with_a_prefix_runs_the_backward_kernel(
        cuda, monkeypatch):
    """Under autograd a prefix on CUDA tensors runs the forward kernel
    (writing lse and its fp32 output) and then the backward kernel with
    the prefix, whose gradient equals the plain backward's on fp32
    copies; no plain version runs on the card."""
    from chip_smoke import GRAD_RMS_TOL, grad_rms_ratio
    from repro_torch.kernels.swa import ops as swa_ops
    from repro_torch.kernels.swa.ref import swa_backward_ref, \
        swa_forward_ref

    def plain(*a):
        raise AssertionError("a plain version ran on CUDA tensors")
    for name in ("swa_ref", "swa_forward_ref", "swa_backward_ref"):
        monkeypatch.setattr(swa_ops, name, plain)
    g = torch.Generator().manual_seed(0)
    q, k, v, dout = (torch.randn(1, 2, 200, 64, generator=g).to(
        cuda, torch.bfloat16) for _ in range(4))
    for t in (q, k, v):
        t.requires_grad_()
    counters = launch_counters()
    for c in counters.values():
        c.reset()
    swa_ops.BWD_PREFIX_LAUNCHES.reset()
    swa_ops.swa_attention(q, k, v, window=200, prefix=40).backward(dout)
    torch.cuda.synchronize()
    assert counters["swa"].value == 1 and counters["swa_bwd"].value == 1
    assert swa_ops.BWD_PREFIX_LAUNCHES.value == 1
    qf, kf, vf = (t.detach().float() for t in (q, k, v))
    o, lse = swa_forward_ref(qf, kf, vf, 200, 40)
    want = swa_backward_ref(qf, kf, vf, o, lse, dout.float(), 200, 40)
    for t, w in zip((q, k, v), want):
        err = float((t.grad.float() - w).abs().max())
        assert err <= 3e-2 * float(w.abs().max())
        assert grad_rms_ratio(t.grad, w) <= GRAD_RMS_TOL["bfloat16"]
