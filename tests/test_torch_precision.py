"""The arithmetic plans of the port's tensor-core kernels, emulated in
plain PyTorch on the CPU and held to the limits the card is held to.

* normal_matvec (csrc/normal_matvec.cu) multiplies in 3xTF32: each fp32
  operand splits into hi = tf32(x) and lo = tf32(x - hi), TF32 being fp32
  with its 13 low mantissa bits cleared, and a b ~ a_hi b_hi + a_hi b_lo
  + a_lo b_hi. It must stay within the 3e-5 rule against the float64
  product, where one-pass TF32 must not.
* rf_map (csrc/rf_map.cu) forms X W the same way (two products for a bf16
  X), then adds b, takes cos and scales by sqrt(2/D). It must stay within
  the JAX tests' 1e-5 of the float64 map at their four shapes, where
  one-pass TF32 must not.
* swa's bf16 route (csrc/swa.cu) rounds the probabilities once to fp16
  for the product with v, which it takes to fp16 after a power-of-two
  scale per (batch, kv head), keeps the row sum in fp32, and rescales a
  running fp32 accumulator block by block (128 keys, 64 at D = 256). It
  must stay within chip_smoke.py's SWA_RTOL / SWA_ATOL_RMS limit at the
  main shape, both causal head dims, both prefix masks and v near bf16's
  largest and fp16's smallest normal values, where the limit must still
  reject a window one key short, a softmax scale 10 % high and a prefix
  one key short or none. Rounding p once to bf16 must not stay within it;
  the plan before (p split into bf16 hi = bf16(p) and lo = bf16(p - hi),
  P V twice) is kept beside it. Training's forward, which also writes
  its output in fp32 for the backward's D = rowsum(dO o), splits p into
  fp16 hi + lo: once-rounded p moves dQ over near-uniform attention.
* swa_bwd's bf16 route (csrc/swa_bwd.cu) keeps S, dP, D and every sum in
  fp32 and rounds P and dS once to bf16 as the A operands of dV = P^T dO,
  dQ = dS K and dK = dS^T Q, summed over 64-row tiles and, for dK and dV,
  over a kv head's query heads in up to four fp32 partials; the gradients
  are rounded to bf16 at the store. Against the float64 gradients it must
  stay within chip_smoke.py's GRAD_TOL and GRAD_RMS_TOL, and the RMS limit
  must reject a window one key short and a scale 10 % high.

No card, no kernel: these show that the plans, not the kernels, meet the
limits; tests/test_torch_cuda.py and chip_smoke.py hold the kernels to
the same limits on the card."""
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import GRAD_RMS_TOL, GRAD_TOL, grad_rms_ratio, swa_excess
from repro_torch.kernels.rf_map.ref import rf_weights
from repro_torch.kernels.swa.ref import swa_forward_ref, swa_ref
from repro_torch.kernels.swa.swa import kv_splits

NM_TOL = 3e-5          # chip_smoke.TOL["normal_matvec"]["float32"]
#: swa's fp16 plan scales max |v| of a (batch, kv head) into
#: [2^V16_TOP, 2^(V16_TOP + 1)) (csrc/swa.cu's constant of that name)
V16_TOP = 14
TF32_MASK = -(1 << 13)   # 0xffffe000 as a signed 32-bit pattern


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 with the 13 low mantissa bits cleared (what the tensor cores
    read of a TF32 operand)."""
    return (x.contiguous().view(torch.int32) & TF32_MASK).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor,
              exact_a: bool) -> torch.Tensor:
    """a @ b as the kernel forms it: three TF32 products summed in fp32, or
    two when a is exact in TF32 (a bf16 X)."""
    bh, bl = split(b)
    if exact_a:
        return a @ bl + a @ bh
    ah, al = split(a)
    return al @ bh + ah @ bl + ah @ bh


def nm_3xtf32(x: torch.Tensor, w: torch.Tensor, exact_x: bool):
    t = mm_3xtf32(x, w, exact_x)
    return mm_3xtf32(x.T, t, exact_x)


def nm_tf32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return tf32(x.T) @ tf32(tf32(x) @ tf32(w))


def within_rule(got: torch.Tensor, want: torch.Tensor) -> bool:
    """chip_smoke.close's rule: |got - want| <= tol (max|want| + |want|)."""
    err = (got.double() - want).abs()
    return bool((err <= NM_TOL * (want.abs().max() + want.abs())).all())


def _x_w(n, d, c, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((d, c), dtype=np.float32))
    return x.to(dtype).float(), w


@pytest.mark.parametrize("n,d,c", [(256, 64, 4), (300, 128, 1),
                                   (512, 440, 16), (1000, 37, 3),
                                   (130, 32, 2), (1000, 200, 147),
                                   (777, 256, 160)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_normal_matvec_3xtf32_meets_the_fp32_rule(n, d, c, dtype):
    x, w = _x_w(n, d, c, dtype)
    xd = x.double()
    want = xd.T @ (xd @ w.double())
    assert within_rule(nm_3xtf32(x, w, dtype == torch.bfloat16), want)


def test_normal_matvec_3xtf32_meets_the_rule_at_a_cg_slice():
    """8,192 rows of the CG shape (d = 10,000 random features, c = 147
    classes): one-pass TF32 misses the rule there, 3xTF32 keeps it."""
    x, w = _x_w(8_192, 10_000, 147, torch.float32, seed=1)
    xd = x.double()
    want = xd.T @ (xd @ w.double())
    del xd
    assert within_rule(nm_3xtf32(x, w, False), want)
    assert not within_rule(nm_tf32(x, w), want)


RF_TOL = 1e-5          # chip_smoke.TOL["rf_map"]["float32"], absolute
RF_SHAPES = [(256, 128, 256), (300, 70, 200), (512, 440, 1024),
             (100, 33, 77)]   # tests/test_kernels.py's rf_map shapes


def _rf_case(n, d, dd, dtype):
    """X standard normal (rounded to ``dtype``), W and b as the JAX tests
    draw them (bandwidth 2), and the float64 map of those values."""
    rng = np.random.default_rng(n + d + dd)
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32))
    x = x.to(dtype).float()
    w, b = (torch.from_numpy(v) for v in rf_weights(d, dd, 2.0, 1))
    want = torch.cos(x.double() @ w.double() + b.double()) * \
        math.sqrt(2.0 / dd)
    return x, w, b, want


def rf_plan(x, w, b, exact_x: bool, split_products: bool = True):
    """rf_map as the kernel forms it: X W in 3xTF32 (or one TF32 product),
    then + b, cos and the scale of the true D, in fp32."""
    t = mm_3xtf32(x, w, exact_x) if split_products else tf32(x) @ tf32(w)
    return torch.cos(t + b) * math.sqrt(2.0 / w.shape[1])


def within_rf_rule(got: torch.Tensor, want: torch.Tensor) -> bool:
    """chip_smoke.close's rule for rf_map: |got - want| <= tol (1 +
    |want|)."""
    err = (got.double() - want).abs()
    return bool((err <= RF_TOL * (1 + want.abs())).all())


@pytest.mark.parametrize("n,d,dd", RF_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rf_map_3xtf32_plan_meets_the_fp32_rule(n, d, dd, dtype):
    x, w, b, want = _rf_case(n, d, dd, dtype)
    assert within_rf_rule(rf_plan(x, w, b, dtype == torch.bfloat16), want)


@pytest.mark.parametrize("n,d,dd", RF_SHAPES)
def test_rf_map_one_pass_tf32_misses_the_rule(n, d, dd):
    """The reason for the split: one TF32 product misses 1e-5 at every JAX
    shape (the arguments of cos reach tens, and TF32 keeps 11 bits)."""
    x, w, b, want = _rf_case(n, d, dd, torch.float32)
    assert not within_rf_rule(rf_plan(x, w, b, False, split_products=False),
                              want)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def _band(s, window, prefix=0):
    pos = torch.arange(s)
    key, query = pos[None, :], pos[:, None]
    return ((key <= query) | ((key < prefix) & (query < prefix))) & \
        (key > query - window)


def v_scale_exponents(v: torch.Tensor) -> torch.Tensor:
    """The power-of-two exponent e per (batch, kv head) that the fp16 plan
    scales v by (csrc/swa.cu swa_v_half): from the biased exponent E of
    max |v|, e = V16_TOP + 127 - E clamped to [-126, 126], which puts max
    |v| 2^e in [2^V16_TOP, 2^(V16_TOP + 1)) and keeps 2^e and 2^-e normal
    fp32 values."""
    amax = v.float().abs().amax(dim=(-2, -1)).contiguous()
    biased = (amax.view(torch.int32) >> 23) & 0xFF
    return (V16_TOP + 127 - biased).clamp(-126, 126)


def swa_bf16_plan(q, k, v, window, split_p=True, block=64, prefix=0,
                  p_fp16=False, v_scale=True, p_fp16_lo=False,
                  fp32_out=False):
    """swa's bf16 route in plain torch: fp32 scores of bf16 inputs, an
    online softmax over ``block``-key blocks, the row sum kept in fp32,
    output rounded to bf16 (returned in fp32 before that rounding with
    ``fp32_out``: the kernel's o32). The product P V takes P as bf16 hi +
    lo parts (or, with ``split_p`` false, rounded once to bf16); with
    ``p_fp16``, P rounded once to fp16 (with ``p_fp16_lo`` as fp16 hi + lo
    parts, training's forward) against v scaled by 2^e per (batch, kv
    head) (:func:`v_scale_exponents`, or e = 0 without ``v_scale``) and
    taken to fp16, the output scaled back by 2^-e. q (B, H, S, D), k, v
    (B, K, S, D) bf16; ``prefix`` as swa_ref's."""
    b, h, s, d = q.shape
    kh = k.shape[1]
    qg = q.float().reshape(b, kh, h // kh, s, d)
    scores = torch.einsum("bkgqd,bktd->bkgqt", qg, k.float()) * d ** -0.5
    scores = scores.masked_fill(~_band(s, window, prefix), -torch.inf)
    vf = v.float()[:, :, None]
    e = v_scale_exponents(v) if v_scale else torch.zeros(b, kh,
                                                         dtype=torch.int32)
    e = e[:, :, None, None, None]
    if p_fp16:
        vf = torch.ldexp(vf, e).half().float()
    m = torch.full(scores.shape[:-1] + (1,), -torch.inf)
    ell = torch.zeros_like(m)
    acc = torch.zeros(b, kh, h // kh, s, d)
    for k0 in range(0, s, block):
        sc = scores[..., k0:k0 + block]
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        base = torch.where(m_new == -torch.inf, 0.0, m_new)
        alpha = torch.exp(m - base)
        p = torch.exp(sc - base)
        ell = alpha * ell + p.sum(-1, keepdim=True)
        vb = vf[..., k0:k0 + block, :]
        if p_fp16:
            hi = p.half().float()
            pv = hi @ vb
            if p_fp16_lo:
                pv = (p - hi).half().float() @ vb + pv
        else:
            hi = _bf16(p)
            pv = hi @ vb
            if split_p:
                pv = _bf16(p - hi) @ vb + pv
        acc = alpha * acc + pv
        m = m_new
    out = acc / ell
    if p_fp16:
        out = torch.ldexp(out, -e)
    out = out.reshape(b, h, s, d)
    return out if fp32_out else out.bfloat16()


def test_swa_bf16_plan_meets_the_main_shape_limit():
    """A reduced main shape (S 1,024, window 256, D 256, MQA): the plan
    passes chip_smoke.py's limit, P rounded once to bf16 does not, and the
    limit still rejects both planted faults."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, hh, 1024, 256), dtype=np.float32)).bfloat16()
        for hh in (4, 1, 1))
    qf, kf, vf = q.float(), k.float(), v.float()
    want = swa_ref(qf, kf, vf, 256)
    _, ratio = swa_excess(swa_bf16_plan(q, k, v, 256), want)
    assert ratio <= 1.0
    assert swa_excess(swa_bf16_plan(q, k, v, 256, split_p=False),
                      want)[1] > 1.0
    assert swa_excess(swa_ref(qf, kf, vf, 255).bfloat16(), want)[1] > 1.0
    assert swa_excess(swa_ref(qf * 1.1, kf, vf, 256).bfloat16(), want)[1] \
        > 1.0


def kernel_block(d: int) -> int:
    """Keys of one step of csrc/swa.cu's bf16 kernel: 64 at D = 256, else
    128."""
    return 64 if d == 256 else 128


def test_swa_bf16_plan_matches_the_kernel_contract_at_ragged_shapes():
    """S not a multiple of 64, GQA, window >= S: the block-wise plans (P
    split, and P in fp16 at the kernel's key block) are the same function
    as the plain version within the bf16 limit."""
    rng = np.random.default_rng(1)
    for s, window, h, kh, d in [(300, 100, 4, 2, 32), (200, 1000, 2, 1, 64),
                                (130, 1, 2, 2, 128)]:
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (2, hh, s, d), dtype=np.float32)).bfloat16()
            for hh in (h, kh, kh))
        want = swa_ref(q.float(), k.float(), v.float(), window)
        assert swa_excess(swa_bf16_plan(q, k, v, window), want)[1] <= 1.0
        assert swa_excess(swa_bf16_plan(q, k, v, window, p_fp16=True,
                                        block=kernel_block(d)),
                          want)[1] <= 1.0


def _plan_case(seed, b, h, kh, s, d, v_magnitude=None):
    """bf16 q, k, v from ``seed``; with ``v_magnitude``, v rescaled so
    that max |v| is that value."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (b, n, s, d), dtype=np.float32)) for n in (h, kh, kh))
    if v_magnitude is not None:
        v = v / v.abs().max() * v_magnitude
    return q.bfloat16(), k.bfloat16(), v.bfloat16()


@pytest.mark.parametrize("h,kh,s,d,window,prefix", [
    (4, 1, 1024, 256, 256, 0),    # the reduced main shape: MQA, window 256
    (8, 2, 1024, 128, 1024, 0),   # qwen3-4b's D = 128, GQA, causal
    (4, 4, 1024, 64, 1024, 0),    # stablelm's D = 64, causal
    (8, 1, 300, 256, 300, 256),   # PaliGemma's prefix mask, MQA
    (4, 4, 300, 64, 300, 300),    # Whisper's encoder: prefix = window = S
])
def test_swa_fp16_plan_meets_the_limit_and_sees_the_planted_faults(
        h, kh, s, d, window, prefix):
    """The plan csrc/swa.cu's bf16 kernel takes: P rounded once to fp16,
    v scaled by a power of two per (batch, kv head) and taken to fp16, so
    that P V is one fp16 product at the kernel's key block. It meets
    chip_smoke.py's SWA_RTOL / SWA_ATOL_RMS limit at the main shape, both
    causal head dims and both prefix masks, and the limit still rejects a
    softmax scale 10 % high, a window one key short (below S) and a
    prefix one key short or none."""
    q, k, v = _plan_case(7, 1, h, kh, s, d)
    qf, kf, vf = q.float(), k.float(), v.float()
    want = swa_ref(qf, kf, vf, window, prefix)
    got = swa_bf16_plan(q, k, v, window, block=kernel_block(d),
                        prefix=prefix, p_fp16=True)
    assert swa_excess(got, want)[1] <= 1.0
    faults = [swa_ref(qf * 1.1, kf, vf, window, prefix)]
    if window < s:
        faults.append(swa_ref(qf, kf, vf, window - 1, prefix))
    if prefix:
        faults += [swa_ref(qf, kf, vf, window, prefix - 1),
                   swa_ref(qf, kf, vf, window, 0)]
    for fault in faults:
        assert swa_excess(fault.bfloat16(), want)[1] > 1.0


@pytest.mark.parametrize("v_max", [
    3.0e38,       # near bf16's largest (3.39e38): unscaled fp16 overflows
    2.0 ** -14,   # fp16's smallest normal: most of v unscaled is subnormal
    2.0 ** -20,   # below it
])
def test_swa_fp16_plan_scale_keeps_extreme_v_within_the_limit(v_max):
    """The power-of-two scale puts every (batch, kv head)'s v into fp16's
    range before the product, so bf16 values keep their bits: the plan
    meets the limit with max |v| near bf16's largest and near or below
    fp16's smallest normal, where the same plan without the scale gives
    infinities or misses the limit. Both sides are compared after an
    exact power-of-two rescale, since the limit's RMS of values near
    3e38 overflows fp32."""
    q, k, v = _plan_case(5, 2, 4, 2, 512, 128, v_max)
    c = 2.0 ** -math.floor(math.log2(v_max))
    want = swa_ref(q.float(), k.float(), v.float(), 512) * c
    got = swa_bf16_plan(q, k, v, 512, block=128, p_fp16=True)
    assert swa_excess(got.float() * c, want)[1] <= 1.0
    unscaled = swa_bf16_plan(q, k, v, 512, block=128, p_fp16=True,
                             v_scale=False)
    assert swa_excess(unscaled.float() * c, want)[1] > 1.0


def test_swa_v_scale_exponents_reach_fp16_range_exactly():
    """2^e max |v| lands in [2^V16_TOP, 2^(V16_TOP + 1)) from bf16's
    largest magnitudes down to 2^-100 (the clamp of e to 126 binds only
    below 2^-112), and the scaled bf16 values are exact in fp16 down to
    2^-27 of the head's max."""
    for top in (3.0e38, 1.0, 2.0 ** -14, 2.0 ** -100):
        v = torch.tensor([top, top / 3, top * 2.0 ** -27]).bfloat16()
        e = v_scale_exponents(v.reshape(1, 1, 3, 1))
        scaled = torch.ldexp(v.float(), e.reshape(1))
        assert 2.0 ** V16_TOP <= float(scaled.abs().max()) \
            < 2.0 ** (V16_TOP + 1)
        assert torch.equal(scaled.half().float(), scaled)


def test_swa_kernel_takes_the_fp16_plan():
    """csrc/swa.cu's bf16 route is the plan these tests hold: its P V
    product is an fp16 wgmma with P from registers, v is scaled by the
    same V16_TOP, training's forward (o32 asked for) splits P into fp16
    hi + lo, and no bf16 split of P or mma.sync is left in it."""
    src = (Path(__file__).resolve().parent.parent / "src" / "repro_torch"
           / "csrc" / "swa.cu").read_text()
    assert f"constexpr int V16_TOP = {V16_TOP};" in src
    assert "wgmma_rs_f16" in src and "wgmma_ss_bf16" in src
    assert "hop::split_half2" in src
    assert "o32 != nullptr ? swa_wgmma_kernel<D, true>" in src
    assert "split_bf16" not in src and "mma_bf16" not in src


def test_training_forward_splits_p_in_fp16_for_the_backward():
    """Why training's forward splits P: the backward reads D = rowsum(dO
    o32) from the forward's fp32 output. Over near-uniform attention (an
    encoder's similar frames, prefix = window = S) P rounded once to fp16
    puts o32 9e-6 of its norm off and dQ a third further from the float64
    gradients than the exact fp32 output does; P split into fp16 hi + lo
    keeps o32 within 1e-6 and dQ where the exact output puts it."""
    def rel(g, w):
        return float(torch.linalg.norm(g.double() - w.double())
                     / torch.linalg.norm(w.double()))
    q, k, v, o32, lse, dout, _ = _prefix_case(4, 1, 4, 4, 300, 64, 300,
                                              300, similar=True)
    want = swa_bwd_f64(q, k, v, o32, lse, dout, 300, prefix=300)
    exact = swa_bwd_bf16_plan(q, k, v, o32, lse, dout, 300, prefix=300)[0]
    for lo in (True, False):
        o = swa_bf16_plan(q, k, v, 300, block=kernel_block(64), prefix=300,
                          p_fp16=True, p_fp16_lo=lo, fp32_out=True)
        dq = swa_bwd_bf16_plan(q, k, v, o, lse, dout, 300, prefix=300)[0]
        assert (rel(o, o32) < 1e-6) == lo
        assert (rel(dq, want[0]) <= 1.05 * rel(exact, want[0])) == lo


def swa_bwd_bf16_plan(q, k, v, o, lse, dout, window, scale=None, block=64,
                      prefix=0):
    """swa_bwd's bf16 route in plain torch: fp32 S and dP of bf16
    operands, P = exp(S scale - lse) over the band (and the bidirectional
    ``prefix``), D = rowsum(dO o) from ``o`` as given (bf16, or the
    forward's fp32 output, which training passes),
    dS = P (dP - D); P and dS rounded once to bf16 for their products;
    dQ summed over 64-key tiles, dK and dV over 64-query tiles and the
    heads of each split of a kv head's query heads (kv_splits), the
    splits' fp32 partials summed in order; gradients rounded to bf16.
    ``scale`` plants a wrong softmax scale (default D^-0.5)."""
    b, h, s, d = q.shape
    kh = k.shape[1]
    g = h // kh
    scale = d ** -0.5 if scale is None else scale
    qf = q.float().reshape(b, kh, g, s, d)
    gf = dout.float().reshape(b, kh, g, s, d)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    p = torch.exp(qf @ kf.transpose(-1, -2) * scale
                  - lse.reshape(b, kh, g, s, 1)) * _band(s, window, prefix)
    dvec = (gf * o.float().reshape(b, kh, g, s, d)).sum(-1, keepdim=True)
    ds = p * (gf @ vf.transpose(-1, -2) - dvec)
    p16, ds16 = _bf16(p), _bf16(ds)
    dq = torch.zeros(b, kh, g, s, d)
    for k0 in range(0, s, block):
        dq += ds16[..., k0:k0 + block] @ kf[..., k0:k0 + block, :]
    per = -(-g // kv_splits(g))
    dk, dv = torch.zeros(b, kh, s, d), torch.zeros(b, kh, s, d)
    for h0 in range(0, g, per):
        pk, pv = torch.zeros(b, kh, s, d), torch.zeros(b, kh, s, d)
        for hh in range(h0, min(h0 + per, g)):
            for q0 in range(0, s, block):
                rows = slice(q0, q0 + block)
                pk += ds16[:, :, hh, rows].transpose(-1, -2) @ \
                    qf[:, :, hh, rows]
                pv += p16[:, :, hh, rows].transpose(-1, -2) @ \
                    gf[:, :, hh, rows]
        dk += pk * scale
        dv += pv
    return ((dq * scale).reshape(b, h, s, d).bfloat16(), dk.bfloat16(),
            dv.bfloat16())


def swa_bwd_f64(q, k, v, o, lse, dout, window, prefix=0):
    """The exact gradients of the same formulas in float64, from the same
    bf16 operands, o and lse."""
    b, h, s, d = q.shape
    kh = k.shape[1]
    g = h // kh
    qf = q.double().reshape(b, kh, g, s, d)
    gf = dout.double().reshape(b, kh, g, s, d)
    kf, vf = k.double()[:, :, None], v.double()[:, :, None]
    p = torch.exp(qf @ kf.transpose(-1, -2) * d ** -0.5
                  - lse.double().reshape(b, kh, g, s, 1)) * _band(s, window,
                                                                 prefix)
    dvec = (gf * o.double().reshape(b, kh, g, s, d)).sum(-1, keepdim=True)
    ds = p * (gf @ vf.transpose(-1, -2) - dvec)
    return ((ds @ kf * d ** -0.5).reshape(b, h, s, d),
            (ds.transpose(-1, -2) @ qf).sum(2) * d ** -0.5,
            (p.transpose(-1, -2) @ gf).sum(2))


def _bwd_case(seed, b, h, kh, s, d, window):
    """bf16 q, k, v, dO (made with numpy from ``seed``), the forward's
    bf16 o and fp32 lse from the plain version."""
    rng = np.random.default_rng(seed)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(
        (b, n, s, d), dtype=np.float32)).bfloat16() for n in (h, kh, kh, h))
    o, lse = swa_forward_ref(q.float(), k.float(), v.float(), window)
    return q, k, v, o.bfloat16(), lse, dout


def _within_grad_limits(got, want) -> bool:
    return all(float((g.double() - w).abs().max())
               <= GRAD_TOL["bfloat16"] * float(w.abs().max())
               and grad_rms_ratio(g, w) <= GRAD_RMS_TOL["bfloat16"]
               for g, w in zip(got, want))


def test_swa_bwd_bf16_plan_meets_both_limits_and_sees_a_mask_fault():
    """A reduced training shape (S 1,024, window 512, D 256, MQA): the
    plan is within GRAD_TOL and GRAD_RMS_TOL of the float64 gradients,
    and GRAD_RMS_TOL rejects a window one key short and a scale 10 %
    high."""
    args = _bwd_case(0, 1, 2, 1, 1024, 256, 512)
    want = swa_bwd_f64(*args, 512)
    got = swa_bwd_bf16_plan(*args, 512)
    assert _within_grad_limits(got, want)
    # about half the limit: the margin the limit was set with
    assert max(grad_rms_ratio(g, w) for g, w in zip(got, want)) < \
        0.6 * GRAD_RMS_TOL["bfloat16"]
    for fault in (swa_bwd_bf16_plan(*args, 511),
                  swa_bwd_bf16_plan(*args, 512, scale=1.1 * 256 ** -0.5)):
        assert max(grad_rms_ratio(g, w) for g, w in zip(fault, want)) > \
            GRAD_RMS_TOL["bfloat16"]


def test_swa_bwd_rms_limit_sees_a_mask_fault_the_max_rule_misses():
    """At the training window (2,048 keys; S cut to 3,072, one head) a
    window one key short stays within GRAD_TOL in every gradient, and
    GRAD_RMS_TOL rejects it in every gradient, with the plan itself at
    under half the limit."""
    args = _bwd_case(2, 1, 1, 1, 3072, 256, 2048)
    want = swa_bwd_f64(*args, 2048)
    plan = swa_bwd_bf16_plan(*args, 2048)
    short = swa_bwd_bf16_plan(*args, 2047)
    assert _within_grad_limits(plan, want)
    for g, w in zip(short, want):
        assert float((g.double() - w).abs().max()) \
            <= GRAD_TOL["bfloat16"] * float(w.abs().max())
        assert grad_rms_ratio(g, w) > GRAD_RMS_TOL["bfloat16"]


@pytest.mark.parametrize("b,h,kh,s,d,window", [
    (2, 4, 2, 200, 32, 48),    # S off the 64-row tile, GQA, D = 32
    (1, 6, 1, 130, 32, 1000),  # window past S, 6 heads in 3 splits
    (2, 16, 1, 300, 64, 100),  # MQA in 4 splits
])
def test_swa_bwd_bf16_plan_meets_both_limits_at_ragged_shapes(b, h, kh, s,
                                                               d, window):
    args = _bwd_case(1, b, h, kh, s, d, window)
    assert _within_grad_limits(swa_bwd_bf16_plan(*args, window),
                               swa_bwd_f64(*args, window))


def _prefix_case(seed, b, h, kh, s, d, window, prefix, similar=False):
    """bf16 q, k, v, dO from ``seed`` (with ``similar``: k and v one
    shared row plus 10 % noise, q at 30 %, as over an encoder's similar
    frames, where attention is near uniform and dP - D nearly cancels),
    the forward's fp32 o and lse with the prefix, and o rounded to
    bf16."""
    rng = np.random.default_rng(seed)

    def rn(n):
        return torch.from_numpy(rng.standard_normal((b, n, s, d),
                                                    dtype=np.float32))
    q, k, v, dout = rn(h), rn(kh), rn(kh), rn(h)
    if similar:
        q = 0.3 * q
        k, v = (t[:, :, :1] + 0.1 * t for t in (k, v))
    q, k, v, dout = (t.bfloat16() for t in (q, k, v, dout))
    o32, lse = swa_forward_ref(q.float(), k.float(), v.float(), window,
                               prefix)
    return q, k, v, o32, lse, dout, o32.bfloat16()


@pytest.mark.parametrize("h,kh,s,d,window,prefix", [
    (8, 1, 300, 256, 300, 256),   # PaliGemma's mask, MQA
    (8, 1, 300, 256, 96, 100),    # the window's edge inside the prefix
    (4, 4, 300, 64, 300, 300),    # Whisper's encoder: prefix = window = S
    (8, 2, 320, 128, 320, 65),    # GQA, the prefix one past a 64-key tile
])
def test_swa_bwd_bf16_plan_with_a_prefix_meets_both_limits(h, kh, s, d,
                                                           window, prefix):
    """ROADMAP B.7: the tensor-core plan over the prefix mask, from the
    forward's fp32 output as training runs it, is within GRAD_TOL and
    GRAD_RMS_TOL of the float64 gradients, and the RMS limit rejects the
    plan with a prefix one key short and with none."""
    q, k, v, o32, lse, dout, _ = _prefix_case(3, 1, h, kh, s, d, window,
                                              prefix)
    args = (q, k, v, o32, lse, dout, window)
    want = swa_bwd_f64(*args, prefix=prefix)
    assert _within_grad_limits(swa_bwd_bf16_plan(*args, prefix=prefix),
                               want)
    for fault in (prefix - 1, 0):
        got = swa_bwd_bf16_plan(*args, prefix=fault)
        assert max(grad_rms_ratio(g, w) for g, w in zip(got, want)) > \
            GRAD_RMS_TOL["bfloat16"]


def test_d_from_the_bf16_output_fails_near_uniform_encoder_attention():
    """Why the bf16 forward hands its fp32 output to the backward: over
    similar frames (an encoder, prefix = window = S) D = rowsum(dO o) from
    the bf16 o puts dQ far past chip_smoke.py's TRAIN_CONSISTENCY_TOL (3e-2
    of the gradient's norm) from the float64 gradients, as it did on an
    NVIDIA H100 at whisper-medium's encoder (step 0: dQ 13-999 % of its
    norm from layer 1 on, PERF.md §6), while D from the fp32 o keeps every
    gradient within it. The plan's own rounding of dS to bf16 is what is
    left in dQ there (under 2 % here, 2.8 % at the card's deepest
    layer): dQ = scale sum_j dS_j k_j sums to nearly nothing over similar
    keys."""
    from chip_smoke import TRAIN_CONSISTENCY_TOL
    tol = TRAIN_CONSISTENCY_TOL["bfloat16"]

    def rel(g, w):
        return float(torch.linalg.norm(g.double() - w)
                     / torch.linalg.norm(w))
    q, k, v, o32, lse, dout, o16 = _prefix_case(4, 1, 4, 4, 300, 64, 300,
                                                300, similar=True)
    want = swa_bwd_f64(q, k, v, o32, lse, dout, 300, prefix=300)
    fp32_o = swa_bwd_bf16_plan(q, k, v, o32, lse, dout, 300, prefix=300)
    bf16_o = swa_bwd_bf16_plan(q, k, v, o16, lse, dout, 300, prefix=300)
    assert all(rel(g, w) <= tol for g, w in zip(fp32_o, want))
    assert rel(bf16_o[0], want[0]) > 10 * tol
