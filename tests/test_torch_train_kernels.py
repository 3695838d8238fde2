"""The gradients of the port's two model kernels on the CPU, held against
the JAX package: the swa and lru_scan autograd Functions (their forward
and backward plain versions, which the CUDA kernels ``csrc/swa_bwd.cu``
and the reverse launch of ``csrc/lru_scan.cu`` repeat on the card) against
``jax.vjp`` of the JAX package's ``swa_ref`` and ``lru_scan_ref``, at the
JAX sweeps' shapes and the port's edges (GQA and MQA, S off the 32-row
tile, window >= S, a nonzero h0, bf16 operands). Also the routes: what
runs under autograd and what under ``torch.inference_mode``, and RG-LRU
and local attention layers' parameter gradients against the JAX layers'.
The card's half (the kernels themselves) is in tests/test_torch_cuda.py
and chip_smoke.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import ModelConfig as RefConfig
from repro.kernels.lru_scan.ref import lru_scan_ref as jax_lru_ref
from repro.kernels.swa.ref import swa_ref as jax_swa_ref
from repro.nn import attention as ref_attn
from repro.nn.core import init_params
from repro.nn.rglru import apply_rglru, rglru_spec
from repro_torch.common.config import ModelConfig
from repro_torch.kernels import launch_counters
from repro_torch.kernels.lru_scan import ops as lru_ops
from repro_torch.kernels.lru_scan.ops import LruScanFunction, lru_scan, \
    lru_scan_reverse
from repro_torch.kernels.lru_scan.ref import lru_scan_ref, \
    lru_scan_reverse_ref
from repro_torch.kernels.swa import ops as swa_ops
from repro_torch.kernels.swa.ops import SwaFunction, swa_attention, \
    swa_backward
from repro_torch.kernels.swa.ref import swa_forward_ref, swa_ref
from repro_torch.nn.attention import Attention
from repro_torch.nn.rglru import RGLRU


def _rel(got, want) -> float:
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(x, dtype=torch.float32, grad=True):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        dtype).requires_grad_(grad)


# ------------------------------------------------------------------- swa

SWA_CASES = [  # (B, H, K, S, D, window)
    (2, 4, 2, 128, 32, 32), (2, 4, 2, 256, 32, 96),      # the JAX sweep
    (2, 4, 2, 256, 32, 256), (2, 4, 2, 512, 32, 128),
    (2, 4, 2, 200, 32, 48),                              # S off the tile
    (2, 4, 1, 100, 32, 16),                              # MQA
    (1, 4, 2, 70, 16, 1000),                             # window >= S
    (2, 2, 2, 37, 8, 2),                                 # two keys a row
]


def _jax_swa_vjp(q, k, v, window, g):
    rep = q.shape[1] // k.shape[1]

    def f(q, k, v):
        return jax_swa_ref(q, jnp.repeat(k, rep, axis=1),
                           jnp.repeat(v, rep, axis=1), window)
    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return out, vjp(jnp.asarray(g))


@pytest.mark.parametrize("b,h,kh,s,d,window", SWA_CASES)
def test_swa_function_gradient_matches_jax_vjp(b, h, kh, s, d, window):
    rng = np.random.default_rng(s + window)
    q, k, v = (rng.standard_normal((b, n, s, d), dtype=np.float32)
               for n in (h, kh, kh))
    g = rng.standard_normal((b, h, s, d), dtype=np.float32)
    want, grads = _jax_swa_vjp(q, k, v, window, g)
    tq, tk, tv = _t(q), _t(k), _t(v)
    out = swa_attention(tq, tk, tv, window=window)
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__ == "SwaFunctionBackward"
    out.backward(torch.from_numpy(g))
    assert _rel(out, want) <= 2e-5
    for got, w in zip((tq.grad, tk.grad, tv.grad), grads):
        assert _rel(got, w) <= 1e-5


def test_swa_function_gradient_in_bf16_matches_jax_vjp():
    """bf16 operands: the backward runs in fp32 from them and rounds each
    gradient to bf16 once, within the JAX kernel tests' 3e-2."""
    b, h, kh, s, d, window = 2, 4, 1, 200, 32, 48
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((b, n, s, d), dtype=np.float32)
               for n in (h, kh, kh))
    g = rng.standard_normal((b, h, s, d), dtype=np.float32)
    rt = lambda x: np.asarray(torch.from_numpy(x).bfloat16().float())
    _, grads = _jax_swa_vjp(rt(q), rt(k), rt(v), window,
                            rt(g))
    tq, tk, tv = (_t(x, torch.bfloat16) for x in (q, k, v))
    out = swa_attention(tq, tk, tv, window=window)
    out.backward(torch.from_numpy(g).bfloat16())
    for got, w in zip((tq.grad, tk.grad, tv.grad), grads):
        assert got.dtype == torch.bfloat16
        assert _rel(got, w) <= 3e-2


def test_swa_forward_ref_writes_the_row_logsumexp():
    rng = np.random.default_rng(0)
    q, k = (torch.from_numpy(rng.standard_normal((1, n, 20, 8),
                                                 dtype=np.float32))
            for n in (2, 1))
    out, lse = swa_forward_ref(q, k, k, 5)
    torch.testing.assert_close(out, swa_ref(q, k, k, 5))
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k.expand(1, 2, 20, 8)) \
        * 8 ** -0.5
    i = torch.arange(20)
    band = (i[None] <= i[:, None]) & (i[None] > i[:, None] - 5)
    want = torch.logsumexp(scores.masked_fill(~band, -torch.inf), -1)
    torch.testing.assert_close(lse, want)


def test_swa_backward_wrapper_checks_its_operands():
    x = torch.randn(1, 2, 8, 16)
    lse = torch.randn(1, 2, 8)
    with pytest.raises(ValueError, match="lse"):
        swa_backward(x, x, x, x, lse[:, :, :4], x, window=4)
    with pytest.raises(ValueError, match="not q's"):
        swa_backward(x, x, x, x, lse, x[:, :, :4], window=4)
    with pytest.raises(TypeError, match="lse dtype"):
        swa_backward(x, x, x, x, lse.double(), x, window=4)
    dq, dk, dv = swa_backward(x, x, x, swa_ref(x, x, x, 4), lse, x,
                              window=4)
    assert dq.shape == dk.shape == dv.shape == x.shape


# -------------------------------------------------------------- lru_scan

LRU_CASES = [(2, 64, 128), (1, 100, 96), (3, 128, 512), (1, 1, 64),
             (3, 77, 100), (2, 300, 33)]


@jax.jit
def _jax_lru_vjp(a, x, h0, g):
    want, vjp = jax.vjp(jax_lru_ref, a, x, h0)
    return want, vjp(g)


@pytest.mark.parametrize("b,s,w", LRU_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
def test_lru_scan_function_gradient_matches_jax_vjp(b, s, w, dtype, tol):
    rng = np.random.default_rng(b + s + w)
    a = 1 / (1 + np.exp(-rng.standard_normal((b, s, w))))
    x = 0.1 * rng.standard_normal((b, s, w))
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    g = rng.standard_normal((b, s, w)).astype(np.float32)
    ta, tx = _t(a, dtype), _t(x, dtype)
    th0 = _t(h0)
    # the JAX package's oracle on the values the port's operands hold
    aj, xj = (jnp.asarray(t.detach().float().numpy()) for t in (ta, tx))
    want, grads = _jax_lru_vjp(aj, xj, jnp.asarray(h0), jnp.asarray(g))
    out = lru_scan(ta, tx, th0)
    assert type(out.grad_fn).__name__ == "LruScanFunctionBackward"
    out.backward(torch.from_numpy(g))
    assert _rel(out, want) <= max(tol, 1e-5)
    for got, w_, t in zip((ta.grad, tx.grad, th0.grad), grads, (ta, tx,
                                                                 th0)):
        assert got.dtype == t.dtype
        assert _rel(got, w_) <= tol


def test_lru_scan_reverse_is_the_flipped_recurrence():
    """y_t = a_{t+1} y_{t+1} + b_t, the carry entering unscaled:
    a = 0.5, b = 1 from the end, carry 16."""
    a = torch.full((1, 4, 2), 0.5)
    b = torch.ones((1, 4, 2))
    h0 = torch.full((1, 2), 16.0)
    got = lru_scan_reverse(a, b, h0)
    want = [1 + 0.5 * (1 + 0.5 * (1 + 0.5 * 17)), 1 + 0.5 * (1 + 0.5 * 17),
            1 + 0.5 * 17, 17.0]
    np.testing.assert_allclose(got[0, :, 0].numpy(), want, rtol=1e-6)
    # the plain version is the forward one on flipped, shifted inputs
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.random((2, 9, 5), dtype=np.float32))
            for _ in range(2))
    h0 = torch.from_numpy(rng.standard_normal((2, 5), dtype=np.float32))
    y = lru_scan_reverse_ref(a, b, h0)
    want = torch.empty_like(y)
    carry = h0
    for t in range(8, -1, -1):
        carry = b[:, t] + (carry if t == 8 else a[:, t + 1] * carry)
        want[:, t] = carry
    torch.testing.assert_close(y, want)


def test_lru_scan_function_skips_gradients_nobody_asked_for():
    a = torch.rand(1, 5, 4)
    b = torch.rand(1, 5, 4, requires_grad=True)
    h0 = torch.zeros(1, 4)
    lru_scan(a, b, h0).sum().backward()
    torch.testing.assert_close(
        b.grad, lru_scan_reverse_ref(a, torch.ones(1, 5, 4), h0))
    assert a.grad is None and h0.grad is None


# ----------------------------------------------------------------- routes

def test_inference_runs_the_forward_alone_and_autograd_the_functions(
        monkeypatch):
    """Serving's route (no grad) calls the plain forward the wrapper takes
    today and writes no log-sum-exp; a call that records a graph goes
    through the Functions, whose backward calls the backward plain
    versions. No CPU call launches a kernel."""
    counters = launch_counters()
    for c in counters.values():
        c.reset()
    calls = []

    def counting(name, fn):
        def wrapped(*args):
            calls.append(name)
            return fn(*args)
        return wrapped
    for mod, name in ((swa_ops, "swa_ref"), (swa_ops, "swa_forward_ref"),
                      (swa_ops, "swa_backward_ref"),
                      (lru_ops, "lru_scan_ref"),
                      (lru_ops, "lru_scan_reverse_ref")):
        monkeypatch.setattr(mod, name, counting(name, getattr(mod, name)))
    x = torch.randn(1, 2, 16, 32)
    a, h0 = torch.rand(1, 5, 8), torch.zeros(1, 8)
    with torch.inference_mode():
        swa_attention(x, x, x, window=4)
        lru_scan(a, a, h0)
    xg = x.clone().requires_grad_()
    ag = a.clone().requires_grad_()
    with torch.no_grad():
        swa_attention(xg, xg, xg, window=4)
    assert calls == ["swa_ref", "lru_scan_ref", "swa_ref"]
    calls.clear()
    out = swa_attention(xg, xg, xg, window=4)
    h = lru_scan(ag, ag, h0)
    assert isinstance(out.grad_fn, SwaFunction._backward_cls)
    assert isinstance(h.grad_fn, LruScanFunction._backward_cls)
    (out.sum() + h.sum()).backward()
    assert calls == ["swa_forward_ref", "lru_scan_ref", "lru_scan_reverse_ref",
                     "swa_backward_ref"]
    assert all(c.value == 0 for c in counters.values())


# ---------------------------------------------------------------- layers

B, S, D = 2, 20, 64
KEY = jax.random.PRNGKey(0)


def _layer_cfgs(**kw):
    base = dict(name="t", num_layers=2, d_model=D, num_heads=4,
                num_kv_heads=1, d_ff=128, vocab_size=100)
    base.update(kw)
    return RefConfig(**base), ModelConfig(**base)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _layer_grads_match(layer, params, ref_fn, x, args=(), kwargs=None):
    """Every parameter's gradient of sum(out * g), and the input's, in
    both packages on the same parameters, within 1e-5 of max |grad|."""
    g = np.random.default_rng(1).standard_normal(
        (B, S, D)).astype(np.float32)

    def loss(p, x):
        return jnp.sum(ref_fn(p, x) * g)
    want_p, want_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        params, jnp.asarray(x))
    tensors = {k: torch.from_numpy(v.copy()).requires_grad_()
               for k, v in _flat(params).items()}
    assert set(tensors) == {k for k, _ in layer.named_parameters()}
    xt = torch.from_numpy(x).requires_grad_()
    out, _ = torch.func.functional_call(layer, tensors, (xt, *args),
                                        kwargs or {})
    (out * torch.from_numpy(g)).sum().backward()
    flat_want = _flat(want_p)
    for k, t in tensors.items():
        assert _rel(t.grad, flat_want[k]) <= 1e-5, k
    assert _rel(xt.grad, want_x) <= 1e-5


def test_rglru_layer_gradients_match_the_jax_layer():
    cfg_j, cfg_p = _layer_cfgs(lru_width=D)
    params = init_params(rglru_spec(cfg_j), KEY)
    layer = RGLRU(cfg_p, generator=torch.Generator(), device="cpu")
    x = np.random.default_rng(0).standard_normal((B, S, D)).astype(
        np.float32)
    ref = functools.partial(apply_rglru, cfg=cfg_j,
                            compute_dtype=jnp.float32)
    _layer_grads_match(layer, params, lambda p, x: ref(p, x)[0], x,
                       kwargs={"compute_dtype": torch.float32})


def test_local_attention_layer_gradients_match_the_jax_layer():
    cfg_j, cfg_p = _layer_cfgs(sliding_window=8)
    params = init_params(ref_attn.attention_spec(cfg_j), KEY)
    layer = Attention(cfg_p, generator=torch.Generator(), device="cpu")
    x = np.random.default_rng(2).standard_normal((B, S, D)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    ref = functools.partial(ref_attn.apply_attention, cfg=cfg_j, window=8,
                            compute_dtype=jnp.float32)
    _layer_grads_match(layer, params,
                       lambda p, x: ref(p, x, jnp.asarray(pos))[0], x,
                       args=(torch.from_numpy(pos.copy()),),
                       kwargs={"window": 8, "compute_dtype": torch.float32})


def test_backward_check_needs_a_card():
    from repro_torch.launch import backward_check
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        backward_check.main([])
    with pytest.raises(SystemExit, match="needs cuda"):
        backward_check.main(["--device", "cpu"])
