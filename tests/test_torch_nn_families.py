"""The port's RWKV6, MLA and MoE layers on the CPU, held against the JAX
package's ``nn/rwkv.py``, ``nn/mla.py`` and ``nn/moe.py`` on the same
parameters and inputs (numpy draws from a seed), in fp32: the mirrors of
tests/test_nn_layers.py's RWKV, MLA and MoE tests (each the property on
the port and parity with the JAX function), plus RWKV's chunked form
over whole chunks with the tail stepped against the JAX token scan, a
chunk of strong decays (the clipped exponents), and MoE with tokens
dropped past capacity, gradients included. Tolerances: the layer tests'
2e-5 for parity, and each mirrored test's own (1e-4 for RWKV's decode,
2e-4 for its chunked form against the scan)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import ModelConfig as RefConfig, \
    MoEConfig as RefMoEConfig
from repro.nn.core import init_params
from repro.nn.mla import MLACache as RefMLACache, apply_mla, mla_spec
from repro.nn.moe import moe_apply, moe_spec
from repro.nn.rwkv import RWKVCache as RefRWKVCache, apply_rwkv, rwkv_spec
from repro_torch import interop
from repro_torch.common.config import ModelConfig, MoEConfig
from repro_torch.nn import rwkv as rwkv_mod
from repro_torch.nn.mla import MLA, MLACache
from repro_torch.nn.moe import MoE, capacity, slots
from repro_torch.nn.rwkv import RWKV, RWKVCache

B, S, D = 2, 16, 64
KEY = jax.random.PRNGKey(0)
F32 = dict(compute_dtype=torch.float32)


def _x(s=S, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, s, D)).astype(np.float32)


def _pos(s=S):
    return np.broadcast_to(np.arange(s, dtype=np.int32)[None], (B, s))


def _cfgs(**kw):
    base = dict(name="t", num_layers=2, d_model=D, num_heads=4,
                num_kv_heads=2, d_ff=128, vocab_size=100)
    base.update(kw)
    moe = base.pop("moe", None)
    return (RefConfig(**base, moe=RefMoEConfig(**moe) if moe else None),
            ModelConfig(**base, moe=MoEConfig(**moe) if moe else None))


def _flat(tree, prefix=""):
    """A nested parameter dict as a state dict of fp32 CPU tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = torch.from_numpy(np.array(v))
    return out


def _layer(cls, cfg, params):
    layer = cls(cfg, generator=torch.Generator(), device="cpu")
    layer.load_state_dict(_flat(params))
    return layer


def _np(x):
    return np.asarray(interop.tensor_to_host(x) if isinstance(
        x, torch.Tensor) else x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# ------------------------------------------------------------------ RWKV6

def _rwkv(**kw):
    cfg_j, cfg_p = _cfgs(rwkv_head_dim=16, **kw)
    params = init_params(rwkv_spec(cfg_j), KEY)
    ref = jax.jit(functools.partial(apply_rwkv, cfg=cfg_j,
                                    compute_dtype=jnp.float32))
    return params, ref, _layer(RWKV, cfg_p, params)


def _rwkv_caches():
    return (RWKVCache(state=torch.zeros(B, 4, 16, 16),
                      last=torch.zeros(B, D), last_cm=torch.zeros(B, D)),
            RefRWKVCache(state=jnp.zeros((B, 4, 16, 16)),
                         last=jnp.zeros((B, D)), last_cm=jnp.zeros((B, D))))


def test_rwkv_decode_matches_full():
    params, ref, layer = _rwkv()
    x = _x()
    full, _ = layer(torch.from_numpy(x), **F32)
    _close(full, ref(params, jnp.asarray(x))[0], 2e-5)
    cache, ref_cache = _rwkv_caches()
    _, cache = layer(torch.from_numpy(x[:, :S - 1]), cache=cache, **F32)
    out, _ = layer(torch.from_numpy(x[:, S - 1:]), cache=cache, **F32)
    _, ref_cache = ref(params, jnp.asarray(x[:, :S - 1]), cache=ref_cache)
    for name in ("state", "last", "last_cm"):
        _close(getattr(cache, name), getattr(ref_cache, name), 2e-5)
    ref_out, _ = ref(params, jnp.asarray(x[:, S - 1:]), cache=ref_cache)
    _close(out, ref_out, 2e-5)
    _close(out[:, 0], full[:, -1], 1e-4)


def test_rwkv_chunked_matches_scan():
    """256 tokens run as two chunks; 255 as one chunk and 127 steps (the
    JAX package walks all 255): the same outputs at 2e-4, and each
    against the JAX layer."""
    params, ref, layer = _rwkv()
    x = _x(256, seed=1)
    y_chunked, _ = layer(torch.from_numpy(x), **F32)
    y_split, _ = layer(torch.from_numpy(x[:, :255]), **F32)
    _close(y_chunked[:, :255], y_split, 2e-4)
    _close(y_chunked, ref(params, jnp.asarray(x))[0], 2e-4)
    _close(y_split, ref(params, jnp.asarray(x[:, :255]))[0], 2e-4)


@pytest.mark.parametrize("s", [300, 129])
def test_rwkv_chunks_then_steps_the_tail_as_the_jax_scan(s, monkeypatch):
    """A prompt past whole chunks (2 chunks + 44 tokens, 1 chunk + 1):
    the port runs the chunked form over the chunks and steps the tail
    from their state, the JAX package walks every token; the outputs and
    the carried state agree at 2e-4, and the port stepped only the
    tail."""
    steps = []

    def counting(*args):
        steps.append(1)
        return wkv_step(*args)
    wkv_step = rwkv_mod.wkv_step
    monkeypatch.setattr(rwkv_mod, "wkv_step", counting)
    params, ref, layer = _rwkv()
    x = _x(s, seed=2)
    cache, ref_cache = _rwkv_caches()
    y, cache = layer(torch.from_numpy(x), cache=cache, **F32)
    assert len(steps) == s % rwkv_mod.CHUNK
    want, ref_cache = ref(params, jnp.asarray(x), cache=ref_cache)
    _close(y, want, 2e-4)
    _close(cache.state, ref_cache.state, 2e-4)


def test_rwkv_chunk_with_strong_decays_matches_the_scan():
    """Log-decays up to the clip (-exp(4) a token): a chunk's decays sum
    far past -120. The port's chunked form over 128 tokens against the
    JAX package's token scan (which it runs over 129) at 2e-4. The JAX
    package's own chunked form is not finite there: its centred factors,
    clipped to +-60, overflow on masked pairs (ROADMAP C, a fault of the
    reference)."""
    params, ref, layer = _rwkv()
    w0 = np.random.default_rng(3).uniform(0.0, 6.0, D).astype(np.float32)
    params = dict(params, w0=jnp.asarray(w0))
    with torch.no_grad():
        layer.w0.copy_(torch.from_numpy(w0))
    x = _x(129, seed=4)
    y, _ = layer(torch.from_numpy(x[:, :128]), **F32)
    assert bool(torch.isfinite(y).all())
    _close(y, ref(params, jnp.asarray(x))[0][:, :128], 2e-4)
    assert not bool(jnp.isfinite(ref(params, jnp.asarray(x[:, :128]))[0])
                    .all())


# -------------------------------------------------------------------- MLA

@pytest.mark.parametrize("q_lora", [0, 48])
def test_mla_absorbed_decode_matches_expanded(q_lora):
    cfg_j, cfg_p = _cfgs(num_kv_heads=4, kv_lora_rank=32,
                         q_lora_rank=q_lora, rope_head_dim=8,
                         nope_head_dim=16, v_head_dim=16)
    params = init_params(mla_spec(cfg_j), KEY)
    layer = _layer(MLA, cfg_p, params)
    ref = jax.jit(functools.partial(apply_mla, cfg=cfg_j,
                                    compute_dtype=jnp.float32))
    x, pos = _x(), _pos()
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos.copy())
    full, _ = layer(tx, tpos, **F32)
    _close(full, ref(params, jnp.asarray(x), jnp.asarray(pos))[0], 2e-5)

    cache = MLACache(c_kv=torch.zeros(B, S, 32), k_rope=torch.zeros(B, S, 8))
    _, cache = layer(tx[:, :S - 1], tpos[:, :S - 1], cache=cache, **F32)
    ref_cache = RefMLACache(c_kv=jnp.zeros((B, S, 32)),
                            k_rope=jnp.zeros((B, S, 8)))
    _, ref_cache = ref(params, jnp.asarray(x[:, :S - 1]),
                       jnp.asarray(pos[:, :S - 1]), cache=ref_cache)
    _close(cache.c_kv, ref_cache.c_kv, 2e-5)
    _close(cache.k_rope, ref_cache.k_rope, 2e-5)
    out, _ = layer(tx[:, S - 1:], tpos[:, S - 1:], cache=cache,
                   cache_index=S - 1, **F32)
    ref_out, _ = ref(params, jnp.asarray(x[:, S - 1:]),
                     jnp.asarray(pos[:, S - 1:]), cache=ref_cache,
                     cache_index=jnp.int32(S - 1))
    _close(out, ref_out, 2e-5)
    _close(out[:, 0], full[:, -1], 2e-5)


# -------------------------------------------------------------------- MoE

def _moe(**moe):
    cfg_j, cfg_p = _cfgs(moe=moe)
    params = init_params(moe_spec(cfg_j), KEY)
    return cfg_j, params, _layer(MoE, cfg_p, params)


def _moe_pair(cfg_j, params, layer, x):
    got = layer(torch.from_numpy(x), torch.float32)
    want = jax.jit(functools.partial(moe_apply, cfg=cfg_j,
                                     compute_dtype=jnp.float32))(
        params, jnp.asarray(x))
    _close(got[0], want[0], 2e-5)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=2e-5)
    return got


def test_moe_routes_and_balances():
    cfg_j, params, layer = _moe(num_experts=8, num_shared_experts=1,
                                top_k=2, expert_ff=32)
    x = _x()
    y, aux = _moe_pair(cfg_j, params, layer, x)
    assert y.shape == x.shape
    assert not bool(torch.isnan(y).any())
    assert float(aux) > 0


def test_moe_capacity_drops_are_bounded():
    """With capacity_factor >= 1 and uniform-ish routing, output magnitude
    should be comparable to a dense MLP's (no catastrophic drop)."""
    cfg_j, params, layer = _moe(num_experts=4, num_shared_experts=0,
                                top_k=2, expert_ff=32, capacity_factor=2.0)
    y, _ = _moe_pair(cfg_j, params, layer, _x())
    assert float(y.abs().mean()) > 1e-4


def test_moe_drops_past_capacity_as_the_jax_package():
    """capacity_factor 0.25: 8 slots an expert for 64 choices over 4
    experts, so pairs are dropped in token order. The output, the aux and
    every parameter's gradient (of sum(y * r) + aux) match the JAX
    package's at 2e-5; dropped pairs add nothing."""
    moe = dict(num_experts=4, num_shared_experts=1, top_k=2, expert_ff=32,
               capacity_factor=0.25)
    cfg_j, params, layer = _moe(**moe)
    x = _x()
    m = MoEConfig(**moe)
    cap = capacity(B * S, m)
    assert cap == 8
    _moe_pair(cfg_j, params, layer, x)

    tx = torch.from_numpy(x)
    with torch.no_grad():
        probs = torch.softmax(tx.reshape(-1, D) @ layer.router.w, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :2]
    dropped = int((slots(top, 4, cap) == 4 * cap).sum())
    loads = torch.bincount(top.reshape(-1), minlength=4)
    assert dropped == int((loads - cap).clamp_min(0).sum()) > 0

    r = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def ref_objective(p, xx):
        y, aux = moe_apply(p, xx, cfg_j, compute_dtype=jnp.float32)
        return jnp.sum(y * r) + aux
    want_gp, want_gx = jax.jit(jax.grad(ref_objective, argnums=(0, 1)))(
        params, jnp.asarray(x))
    tx = tx.clone().requires_grad_()
    for p in layer.parameters():
        p.requires_grad_()
    y, aux = layer(tx, torch.float32)
    names, tensors = zip(*layer.named_parameters())
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum() + aux,
                                (tx, *tensors))
    _close(grads[0], want_gx, 2e-5)
    want = _flat(want_gp)
    for name, g in zip(names, grads[1:]):
        scale = float(want[name].abs().max())
        np.testing.assert_allclose(_np(g), _np(want[name]), rtol=2e-5,
                                   atol=2e-5 * scale, err_msg=name)
