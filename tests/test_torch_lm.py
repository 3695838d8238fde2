"""The port's serving slice on the CPU — RecurrentGemma's layers, the
reduced RecurrentGemma-9B and the serving engine — held against the JAX
package on the same parameters, carried across with
``interop.lm_params_from_reference``: layers at the 2e-5 of
tests/test_nn_layers.py, logits at 1e-4 in fp32 and 3e-2 in bf16, served
tokens equal. Also the routes the model takes (the swa and lru_scan
wrappers once per layer per prefill, never in decode). The prefix-VLM and
the encoder-decoder are tests/test_torch_modalities.py's."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import ModelConfig as RefConfig
from repro.configs import get_config as ref_get_config, \
    get_reduced as ref_get_reduced
from repro.models.model import DecoderLM as RefLM
from repro.nn import attention as ref_attn
from repro.nn.core import init_params
from repro.nn.rglru import RGLRUCache as RefRGLRUCache, apply_rglru, \
    rglru_spec
from repro.serve.engine import Request as RefRequest, \
    ServingEngine as RefEngine
from repro_torch import configs, interop
from repro_torch.common.config import BlockKind, ModelConfig
from repro_torch.kernels.lru_scan import ops as lru_ops
from repro_torch.kernels.swa import ops as swa_ops
from repro_torch.launch import profile_serve, serve as launch_serve
from repro_torch.models.model import DecoderLM
from repro_torch.nn.attention import Attention, KVCache
from repro_torch.nn.rglru import RGLRU, RGLRUCache
from repro_torch.serve.engine import Request, ServingEngine

ARCH = "recurrentgemma-9b"
B, S, D = 2, 16, 64
KEY = jax.random.PRNGKey(0)
X = np.random.default_rng(0).standard_normal((B, S, D)).astype(np.float32)
POS = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))


def _layer_cfgs(**kw):
    base = dict(name="t", num_layers=2, d_model=D, num_heads=4,
                num_kv_heads=2, d_ff=128, vocab_size=100)
    base.update(kw)
    return RefConfig(**base), ModelConfig(**base)


def _flat(tree, prefix=""):
    """A nested parameter dict as a state dict of fp32 CPU tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = torch.from_numpy(np.array(v))
    return out


def _np(x):
    return np.asarray(interop.tensor_to_host(x) if isinstance(
        x, torch.Tensor) else x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------- layers

def test_rglru_forward_and_decode_match_the_jax_layer():
    cfg_j, cfg_p = _layer_cfgs(lru_width=D)
    params = init_params(rglru_spec(cfg_j), KEY)
    layer = RGLRU(cfg_p, generator=torch.Generator(), device="cpu")
    layer.load_state_dict(_flat(params))
    x = torch.from_numpy(X)
    f32 = dict(compute_dtype=torch.float32)
    full, _ = layer(x, **f32)
    ref_apply = jax.jit(functools.partial(apply_rglru, cfg=cfg_j,
                                          compute_dtype=jnp.float32))
    want, _ = ref_apply(params, jnp.asarray(X))
    _close(full, want, 2e-5)

    cache = RGLRUCache(h=torch.zeros(B, D), conv=torch.zeros(B, 3, D))
    _, cache = layer(x[:, :S - 1], cache=cache, **f32)
    out, _ = layer(x[:, S - 1:], cache=cache, **f32)
    ref_cache = RefRGLRUCache(h=jnp.zeros((B, D)), conv=jnp.zeros((B, 3, D)))
    _, ref_cache = ref_apply(params, jnp.asarray(X[:, :S - 1]),
                             cache=ref_cache)
    ref_out, _ = ref_apply(params, jnp.asarray(X[:, S - 1:]),
                           cache=ref_cache)
    _close(out, ref_out, 2e-5)
    _close(out[:, 0], full[:, -1], 2e-5)


@pytest.mark.parametrize("window,qk_norm", [(8, False), (0, True)])
def test_attention_forward_and_decode_match_the_jax_layer(window, qk_norm):
    """Local attention (the swa route, and a ring cache of 8 slots written
    by a 15-token prefill) and global attention with qk-norm (the swa
    route with window = S)."""
    cfg_j, cfg_p = _layer_cfgs(sliding_window=window, qk_norm=qk_norm)
    params = init_params(ref_attn.attention_spec(cfg_j), KEY)
    layer = Attention(cfg_p, generator=torch.Generator(), device="cpu")
    layer.load_state_dict(_flat(params))
    x, pos = torch.from_numpy(X), torch.from_numpy(POS.copy())
    kw = dict(window=window, compute_dtype=torch.float32)
    full, _ = layer(x, pos, **kw)
    ref_apply = jax.jit(functools.partial(
        ref_attn.apply_attention, cfg=cfg_j, window=window,
        compute_dtype=jnp.float32))
    want, _ = ref_apply(params, jnp.asarray(X), jnp.asarray(POS))
    _close(full, want, 2e-5)

    t = window or S
    cache = KVCache(k=torch.zeros(B, t, 2, 16), v=torch.zeros(B, t, 2, 16))
    _, cache = layer(x[:, :S - 1], pos[:, :S - 1], cache=cache, **kw)
    ref_cache = ref_attn.KVCache(k=jnp.zeros((B, t, 2, 16)),
                                 v=jnp.zeros((B, t, 2, 16)))
    _, ref_cache = ref_apply(params, jnp.asarray(X[:, :S - 1]),
                             jnp.asarray(POS[:, :S - 1]), cache=ref_cache)
    _close(cache.k, ref_cache.k, 2e-5)
    _close(cache.v, ref_cache.v, 2e-5)
    out, _ = layer(x[:, S - 1:], pos[:, S - 1:], cache=cache,
                   cache_index=S - 1, **kw)
    ref_out, _ = ref_apply(params, jnp.asarray(X[:, S - 1:]),
                           jnp.asarray(POS[:, S - 1:]), cache=ref_cache,
                           cache_index=jnp.int32(S - 1))
    _close(out, ref_out, 2e-5)
    _close(out[:, 0], full[:, -1], 2e-5)


# ----------------------------------------------------------------- model

@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def lm(request):
    """(JAX model, its parameters, the port's model on the same
    parameters, logit tolerance) for the reduced RecurrentGemma."""
    dtype = request.param
    ref = RefLM(dataclasses.replace(ref_get_reduced(ARCH), dtype=dtype))
    params = init_params(ref.param_specs(), jax.random.PRNGKey(1))
    port = DecoderLM(dataclasses.replace(configs.get_reduced(ARCH),
                                         dtype=dtype), device="cpu",
                     generator=torch.Generator())
    port.load_state_dict(interop.lm_params_from_reference(
        jax.tree.map(np.asarray, params), "cpu"))
    return ref, params, port, (1e-4 if dtype == "float32" else 3e-2)


def _tokens(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def test_parameters_carry_across_by_rename_and_unstack(lm):
    ref, params, port, _ = lm
    sd = interop.lm_params_from_reference(jax.tree.map(np.asarray, params),
                                          "cpu")
    assert set(sd) == set(port.state_dict())
    kinds = [layer.kind for layer in port.layers]
    assert kinds == [BlockKind.RECURRENT, BlockKind.RECURRENT,
                     BlockKind.LOCAL_ATTENTION]
    np.testing.assert_array_equal(
        sd["layers.2.temporal.q.w"].numpy(),
        np.asarray(params["segments"][0]["b2"]["temporal"]["q"]["w"][0]))


def test_forward_matches_the_jax_model(lm):
    ref, params, port, tol = lm
    toks = _tokens(2, 2, 40)
    want = jax.jit(lambda p, t: ref._unembed(p, ref.forward(p, t)[0]))(
        params, jnp.asarray(toks))
    with torch.inference_mode():
        got = port.unembed(port(torch.from_numpy(toks))[0])
    assert got.dtype == port.compute_dtype and got.shape == (2, 40, 512)
    _close(got, want, tol)


def test_prefill_and_decode_match_the_jax_model(lm):
    """A 39-token prefill (past the window of 16: the ring cache is
    written) and one decode step."""
    ref, params, port, tol = lm
    toks = _tokens(3, 2, 40)
    logits, state = port.prefill(torch.from_numpy(toks[:, :-1]), seq_len=44)
    ref_logits, ref_state = jax.jit(
        functools.partial(ref.prefill, seq_len=44))(
        params, {"tokens": jnp.asarray(toks[:, :-1])})
    _close(logits, ref_logits, tol)
    logits, state = port.decode_step(state, torch.from_numpy(toks[:, -1:]))
    ref_logits, _ = jax.jit(ref.decode_step)(params, ref_state,
                                             jnp.asarray(toks[:, -1:]))
    _close(logits, ref_logits, tol)
    assert state.index == 40


def _count_plain_calls(monkeypatch) -> dict:
    """Wrap the plain versions the wrappers take for CPU tensors so that
    every routed call is counted: {"swa": n, "lru_scan": n}."""
    calls = {"swa": 0, "lru_scan": 0}

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped
    monkeypatch.setattr(swa_ops, "swa_ref", counting("swa", swa_ops.swa_ref))
    monkeypatch.setattr(lru_ops, "lru_scan_ref",
                        counting("lru_scan", lru_ops.lru_scan_ref))
    return calls


def test_model_routes_prefill_through_the_kernels_and_decode_through_none(
        lm, monkeypatch):
    _, _, port, _ = lm
    calls = _count_plain_calls(monkeypatch)
    swa_ops.LAUNCHES.reset()
    lru_ops.LAUNCHES.reset()
    toks = torch.from_numpy(_tokens(4, 2, 20))
    _, state = port.prefill(toks, seq_len=24)
    assert calls == {"swa": 1, "lru_scan": 2}
    for _ in range(3):
        _, state = port.decode_step(state, toks[:, -1:])
    assert calls == {"swa": 1, "lru_scan": 2}
    with torch.inference_mode():
        port(toks)
    assert calls == {"swa": 2, "lru_scan": 4}
    assert swa_ops.LAUNCHES.value == lru_ops.LAUNCHES.value == 0


# --------------------------------------------------------------- serving

PROMPT_LENS = (5, 9, 3, 40)     # the last wave holds a prompt past window


def test_serving_engine_matches_the_jax_engine():
    """The traffic of test_train_serve's engine test (prompts of 5, 9 and
    3 tokens, 4 new tokens, 2 slots) plus a 40-token prompt, on the
    reduced RecurrentGemma in fp32: the same tokens and stats."""
    ref = RefLM(dataclasses.replace(ref_get_reduced(ARCH), dtype="float32"))
    params = init_params(ref.param_specs(), jax.random.PRNGKey(2))
    port = DecoderLM(dataclasses.replace(configs.get_reduced(ARCH),
                                         dtype="float32"), device="cpu",
                     generator=torch.Generator())
    port.load_state_dict(interop.lm_params_from_reference(
        jax.tree.map(np.asarray, params), "cpu"))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 512, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    ref_eng = RefEngine(ref, params, max_batch=2)
    eng = ServingEngine(port, max_batch=2)
    for p in prompts:
        ref_eng.submit(RefRequest(prompt=p, max_new_tokens=4))
        eng.submit(Request(prompt=p, max_new_tokens=4))
    want = [r.out_tokens for r in ref_eng.run()]
    got = [r.out_tokens for r in eng.run()]
    assert got == want and all(len(t) == 4 for t in got)
    for key in ("prefills", "decode_steps", "requests"):
        assert eng.stats[key] == ref_eng.stats[key]
    assert eng.stats["prefills"] == 2
    assert [w["prompt_len"] for w in eng.waves] == [9, 40]
    assert sum(w["new_tokens"] for w in eng.waves) == 16


def test_launch_serve_runs_on_the_cpu(capsys):
    launch_serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                       "--max-new", "2", "--max-batch", "2"])
    assert "3 requests, 6 tokens" in capsys.readouterr().out


def test_profile_serve_counts_overlapping_device_spans_once():
    spans = [("a", 0.0, 10.0), ("b", 5.0, 10.0), ("c", 30.0, 5.0),
             ("d", 31.0, 1.0)]
    assert profile_serve.busy_us(spans) == 20.0
    assert profile_serve.busy_us([]) == 0.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            profile_serve.main(["--arch", ARCH])


# ---------------------------------------------------------------- configs

def test_configs_are_the_jax_packages():
    pairs = ((configs.get_reduced(ARCH), ref_get_reduced(ARCH)),
             (configs.get_config(ARCH), ref_get_config(ARCH)))
    for port_cfg, ref_cfg in pairs:
        got = dataclasses.asdict(port_cfg)
        want = dataclasses.asdict(ref_cfg)
        for d in (got, want):
            d["block_pattern"] = [k.value for k in d["block_pattern"]]
            d["attention_kind"] = d["attention_kind"].value
        assert got == want
    assert configs.get_config(ARCH).num_layers == 38


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecoderLM(configs.get_reduced(ARCH))
