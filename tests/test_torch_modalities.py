"""The prefix-VLM (paligemma-3b) and the encoder-decoder (whisper-medium)
of the port on the CPU, held against the JAX package: the prefix-LM and
non-causal masks, ``swa_attention`` with a bidirectional prefix (and its
gradients against ``jax.vjp``), the sinusoidal positions, ``make_batch``
and ``SyntheticLM``'s modality fields, the encoder and cross-attention
parameters carried across, and the two reduced models — forward, prefill
+ decode, the loss with every parameter's gradient, and the serving
engine with modality extras — at the tolerances tests/test_torch_families.py
uses (1e-4 in fp32, 3e-2 in bf16; gradients by their norm). Also the
routes: every prefill of a prefix model and of the encoder goes through
the swa wrapper with its prefix, cross-attention through the plain
attention."""
import dataclasses
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import ShapeConfig as RefShape
from repro.configs import get_config as ref_get_config, \
    get_reduced as ref_get_reduced
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models import io as ref_io
from repro.models.model import build_model as ref_build_model
from repro.nn import attention as ref_attn
from repro.nn.core import spec_map
from repro.nn.rope import sinusoidal_positions as ref_sinusoidal
from repro.serve.engine import Request as RefRequest, \
    ServingEngine as RefEngine
from repro_torch import configs, interop
from repro_torch.common.config import ShapeConfig
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.kernels.swa import ops as swa_ops
from repro_torch.kernels.swa.ops import swa_attention
from repro_torch.launch import serve as launch_serve
from repro_torch.models import io
from repro_torch.models.model import DecoderLM, EncDecLM, build_model
from repro_torch.nn import attention
from repro_torch.nn.rope import sinusoidal_positions
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.train.loop import make_train_step, value_and_grad
from repro_torch.train.optim import adamw_init, master_params
from repro_torch.common.config import TrainConfig

ARCHS = ["paligemma-3b", "whisper-medium"]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
LOSS_SHAPE = RefShape("long", seq_len=40, global_batch=2, mode="train")


def _asdict(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d["block_pattern"] = [k.value for k in d["block_pattern"]]
    d["attention_kind"] = d["attention_kind"].value
    return d


def _np(x) -> np.ndarray:
    return np.asarray(interop.tensor_to_host(x) if isinstance(
        x, torch.Tensor) else x, np.float32)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _carried(tree) -> dict:
    return interop.lm_params_from_reference(
        jax.tree.map(lambda x: np.asarray(x, np.float32), tree), "cpu")


def _init(specs, key) -> dict:
    """The JAX package's ``init_params`` with each leaf's key folded from
    a CRC of its path (``init_params`` folds Python's salted ``hash``)."""
    return spec_map(lambda name, spec: spec.init(
        jax.random.fold_in(key, zlib.crc32(name.encode()) % 2 ** 31),
        spec.shape, spec.dtype), specs)


def _tokens(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def _extras(cfg, seed, b) -> dict:
    """A wave's modality inputs, fp32 numpy, as the launchers draw them."""
    return io.stub_extras(cfg, b, np.random.RandomState(seed))


# ------------------------------------------------------------------ masks

def _pos(s, b=1):
    return np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))


@pytest.mark.parametrize("causal,window,prefix_len", [
    (True, 0, 0), (True, 0, 4), (True, 3, 0), (True, 3, 5), (True, 0, 8),
    (False, 0, 0)])
def test_mask_is_the_jax_mask(causal, window, prefix_len):
    """The prefix clause OR-ed before the window clause is AND-ed; an
    empty cache slot (-1) never visible; every key when not causal."""
    q = _pos(8)
    kv = np.array([[0, 1, -1, 3, 4, 5, 6, 7]], np.int32)
    for kv_pos in (q, kv):
        want = ref_attn._mask(jnp.asarray(q), jnp.asarray(kv_pos),
                              causal=causal, window=window,
                              prefix_len=prefix_len)
        got = attention._mask(torch.from_numpy(q.copy()),
                              torch.from_numpy(kv_pos.copy()),
                              causal=causal, window=window,
                              prefix_len=prefix_len)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefix_mask_is_bidirectional_in_prefix():
    pos = torch.arange(8)[None]
    m = attention._mask(pos, pos, causal=True, prefix_len=4)[0, 0, 0].numpy()
    assert m[:4, :4].all()                    # prefix block: fully connected
    assert m[6, :7].all() and not m[6, 7]     # text: prefix + causal text
    assert not m[2, 5]                        # prefix does not see text


# -------------------------------------------------------------- swa prefix

def _jax_prefix_attention(q, k, v, window, prefix, causal=True):
    """The JAX package's multihead_attention over (B, S, H, D) inputs with
    the prefix-LM mask."""
    s = q.shape[1]
    pos = jnp.asarray(_pos(s, q.shape[0]))
    return ref_attn.multihead_attention(
        q, k, v, pos, pos, causal=causal, window=window, prefix_len=prefix)


S_RAGGED = 37


@pytest.mark.parametrize("prefix", [0, 1, 5, S_RAGGED])
@pytest.mark.parametrize("kh", [1, 2], ids=["mqa", "gqa"])
@pytest.mark.parametrize("window", [S_RAGGED, 4], ids=["global", "w4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swa_prefix_matches_the_jax_prefix_attention(prefix, kh, window,
                                                     dtype):
    rng = np.random.default_rng(prefix + 10 * kh + window)
    b, h, s, d = 2, 4, S_RAGGED, 32
    q, k, v = (rng.standard_normal((b, s, n, d)).astype(np.float32)
               for n in (h, kh, kh))
    jd = getattr(jnp, dtype)
    want = _jax_prefix_attention(*(jnp.asarray(x, jd) for x in (q, k, v)),
                                 window, prefix)
    tq, tk, tv = (interop.from_reference({"a": np.asarray(
        jnp.asarray(x, jd))}, "cpu")["a"] for x in (q, k, v))
    got = swa_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                        tv.transpose(1, 2), window=window,
                        prefix=prefix).transpose(1, 2)
    tol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_swa_with_prefix_s_is_the_encoders_bidirectional_attention():
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((2, 50, n, 16)).astype(np.float32)
               for n in (4, 4, 4))
    want = _jax_prefix_attention(*map(jnp.asarray, (q, k, v)), 0, 0,
                                 causal=False)
    got = swa_attention(*(torch.from_numpy(x).transpose(1, 2)
                          for x in (q, k, v)), window=50, prefix=50)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("prefix", [0, 1, 5, S_RAGGED])
@pytest.mark.parametrize("kh", [1, 2], ids=["mqa", "gqa"])
def test_swa_prefix_gradients_match_jax_vjp(prefix, kh):
    """On the CPU autograd runs the swa Function's plain forward and
    backward, which honour the prefix."""
    rng = np.random.default_rng(prefix + kh)
    b, h, s, d = 2, 4, S_RAGGED, 16
    q, k, v = (rng.standard_normal((b, s, n, d)).astype(np.float32)
               for n in (h, kh, kh))
    g = rng.standard_normal((b, s, h, d)).astype(np.float32)
    want, vjp = jax.vjp(functools.partial(_jax_prefix_attention, window=s,
                                          prefix=prefix),
                        *map(jnp.asarray, (q, k, v)))
    grads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = swa_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                        tv.transpose(1, 2), window=s,
                        prefix=prefix).transpose(1, 2)
    out.backward(torch.from_numpy(g))
    assert _rel(out, want) <= 2e-5
    for got, w in zip((tq.grad, tk.grad, tv.grad), grads):
        assert _rel(got, w) <= 1e-5


# --------------------------------------------------------------- positions

@pytest.mark.parametrize("seq,dim", [(16, 128), (1500, 1024), (7, 10)])
def test_sinusoidal_positions_are_the_jax_packages(seq, dim):
    """torch's and XLA's fp32 exp differ by an ulp on some frequencies, and
    position p multiplies that: within p ulps of 1 (seq * 2^-23)."""
    np.testing.assert_allclose(sinusoidal_positions(seq, dim).numpy(),
                               np.asarray(ref_sinusoidal(seq, dim)),
                               rtol=0, atol=max(seq, 16) * 2.0 ** -23)


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("arch", ARCHS + ["recurrentgemma-9b"])
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_make_batch_equals_the_jax_packages(arch, mode):
    shape = RefShape("smoke", seq_len=32, global_batch=2, mode=mode)
    want = ref_io.make_batch(ref_get_reduced(arch), shape, seed=3)
    got = io.make_batch(configs.get_reduced(arch),
                        ShapeConfig("smoke", 32, 2, mode), seed=3,
                        device="cpu")
    assert set(got) == set(want)
    for key, w in want.items():
        w = np.asarray(w)
        assert tuple(got[key].shape) == w.shape, key
        if key in ("tokens", "labels"):
            assert got[key].dtype == torch.int32
            np.testing.assert_array_equal(got[key].numpy(), w)
        else:
            assert got[key].dtype == torch.bfloat16
            np.testing.assert_array_equal(_np(got[key]), w.astype(np.float32))
    cfg = configs.get_reduced(arch)
    assert io.text_len(cfg, 32) == 32 - cfg.prefix_len


@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_batches_equal_the_jax_packages(arch):
    shape = RefShape("t", seq_len=24, global_batch=2, mode="train")
    want = RefSyntheticLM(ref_get_reduced(arch), shape, seed=4).batch(2)
    got = SyntheticLM(configs.get_reduced(arch),
                      ShapeConfig("t", 24, 2, "train"), seed=4).batch(2)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    cfg = configs.get_reduced(arch)
    assert got["tokens"].shape == (2, 24 - cfg.prefix_len)


# --------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_jax_packages(arch):
    assert _asdict(configs.get_reduced(arch)) == \
        _asdict(ref_get_reduced(arch))
    assert _asdict(configs.get_config(arch)) == \
        _asdict(ref_get_config(arch))


@pytest.mark.parametrize("arch", configs.ASSIGNED)
def test_every_assigned_id_builds_through_build_model(arch):
    cfg = configs.get_reduced(arch)
    model = build_model(cfg, device="cpu", generator=torch.Generator())
    assert type(model) is (EncDecLM if cfg.is_encdec else DecoderLM)
    assert len(model.layers) == cfg.num_layers


def test_build_model_picks_the_encoder_decoder():
    whisper = build_model(configs.get_reduced("whisper-medium"),
                          device="cpu")
    pali = build_model(configs.get_reduced("paligemma-3b"), device="cpu")
    assert type(whisper) is EncDecLM and type(pali) is DecoderLM
    assert len(whisper.encoder.blocks) == 2
    with pytest.raises(ValueError, match="no encoder"):
        EncDecLM(configs.get_reduced("paligemma-3b"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_model(configs.get_reduced("whisper-medium"))


# ------------------------------------------------------------------ model

@pytest.fixture(scope="module", params=[
    (arch, dtype) for arch in ARCHS for dtype in ("float32", "bfloat16")],
    ids=lambda p: f"{p[0]}-{p[1]}")
def lm(request):
    """(JAX model, its parameters, the port's model on the same
    parameters, tolerance) for a reduced model in one dtype."""
    arch, dtype = request.param
    ref = ref_build_model(dataclasses.replace(ref_get_reduced(arch),
                                              dtype=dtype))
    params = _init(ref.param_specs(), jax.random.PRNGKey(1))
    port = build_model(dataclasses.replace(configs.get_reduced(arch),
                                           dtype=dtype), device="cpu",
                       generator=torch.Generator())
    port.load_state_dict(interop.lm_params_from_reference(
        jax.tree.map(np.asarray, params), "cpu"))
    return ref, params, port, TOL[dtype]


def test_parameters_carry_across_by_rename_and_unstack(lm):
    ref, params, port, _ = lm
    sd = interop.lm_params_from_reference(jax.tree.map(np.asarray, params),
                                          "cpu")
    assert set(sd) == set(port.state_dict())
    if ref.cfg.is_encdec:
        np.testing.assert_array_equal(
            sd["encoder.blocks.1.self.k.w"].numpy(),
            np.asarray(params["encoder"]["blocks"]["self"]["k"]["w"][1]))
        np.testing.assert_array_equal(
            sd["layers.1.cross.v.w"].numpy(),
            np.asarray(params["segments"][0]["b0"]["cross"]["v"]["w"][1]))
        assert {"encoder.final_norm.scale", "encoder.final_norm.bias",
                "layers.0.norm_x.bias"} <= set(sd)
    else:
        assert not any(k.startswith("encoder.") for k in sd)


def _run_jax(ref, params, toks, extras):
    return jax.jit(lambda p, t, e: ref._unembed(
        p, ref.forward(p, t, **e)[0]))(params, jnp.asarray(toks),
                                       {k: jnp.asarray(v)
                                        for k, v in extras.items()})


def test_forward_matches_the_jax_model(lm):
    ref, params, port, tol = lm
    toks = _tokens(2, 2, 30)
    extras = _extras(ref.cfg, 5, 2)
    want = _run_jax(ref, params, toks, extras)
    with torch.inference_mode():
        got = port.unembed(port(torch.from_numpy(toks), **to_device(
            extras, "cpu"))[0])
    assert got.dtype == port.compute_dtype
    assert got.shape == (2, 30 + ref.cfg.prefix_len, 512)
    assert _rel(got, want) <= tol


def test_prefill_and_decode_match_the_jax_model(lm):
    """A 29-token prefill into caches with room for 5 more positions and
    one decode step, the extras given to prefill only."""
    ref, params, port, tol = lm
    toks = _tokens(3, 2, 30)
    extras = _extras(ref.cfg, 6, 2)
    seq_len = 29 + ref.cfg.prefix_len + 5
    logits, state = port.prefill(torch.from_numpy(toks[:, :-1]),
                                 seq_len=seq_len,
                                 **to_device(extras, "cpu"))
    ref_logits, ref_state = jax.jit(
        functools.partial(ref.prefill, seq_len=seq_len))(
        params, {"tokens": jnp.asarray(toks[:, :-1]),
                 **{k: jnp.asarray(v) for k, v in extras.items()}})
    assert _rel(logits, ref_logits) <= tol
    assert state.index == int(ref_state.index)
    logits, state = port.decode_step(state, torch.from_numpy(toks[:, -1:]))
    ref_logits, _ = jax.jit(ref.decode_step)(params, ref_state,
                                             jnp.asarray(toks[:, -1:]))
    assert _rel(logits, ref_logits) <= tol
    assert state.index == 30 + ref.cfg.prefix_len


def _jax_loss_and_grads(ref, params, batch, dtype=None):
    if dtype is not None:
        ref = ref_build_model(dataclasses.replace(ref.cfg, dtype=dtype))
    (loss, aux), grads = jax.jit(jax.value_and_grad(ref.loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return loss, aux, _carried(grads)


def test_loss_and_every_parameter_gradient_match_the_jax_model(lm):
    """remat "full": the encoder's and the decoder's layers run under
    checkpoints. The loss and nll within the tolerance; each parameter's
    gradient within the tolerance of its norm, in bf16 widened by the
    distance of the JAX package's own bf16 gradient from its fp32 one.
    At the reduced whisper the cross-attention's q, k and norm_x gradients
    nearly cancel over the 16 similar frames (sum_j dK_j = 0, and the
    frames' sinusoidal positions barely vary in the low frequencies), so
    bf16 rounding dominates them in both packages: the JAX package's bf16
    gradients are 2.5-3.6 % of their norm from its fp32 ones, the port's
    3.3-3.6 %, 3.2-3.9 % from each other."""
    ref, params, port, tol = lm
    batch = RefSyntheticLM(ref.cfg, LOSS_SHAPE, seed=0,
                           bigram_q=0.9).batch(0)
    loss, aux, want_grads = _jax_loss_and_grads(ref, params, batch)
    masters = {k: v.clone().requires_grad_()
               for k, v in _carried(params).items()}
    assert port.cfg.remat == "full"
    got_loss, metrics, got_grads = value_and_grad(
        port, masters, to_device(batch, "cpu"))
    for got, want in ((got_loss, loss), (metrics["nll"], aux["nll"])):
        assert abs(float(got) - float(want)) <= tol * abs(float(want))
    assert set(got_grads) == set(want_grads)
    own = {k: 0.0 for k in want_grads}
    if ref.cfg.dtype == "bfloat16":
        exact = _jax_loss_and_grads(ref, params, batch, "float32")[2]
        own = {k: float(torch.linalg.norm(g - exact[k]))
               for k, g in want_grads.items()}
    for k, g in got_grads.items():
        assert float(torch.linalg.norm(g - want_grads[k])) <= \
            tol * float(torch.linalg.norm(want_grads[k])) + own[k], k


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_decreases_under_training(arch):
    """A few AdamW steps on one repeated batch lower the loss (gradient
    flow through the prefix, the encoder and the cross-attention), as
    tests/test_models_smoke.py has it for the JAX package."""
    cfg = dataclasses.replace(configs.get_reduced(arch), dtype="float32")
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    batch = io.make_batch(cfg, ShapeConfig("smoke", 32, 2, "train"),
                          device="cpu")
    params = master_params(model)
    opt = adamw_init(params)
    step = make_train_step(model, TrainConfig(learning_rate=3e-3,
                                              warmup_steps=1,
                                              total_steps=10))
    losses = []
    for _ in range(5):
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


# --------------------------------------------------------------- serving

@pytest.mark.parametrize("arch", ARCHS)
def test_serving_with_modality_extras_matches_the_jax_engine(arch):
    """The JAX package's test_serving_with_modality_extras traffic (two
    6-token prompts, 3 new tokens, 2 slots) plus a wave of one, fp32: the
    same tokens and stats, the extras drawn per wave by ``extras_fn``."""
    cfg_j = dataclasses.replace(ref_get_reduced(arch), dtype="float32")
    ref = ref_build_model(cfg_j)
    params = _init(ref.param_specs(), jax.random.PRNGKey(0))
    port = build_model(dataclasses.replace(configs.get_reduced(arch),
                                           dtype="float32"), device="cpu",
                       generator=torch.Generator())
    port.load_state_dict(_carried(params))
    outs = []
    for engine, req in ((RefEngine(ref, params, max_batch=2), RefRequest),
                        (ServingEngine(port, max_batch=2), Request)):
        rng = np.random.RandomState(0)
        for n in (6, 6, 9):
            engine.submit(req(prompt=rng.randint(0, cfg_j.vocab_size, n)
                              .astype(np.int32), max_new_tokens=3))
        waves = iter(range(10))
        done = engine.run(extras_fn=lambda n: _extras(cfg_j, next(waves), n))
        outs.append(([r.out_tokens for r in done], engine.stats))
    (want, ref_stats), (got, stats) = outs
    assert got == want and all(len(t) == 3 for t in got)
    for key in ("prefills", "decode_steps", "requests"):
        assert stats[key] == ref_stats[key]


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_runs_on_the_cpu(arch, capsys):
    launch_serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                       "--max-new", "2", "--max-batch", "2"])
    assert "3 requests, 6 tokens" in capsys.readouterr().out


# ------------------------------------------------------------------ routes

def _count_routes(monkeypatch) -> dict:
    """Wrap the swa wrapper's plain version and the plain attention so
    that every call is recorded: swa as (S, window, prefix), the plain
    attention as whether it was causal."""
    calls = {"swa": [], "plain": []}
    swa_plain, mha = swa_ops.swa_ref, attention.multihead_attention

    def swa(q, k, v, window, prefix=0):
        calls["swa"].append((q.shape[2], window, prefix))
        return swa_plain(q, k, v, window, prefix)

    def plain(*args, causal=True, **kwargs):
        calls["plain"].append(causal)
        return mha(*args, causal=causal, **kwargs)
    monkeypatch.setattr(swa_ops, "swa_ref", swa)
    monkeypatch.setattr(attention, "multihead_attention", plain)
    return calls


def test_prefix_model_runs_every_layer_through_swa_with_its_prefix(
        monkeypatch):
    calls = _count_routes(monkeypatch)
    cfg = dataclasses.replace(configs.get_reduced("paligemma-3b"),
                              dtype="float32")
    port = build_model(cfg, device="cpu", generator=torch.Generator())
    toks = torch.from_numpy(_tokens(4, 2, 20))
    extras = to_device(_extras(cfg, 1, 2), "cpu")
    _, state = port.prefill(toks, seq_len=20 + cfg.prefix_len + 2, **extras)
    s = 20 + cfg.prefix_len
    assert calls == {"swa": [(s, s, cfg.prefix_len)] * cfg.num_layers,
                     "plain": []}
    for _ in range(2):
        _, state = port.decode_step(state, toks[:, -1:])
    assert len(calls["swa"]) == cfg.num_layers
    assert calls["plain"] == [True] * (2 * cfg.num_layers)
    assert swa_ops.LAUNCHES.value == 0


def test_encoder_runs_swa_with_prefix_s_and_cross_attention_runs_plain(
        monkeypatch):
    calls = _count_routes(monkeypatch)
    cfg = dataclasses.replace(configs.get_reduced("whisper-medium"),
                              dtype="float32")
    port = build_model(cfg, device="cpu", generator=torch.Generator())
    toks = torch.from_numpy(_tokens(5, 2, 12))
    t = cfg.encoder_seq
    _, state = port.prefill(toks, seq_len=14,
                            **to_device(_extras(cfg, 2, 2), "cpu"))
    assert calls["swa"] == [(t, t, t)] * cfg.encoder_layers + \
        [(12, 12, 0)] * cfg.num_layers
    assert calls["plain"] == [False] * cfg.num_layers
    _, state = port.decode_step(state, toks[:, -1:])
    assert len(calls["swa"]) == cfg.encoder_layers + cfg.num_layers
    # a decode step: the self cache (causal) and the cross cache per layer
    assert calls["plain"][cfg.num_layers:] == [True, False] * cfg.num_layers
    assert swa_ops.LAUNCHES.value == 0
