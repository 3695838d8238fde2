"""The decoder-only text families of the port on the CPU — qwen3-4b (and
its sliding-window variant), yi-34b, codeqwen1.5-7b, stablelm-1.6b,
rwkv6-1.6b, deepseek-v2-lite-16b and deepseek-v2-236b — each at its
reduced configuration, held against the JAX package on the same
parameters, carried across with ``interop.lm_params_from_reference``:
the configurations equal, the forward logits, prefill + decode, and the
loss (nll and MoE aux) with every parameter's gradient against
``jax.value_and_grad``, at the tolerances tests/test_torch_lm.py and
tests/test_torch_train.py use for RecurrentGemma (1e-4 in fp32, 3e-2 in
bf16; gradients by their norm), on parameters that are the same in every
run (:func:`_init`). Also ``supports_shape`` against the JAX
package's answers, remat keeping the MoE aux, the route every prefill of
the dense families takes (the swa wrapper once per layer, global layers
with window = S) and the blocks of the new kinds."""
import dataclasses
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import ShapeConfig as RefShape
from repro.configs import ALL_ARCHS as REF_ALL_ARCHS, \
    ASSIGNED as REF_ASSIGNED, get_config as ref_get_config, \
    get_reduced as ref_get_reduced, shape_by_name as ref_shape_by_name, \
    supports_shape as ref_supports_shape
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models.model import DecoderLM as RefLM
from repro.nn.core import spec_map
from repro_torch import configs, interop
from repro_torch.common.config import BlockKind
from repro_torch.data.pipeline import to_device
from repro_torch.kernels.swa import ops as swa_ops
from repro_torch.models.blocks import Block, RWKVBlock
from repro_torch.models.model import DecoderLM
from repro_torch.train.loop import value_and_grad

FAMILIES = ["qwen3-4b", "qwen3-4b-sw", "yi-34b", "codeqwen1.5-7b",
            "stablelm-1.6b", "rwkv6-1.6b", "deepseek-v2-lite-16b",
            "deepseek-v2-236b"]
DENSE = ["qwen3-4b", "qwen3-4b-sw", "yi-34b", "codeqwen1.5-7b",
         "stablelm-1.6b"]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# the loss batch: 40 tokens, past qwen3-4b-sw's reduced window of 16
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
    a CRC of its path, where ``init_params`` folds Python's ``hash``: that
    hash is salted per process, so its parameters change from run to
    run."""
    return spec_map(lambda name, spec: spec.init(
        jax.random.fold_in(key, zlib.crc32(name.encode()) % 2 ** 31),
        spec.shape, spec.dtype), specs)


def _tokens(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", FAMILIES)
def test_configs_are_the_jax_packages(arch):
    assert _asdict(configs.get_reduced(arch)) == \
        _asdict(ref_get_reduced(arch))
    assert _asdict(configs.get_config(arch)) == \
        _asdict(ref_get_config(arch))


@pytest.mark.parametrize("arch", FAMILIES + ["recurrentgemma-9b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
def test_supports_shape_answers_as_the_jax_package(arch, shape):
    got = configs.supports_shape(configs.get_config(arch),
                                 configs.shape_by_name(shape))
    want = ref_supports_shape(ref_get_config(arch), ref_shape_by_name(shape))
    assert got == want
    assert dataclasses.astuple(configs.shape_by_name(shape)) == \
        dataclasses.astuple(ref_shape_by_name(shape))


def test_registry_lists_the_jax_packages_ids_but_two():
    """Since the prefix-VLM and the encoder-decoder were ported, every id
    of the JAX package, in its order."""
    assert configs.ASSIGNED == REF_ASSIGNED
    assert configs.ALL_ARCHS == REF_ALL_ARCHS
    assert set(FAMILIES) < set(configs.ALL_ARCHS)
    # the sub-quadratic families take long_500k, the others do not
    long = configs.shape_by_name("long_500k")
    assert [a for a in FAMILIES
            if configs.supports_shape(configs.get_config(a), long)] == \
        ["qwen3-4b-sw", "rwkv6-1.6b"]


# ------------------------------------------------------------------ model

@pytest.fixture(scope="module", params=[
    (arch, dtype) for arch in FAMILIES for dtype in ("float32",
                                                     "bfloat16")],
    ids=lambda p: f"{p[0]}-{p[1]}")
def lm(request):
    """(JAX model, its parameters, the port's model on the same
    parameters, tolerance) for a reduced family in one dtype."""
    arch, dtype = request.param
    ref = RefLM(dataclasses.replace(ref_get_reduced(arch), dtype=dtype))
    params = _init(ref.param_specs(), jax.random.PRNGKey(1))
    port = DecoderLM(dataclasses.replace(configs.get_reduced(arch),
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
    assert len(params["segments"]) == (2 if ref.cfg.moe else 1)
    if ref.cfg.moe:
        # segment 0 is the dense first layer, segment 1 the MoE layers
        assert "layers.0.ffn.up.w" in sd and "layers.1.ffn.gate_w" in sd
        np.testing.assert_array_equal(
            sd["layers.1.ffn.router.w"].numpy(),
            np.asarray(params["segments"][1]["b0"]["ffn"]["router"]["w"][0]))
    kinds = {layer.kind for layer in port.layers}
    assert kinds == set(ref.cfg.block_kinds())


def test_forward_matches_the_jax_model(lm):
    ref, params, port, tol = lm
    toks = _tokens(2, 2, 40)
    want = jax.jit(lambda p, t: ref._unembed(p, ref.forward(p, t)[0]))(
        params, jnp.asarray(toks))
    with torch.inference_mode():
        got = port.unembed(port(torch.from_numpy(toks))[0])
    assert got.dtype == port.compute_dtype and got.shape == (2, 40, 512)
    assert _rel(got, want) <= tol


def test_prefill_and_decode_match_the_jax_model(lm):
    """A 39-token prefill into caches sized 44 and one decode step."""
    ref, params, port, tol = lm
    toks = _tokens(3, 2, 40)
    logits, state = port.prefill(torch.from_numpy(toks[:, :-1]), seq_len=44)
    ref_logits, ref_state = jax.jit(
        functools.partial(ref.prefill, seq_len=44))(
        params, {"tokens": jnp.asarray(toks[:, :-1])})
    assert _rel(logits, ref_logits) <= tol
    logits, state = port.decode_step(state, torch.from_numpy(toks[:, -1:]))
    ref_logits, _ = jax.jit(ref.decode_step)(params, ref_state,
                                             jnp.asarray(toks[:, -1:]))
    assert _rel(logits, ref_logits) <= tol
    assert state.index == 40


def _jax_value_and_grad(ref, params, batch):
    return jax.jit(jax.value_and_grad(ref.loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})


def test_loss_and_every_parameter_gradient_match_the_jax_model(lm):
    """remat "full" (the reduced configs' default): the MoE aux comes out
    of each layer's checkpoint and is added to the loss. The loss, nll and
    aux within the tolerance; each parameter's gradient within the
    tolerance of its norm, the check the card makes against the CPU."""
    ref, params, port, tol = lm
    batch = RefSyntheticLM(ref.cfg, LOSS_SHAPE, seed=0,
                           bigram_q=0.9).batch(0)
    (loss, aux), grads = _jax_value_and_grad(ref, params, batch)
    masters = {k: v.clone().requires_grad_()
               for k, v in _carried(params).items()}
    assert port.cfg.remat == "full"
    tb = to_device(batch, "cpu")
    got_loss, metrics, got_grads = value_and_grad(port, masters, tb)
    for got, want in ((got_loss, loss), (metrics["nll"], aux["nll"]),
                      (metrics["aux"], aux["aux"])):
        assert abs(float(got) - float(want)) <= tol * abs(float(want))
    assert (float(metrics["aux"]) > 0) == bool(ref.cfg.moe)
    want_grads = _carried(grads)
    assert set(got_grads) == set(want_grads)
    assert all(g.dtype == torch.float32 for g in got_grads.values())
    for k, g in got_grads.items():
        assert float(torch.linalg.norm(g - want_grads[k])) <= \
            tol * float(torch.linalg.norm(want_grads[k])), k


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "deepseek-v2-lite-16b"])
def test_remat_keeps_the_loss_aux_and_gradients(arch):
    """remat "none" and "full" give the same loss, aux and gradients: the
    checkpoint hands the MoE aux out with the hidden state."""
    cfg = dataclasses.replace(configs.get_reduced(arch), dtype="float32")
    batch = to_device(RefSyntheticLM(cfg, LOSS_SHAPE, seed=1).batch(0),
                      "cpu")
    outs = []
    for remat in ("none", "full"):
        port = DecoderLM(dataclasses.replace(cfg, remat=remat),
                         device="cpu",
                         generator=torch.Generator().manual_seed(3))
        masters = {k: v.detach().clone().requires_grad_()
                   for k, v in port.state_dict().items()}
        outs.append(value_and_grad(port, masters, batch))
    (l0, m0, g0), (l1, m1, g1) = outs
    assert float(l0) == pytest.approx(float(l1), rel=1e-6)
    assert float(m0["aux"]) == pytest.approx(float(m1["aux"]), rel=1e-6)
    assert (float(m1["aux"]) > 0) == (arch != "rwkv6-1.6b")
    for k in g0:
        assert _rel(g1[k], g0[k]) <= 1e-5, k


# ------------------------------------------------------------------ routes

@pytest.mark.parametrize("arch", DENSE)
def test_dense_prefill_runs_every_layer_through_the_swa_wrapper(
        arch, monkeypatch):
    """Global layers take swa with window = S (causal attention), local
    ones their window: once per layer per prefill or full forward, never
    in decode."""
    calls = []

    def counting(q, k, v, window, prefix=0):
        assert prefix == 0
        calls.append(window)
        return plain(q, k, v, window, prefix)
    plain = swa_ops.swa_ref
    monkeypatch.setattr(swa_ops, "swa_ref", counting)
    cfg = dataclasses.replace(configs.get_reduced(arch), dtype="float32")
    port = DecoderLM(cfg, device="cpu", generator=torch.Generator())
    toks = torch.from_numpy(_tokens(4, 2, 20))
    _, state = port.prefill(toks, seq_len=24)
    want = cfg.sliding_window if cfg.sliding_window else 20
    assert calls == [want] * cfg.num_layers
    for _ in range(3):
        _, state = port.decode_step(state, toks[:, -1:])
    assert len(calls) == cfg.num_layers
    assert swa_ops.LAUNCHES.value == 0


def test_blocks_of_the_new_kinds_build():
    cfg = configs.get_reduced("deepseek-v2-236b")
    blk = Block(cfg, BlockKind.MLA, generator=torch.Generator(),
                device="cpu", use_moe=True)
    names = dict(blk.named_parameters())
    assert {"temporal.w_uq.w", "temporal.q_norm.scale", "ffn.router.w",
            "ffn.gate_w", "ffn.shared.up.w"} <= set(names)
    rwkv = RWKVBlock(configs.get_reduced("rwkv6-1.6b"),
                     generator=torch.Generator(), device="cpu")
    assert rwkv.kind == BlockKind.RWKV
    assert {"ln1.scale", "r.w", "w0", "ln_x_scale", "cm_k.w"} <= \
        {n for n, _ in rwkv.named_parameters()}
    with pytest.raises(ValueError, match="RWKVBlock"):
        Block(configs.get_reduced("rwkv6-1.6b"), BlockKind.RWKV,
              generator=torch.Generator(), device="cpu")
