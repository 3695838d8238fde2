"""The port's training slice on the CPU — ``DecoderLM.loss``, the train
step and loop, AdamW and GaLore, checkpoints, the data pipeline, the
losses, the offloaded linear probe and ``launch.train`` — held against the
JAX package on the reduced RecurrentGemma-9B with the same parameters and
optimizer state, carried across by ``interop.lm_params_from_reference``
and ``interop.adamw_state_from_reference``: the loss and every parameter
gradient within 1e-4 of max |.| in fp32 and 3e-2 in bf16, batches bit
for bit. Also once-mirrors of the training tests of
tests/test_train_serve.py, tests/test_perf_features.py,
tests/test_system.py and tests/test_extensions.py, and the two
cross-entropy properties of tests/test_properties.py on fixed draws
(hypothesis is not needed)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import ShapeConfig as RefShape, \
    TrainConfig as RefTrainConfig
from repro.configs import get_reduced as ref_get_reduced
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models.model import DecoderLM as RefLM
from repro.nn.core import init_params
from repro.train import loop as ref_loop, optim as ref_optim
from repro.train.loss import \
    chunked_unembed_cross_entropy as ref_chunked_xent, \
    softmax_cross_entropy as ref_xent
from repro_torch import configs, interop
from repro_torch.common.config import ShapeConfig, TrainConfig
from repro_torch.common.pytree import cast_floating, global_norm
from repro_torch.core import AlchemistContext
from repro_torch.core.libraries import elemental, skylark
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.launch import train as launch_train
from repro_torch.models.model import DecoderLM
from repro_torch.train.checkpoint import restore_checkpoint, \
    save_checkpoint
from repro_torch.train.loop import make_train_step, train, value_and_grad
from repro_torch.train.loss import chunked_unembed_cross_entropy, \
    softmax_cross_entropy
from repro_torch.train.offload import extract_features, \
    fit_linear_head_cg, head_accuracy
from repro_torch.train.optim import GaLoreState, adamw_init, \
    adamw_update, eligible_for_galore, lr_schedule, master_params, \
    project_grads, refresh_projectors

ARCH = "recurrentgemma-9b"
SHAPE = ShapeConfig("smoke", seq_len=32, global_batch=2, mode="train")
# 40 tokens: past the reduced model's window of 16, so the band is real
LONG = ShapeConfig("long", seq_len=40, global_batch=4, mode="train")


def _ref_shape(shape):
    return RefShape(shape.name, shape.seq_len, shape.global_batch,
                    shape.mode)


def _port_model(dtype="float32", seed=0, **kw):
    cfg = dataclasses.replace(configs.get_reduced(ARCH), dtype=dtype, **kw)
    return DecoderLM(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(seed))


def _rel(got, want) -> float:
    got = np.asarray(interop.tensor_to_host(got) if isinstance(
        got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _carried(tree) -> dict:
    """A JAX parameter-shaped tree as the port's name -> tensor dict."""
    return interop.lm_params_from_reference(
        jax.tree.map(lambda x: np.asarray(x, np.float32), tree), "cpu")


def _masters(params) -> dict:
    return {k: v.clone().requires_grad_()
            for k, v in _carried(params).items()}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def lm(request):
    """(JAX model, its parameters, the port's model on the same
    parameters, a batch as numpy, tolerance) for the reduced
    RecurrentGemma; one jitted value_and_grad per dtype."""
    dtype = request.param
    ref = RefLM(dataclasses.replace(ref_get_reduced(ARCH), dtype=dtype))
    params = init_params(ref.param_specs(), jax.random.PRNGKey(1))
    port = _port_model(dtype)
    port.load_state_dict(_carried(params))
    batch = RefSyntheticLM(ref.cfg, _ref_shape(LONG), seed=0,
                           bigram_q=0.9).batch(0)
    (loss, aux), grads = jax.jit(jax.value_and_grad(ref.loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    want = {"loss": float(loss), "nll": float(aux["nll"]),
            "aux": float(aux["aux"]), "grads": _carried(grads)}
    return ref, params, port, batch, want, \
        (1e-4 if dtype == "float32" else 3e-2)


# ----------------------------------------------------------------- model

def test_loss_and_every_parameter_gradient_match_the_jax_model(lm):
    _, params, port, batch, want, tol = lm
    masters = _masters(params)
    loss, metrics, grads = value_and_grad(port, masters,
                                          to_device(batch, "cpu"))
    assert abs(float(loss) - want["loss"]) <= tol * abs(want["loss"])
    assert abs(float(metrics["nll"]) - want["nll"]) <= \
        tol * abs(want["nll"])
    assert float(metrics["aux"]) == want["aux"] == 0.0
    assert set(grads) == set(want["grads"]) == set(port.state_dict())
    for name, g in grads.items():
        assert g.dtype == torch.float32
        assert _rel(g, want["grads"][name]) <= tol, name


def test_remat_and_loss_chunk_keep_the_loss_and_gradients(lm):
    """remat "none" and "full", and the chunked loss (8-token chunks),
    give the same loss and gradients; the chunked model matches the JAX
    package's chunked model."""
    ref, params, _, batch, want, tol = lm
    dtype = ref.cfg.dtype
    tb = to_device(batch, "cpu")
    outs = {}
    for name, kw in (("none", {"remat": "none"}), ("full", {}),
                     ("chunk", {"loss_chunk": 8})):
        port = _port_model(dtype, **kw)
        masters = _masters(params)
        outs[name] = value_and_grad(port, masters, tb)
    chunked = RefLM(dataclasses.replace(ref.cfg, loss_chunk=8))
    ref_loss, _ = jax.jit(chunked.loss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    assert abs(float(outs["chunk"][0]) - float(ref_loss)) <= \
        tol * abs(float(ref_loss))
    for name in ("none", "chunk"):
        assert abs(float(outs[name][0]) - float(outs["full"][0])) <= \
            tol * abs(float(outs["full"][0]))
        for k, g in outs[name][2].items():
            assert _rel(g, outs["full"][2][k]) <= tol, (name, k)


# ------------------------------------------------------------- the step

STEP_TC = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10,
               grad_clip=1.0)


@pytest.fixture(scope="module")
def fp32_step_case():
    """The reduced model in fp32 after one JAX AdamW step (so m, v and the
    step count are not zeros), and a second batch."""
    ref = RefLM(dataclasses.replace(ref_get_reduced(ARCH),
                                    dtype="float32"))
    params = init_params(ref.param_specs(), jax.random.PRNGKey(3))
    data = RefSyntheticLM(ref.cfg, _ref_shape(SHAPE), seed=2, bigram_q=0.9)
    tc = RefTrainConfig(**STEP_TC)
    step = jax.jit(ref_loop.make_train_step(ref, tc))
    params, opt, _ = step(params, ref_optim.adamw_init(params),
                          {k: jnp.asarray(v) for k, v in
                           data.batch(0).items()})
    return ref, params, opt, data.batch(1)


@pytest.mark.parametrize("microbatches,cast_params", [
    (1, True), (2, True), (1, False)], ids=["plain", "microbatches2",
                                            "no_cast"])
def test_train_step_matches_the_jax_step(fp32_step_case, microbatches,
                                         cast_params):
    """Step 2 of AdamW from the same parameters and state: new parameters,
    m, v and the metrics. Each parameter's update is held to 1e-4 of its
    norm; per element, within the JAX suite's AdamW bound of 2.5 lr
    (tests/test_perf_features.py): m / sqrt(v) amplifies the rounding of
    a gradient that nearly cancels (the embedding's, summed over tokens
    in a thread-dependent order on the CPU)."""
    ref, params, opt, batch = fp32_step_case
    tc_kw = STEP_TC
    want_p, want_o, want_m = jax.jit(ref_loop.make_train_step(
        ref, RefTrainConfig(**tc_kw), microbatches=microbatches,
        cast_params=cast_params))(
        params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
    port = _port_model("float32")
    masters = _masters(params)
    state = interop.adamw_state_from_reference(
        jax.tree.map(np.asarray, opt), "cpu")
    assert state["step"] == 1
    step = make_train_step(port, TrainConfig(**tc_kw),
                           microbatches=microbatches,
                           cast_params=cast_params)
    got_p, got_o, got_m = step(masters, state, to_device(batch, "cpu"))
    assert got_o["step"] == int(want_o["step"]) == 2
    lr = float(want_m["lr"])
    assert got_m["lr"] == pytest.approx(lr, rel=1e-6)
    for key in ("loss", "grad_norm"):
        assert float(got_m[key]) == pytest.approx(float(want_m[key]),
                                                  rel=1e-4)
    assert set(got_m) == set(want_m)
    for part, tol in (("m", 1e-4), ("v", 2e-4)):
        want = _carried(want_o[part])
        for k, t in got_o[part].items():
            assert _rel(t, want[k]) <= tol, (part, k)
    want = _carried(want_p)
    before = _carried(params)
    for k, t in got_p.items():
        assert t.requires_grad and t.dtype == torch.float32
        err = t.detach() - want[k]
        step_norm = float(torch.linalg.norm(want[k] - before[k]))
        assert float(torch.linalg.norm(err)) <= 1e-4 * step_norm, k
        assert float(err.abs().max()) <= 2.5 * lr, k


def test_bf16_train_step_tracks_the_jax_step():
    """The bf16 model, cast before use: loss and grad norm at 3e-2, each
    parameter's m within 3e-2 of its norm and v, a square of the
    gradient, within twice that, parameters within the JAX suite's AdamW
    amplification bound of 2.5 lr (tests/test_perf_features.py). Norms,
    not maxima: a gradient that nearly cancels over the batch (RG-LRU's
    lam) carries bf16's rounding in both packages."""
    ref = RefLM(ref_get_reduced(ARCH))
    assert ref.cfg.dtype == "bfloat16"
    params = init_params(ref.param_specs(), jax.random.PRNGKey(1))
    batch = RefSyntheticLM(ref.cfg, _ref_shape(SHAPE), seed=0,
                           bigram_q=0.9).batch(0)
    tol = 3e-2
    tc = RefTrainConfig(**STEP_TC)
    want_p, want_o, want_m = jax.jit(ref_loop.make_train_step(ref, tc))(
        params, ref_optim.adamw_init(params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    port = _port_model("bfloat16")
    masters = _masters(params)
    got_p, got_o, got_m = make_train_step(port, TrainConfig(**STEP_TC))(
        masters, adamw_init(masters), to_device(batch, "cpu"))
    for key in ("loss", "grad_norm"):
        assert float(got_m[key]) == pytest.approx(float(want_m[key]),
                                                  rel=tol)
    for part, limit in (("m", tol), ("v", 2 * tol)):
        want = _carried(want_o[part])
        for k, t in got_o[part].items():
            assert float(torch.linalg.norm(t - want[k])) <= \
                limit * float(torch.linalg.norm(want[k])), (part, k)
    want = _carried(want_p)
    for k, t in got_p.items():
        assert float((t.detach() - want[k]).abs().max()) <= \
            2.5 * STEP_TC["learning_rate"], k


def test_lr_schedule_matches_the_jax_schedule():
    for tc_kw in ({}, dict(warmup_steps=5, total_steps=40),
                  dict(warmup_steps=0, total_steps=1, learning_rate=0.1)):
        tc, rtc = TrainConfig(**tc_kw), RefTrainConfig(**tc_kw)
        for step in (0, 1, 2, 3, 4, 5, 6, 17, 39, 40, 99, 100, 101, 500,
                     999, 1000, 5000):
            want = float(ref_optim.lr_schedule(rtc, jnp.float32(step)))
            assert lr_schedule(tc, step) == pytest.approx(want, rel=1e-6,
                                                          abs=1e-12)


def test_adamw_first_step_matches_reference():
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=1, weight_decay=0.0,
                     grad_clip=1e9)
    params = {"w": torch.ones(3) * 2.0}
    grads = {"w": torch.tensor([0.1, -0.2, 0.3])}
    state = adamw_init(params)
    new_params, state, _ = adamw_update(grads, state, params, tc)
    g = np.asarray([0.1, -0.2, 0.3])
    want = 2.0 - 1e-2 * g / (np.abs(g) + 1e-8)
    np.testing.assert_allclose(new_params["w"].numpy(), want, rtol=1e-4)
    assert state["step"] == 1


def test_global_norm_and_cast_floating():
    tree = {"a": torch.tensor([3.0]), "b": torch.tensor([[4.0]]),
            "i": torch.tensor([7])}
    assert float(global_norm({k: tree[k] for k in "ab"})) == 5.0
    cast = cast_floating(tree, torch.bfloat16)
    assert cast["a"].dtype == cast["b"].dtype == torch.bfloat16
    assert cast["i"].dtype == torch.int64


# -------------------------------------------------------------- training

def test_train_reduces_loss_on_synthetic_bigrams():
    port = _port_model()
    cfg = port.cfg
    data = SyntheticLM(cfg, SHAPE, seed=0, bigram_q=0.9)
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=30)
    _, history = train(port, master_params(port), data.batches(30, "cpu"),
                       tc, log_every=29)
    assert [h["step"] for h in history] == [0, 29]
    assert history[-1]["loss"] < history[0]["loss"] - 0.3, history


def test_training_updates_the_models_own_parameters():
    """The masters share storage with the model: after a step the model
    computes with what the optimizer wrote."""
    port = _port_model()
    before = port.embed.embedding.detach().clone()
    masters = master_params(port)
    step = make_train_step(port, TrainConfig(learning_rate=1e-2,
                                             warmup_steps=1))
    batch = to_device(SyntheticLM(port.cfg, SHAPE).batch(0), "cpu")
    step(masters, adamw_init(masters), batch)
    assert not torch.equal(port.embed.embedding, before)
    assert port.embed.embedding.data_ptr() == \
        masters["embed.embedding"].data_ptr()


def test_microbatched_step_matches_full_batch():
    """Gradient accumulation over microbatches reproduces the full-batch
    mean loss and gradient (the mirror of tests/test_perf_features.py)."""
    port = _port_model()
    batch = to_device(SyntheticLM(port.cfg, dataclasses.replace(
        SHAPE, global_batch=4)).batch(0), "cpu")
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, grad_clip=1e9)
    init = {k: v.detach().clone() for k, v in master_params(port).items()}
    outs = []
    for mb in (1, 4):
        masters = {k: v.clone().requires_grad_() for k, v in init.items()}
        step = make_train_step(port, tc, microbatches=mb,
                               cast_params=False)
        outs.append(step(masters, adamw_init(masters), batch))
    (p1, _, m1), (p2, _, m2) = outs
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    assert set(m2) == {"loss", "grad_norm", "lr"}
    masters = {k: v.clone().requires_grad_() for k, v in init.items()}
    g1 = value_and_grad(port, masters, batch)[2]
    parts = [value_and_grad(port, masters,
                            {k: v[i:i + 1] for k, v in batch.items()})[2]
             for i in range(4)]
    for k, g in g1.items():
        np.testing.assert_allclose(
            g.numpy(), (sum(p[k] for p in parts) / 4).numpy(), atol=2e-3)
    for k, t in p1.items():
        assert float((t - p2[k]).detach().abs().max()) <= \
            2.5 * tc.learning_rate


def test_mixed_precision_cast_close_to_fp32():
    port = _port_model("bfloat16")
    batch = to_device(SyntheticLM(port.cfg, SHAPE).batch(0), "cpu")
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1)
    init = {k: v.detach().clone() for k, v in master_params(port).items()}
    losses = []
    for cast in (True, False):
        masters = {k: v.clone().requires_grad_() for k, v in init.items()}
        _, _, m = make_train_step(port, tc, cast_params=cast)(
            masters, adamw_init(masters), batch)
        losses.append(float(m["loss"]))
    assert abs(losses[0] - losses[1]) < 0.05


def test_train_step_still_learns_with_all_features():
    port = _port_model(seed=1)
    batch = to_device(SyntheticLM(port.cfg, dataclasses.replace(
        SHAPE, global_batch=4)).batch(0), "cpu")
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=1, total_steps=10)
    params = master_params(port)
    opt = adamw_init(params)
    step = make_train_step(port, tc, microbatches=2)
    losses = []
    for _ in range(6):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_checkpoint_roundtrip(tmp_path):
    port = _port_model(seed=1)
    params = master_params(port)
    opt = adamw_init(params)
    opt["m"]["embed.embedding"].fill_(0.5)
    opt["step"] = 3
    path = os.path.join(tmp_path, "ckpt.npz")
    save_checkpoint(path, params, opt, step=7)
    keys = set(np.load(path).files)
    assert {"meta/step", "opt/step", "params/embed.embedding",
            "opt/m/layers.2.temporal.q.w",
            "opt/v/final_norm.scale"} <= keys
    p2, o2, step = restore_checkpoint(path, params, opt)
    assert step == 7 and o2["step"] == 3
    for k, t in params.items():
        assert torch.equal(t, p2[k]) and p2[k].requires_grad
        assert torch.equal(opt["m"][k], o2["m"][k])
        assert torch.equal(opt["v"][k], o2["v"][k])
    p3, o3, _ = restore_checkpoint(path, params)
    assert o3 is None and set(p3) == set(params)


# ---------------------------------------------------------------- GaLore

def test_galore_offloaded_projection_reduces_rank():
    ac = AlchemistContext(num_workers=1, device="cpu")
    ac.register_library("elemental", elemental)
    rng = np.random.RandomState(0)
    low = rng.randn(64, 4) @ rng.randn(4, 32)          # rank-4 gradient
    grads = {"w": torch.tensor(low + 0.001 * rng.randn(64, 32),
                               dtype=torch.float32)}
    gal = refresh_projectors(ac, grads, rank=4)
    assert "w" in gal.projectors
    pg = project_grads(grads, gal)["w"]
    rel = float(torch.linalg.norm(pg - grads["w"])
                / torch.linalg.norm(grads["w"]))
    assert rel < 0.05
    s = np.linalg.svd(pg.numpy(), compute_uv=False)
    assert s[4] < 1e-3 * s[0]
    ac.stop()


def test_galore_projected_gradients_match_the_jax_packages():
    """P P^T g through each package's offloaded randomized SVD (the same
    numpy sketch in the reference backends): the projected gradients
    agree whatever the signs of the basis; the JAX package's stacked
    projector of a segment is the port's per-layer projectors."""
    from repro.core import AlchemistContext as RefContext
    from repro.core.libraries import elemental as ref_elemental
    ref = RefLM(dataclasses.replace(ref_get_reduced(ARCH),
                                    dtype="float32"))
    params = init_params(ref.param_specs(), jax.random.PRNGKey(4))
    batch = RefSyntheticLM(ref.cfg, _ref_shape(SHAPE), seed=1).batch(0)
    grads = jax.jit(jax.grad(lambda p: ref.loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()})[0]))(params)
    rac = RefContext(num_workers=1)
    rac.register_library("elemental", ref_elemental)
    rac.configure(backend="reference")
    want = _carried(ref_optim.project_grads(
        grads, ref_optim.refresh_projectors(rac, grads, rank=8)))
    ac = AlchemistContext(num_workers=1, device="cpu")
    ac.register_library("elemental", elemental)
    ac.configure(backend="reference")
    tg = _carried(grads)
    gal = refresh_projectors(ac, tg, rank=8)
    assert sorted(gal.projectors) == sorted(
        k for k, g in tg.items() if eligible_for_galore(k, g, 8))
    assert "embed.embedding" in gal.projectors and \
        "layers.0.temporal.in_x.w" in gal.projectors and \
        "layers.2.temporal.q.w" not in gal.projectors
    got = project_grads(tg, gal)
    for k, g in got.items():
        assert _rel(g, want[k]) <= 1e-4, k
    rac.stop()
    ac.stop()


def test_trainer_uses_offloaded_svd_service():
    """GaLore-style projector refresh through the engine inside a real
    (tiny) training run (the mirror of tests/test_system.py)."""
    port = _port_model()
    data = SyntheticLM(port.cfg, SHAPE, seed=1, bigram_q=0.9)
    ac = AlchemistContext(num_workers=1, device="cpu")
    ac.register_library("elemental", elemental)
    params = master_params(port)
    grads = value_and_grad(port, params, to_device(data.batch(0), "cpu"))[2]
    gal = refresh_projectors(ac, grads, rank=8)
    assert isinstance(gal, GaLoreState) and len(gal.projectors) > 0
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=12)
    opt = adamw_init(params)
    step = make_train_step(port, tc, galore_state=gal)
    losses = []
    for batch in data.batches(8, "cpu"):
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0]
    ac.stop()


# ------------------------------------------------------- the linear probe

def test_offloaded_linear_probe_beats_chance():
    port = _port_model()
    shape = ShapeConfig("probe", seq_len=16, global_batch=16, mode="train")
    data = SyntheticLM(port.cfg, shape, seed=0, bigram_q=1.0)
    feats, labels = extract_features(port, data.batches(6, "cpu"),
                                     max_batches=6)
    assert feats.shape == (96, port.cfg.d_model)
    labels = labels % 8
    ac = AlchemistContext(num_workers=1, device="cpu")
    ac.register_library("skylark", skylark)
    w, res = fit_linear_head_cg(ac, feats, labels, num_classes=8, lam=1e-4)
    acc = head_accuracy(w, feats, labels)
    assert acc > 1.5 / 8, acc
    ac.stop()


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("seed,q,step", [(0, 0.5, 0), (5, 0.9, 3),
                                         (7, 1.0, 11)])
def test_synthetic_batches_are_the_jax_packages_bit_for_bit(seed, q, step):
    cfg = configs.get_reduced(ARCH)
    got = SyntheticLM(cfg, SHAPE, seed=seed, bigram_q=q).batch(step)
    want = RefSyntheticLM(ref_get_reduced(ARCH), _ref_shape(SHAPE),
                          seed=seed, bigram_q=q).batch(step)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    tensors = list(SyntheticLM(cfg, SHAPE, seed=seed, bigram_q=q)
                   .batches(step + 1, device="cpu"))
    assert len(tensors) == step + 1
    np.testing.assert_array_equal(tensors[-1]["tokens"].numpy(),
                                  want["tokens"])


def test_data_pipeline_is_deterministic_and_learnable():
    cfg = configs.get_reduced(ARCH)
    d1 = SyntheticLM(cfg, SHAPE, seed=5).batch(3)
    d2 = SyntheticLM(cfg, SHAPE, seed=5).batch(3)
    np.testing.assert_array_equal(d1["tokens"], d2["tokens"])
    data = SyntheticLM(cfg, SHAPE, seed=5, bigram_q=0.5)
    b = data.batch(0)
    hit = np.mean(b["labels"] == data.perm[b["tokens"]])
    assert hit > 0.3


# ---------------------------------------------------------------- losses

XENT_DRAWS = [(1, 1, 2, 0), (2, 5, 11, 1), (3, 8, 30, 2), (2, 3, 7, 98)]


@pytest.mark.parametrize("b,s,v,seed", XENT_DRAWS)
def test_cross_entropy_matches_naive_and_the_jax_loss(b, s, v, seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, s, v)).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    got = float(softmax_cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(labels)))
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    naive = float(-np.mean(np.take_along_axis(logp, labels[..., None],
                                              -1)))
    np.testing.assert_allclose(got, naive, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got, float(ref_xent(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 17, 9_999])
def test_cross_entropy_ignores_masked_labels(seed):
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(rng.standard_normal((2, 6, 11),
                                                  dtype=np.float32))
    labels = torch.from_numpy(rng.integers(0, 11, (2, 6)))
    masked = labels.clone()
    masked[:, -2:] = -1
    got = float(softmax_cross_entropy(logits, masked))
    want = float(softmax_cross_entropy(logits[:, :-2], labels[:, :-2]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    mask = torch.ones(2, 6, dtype=torch.bool)
    mask[:, -2:] = False
    np.testing.assert_allclose(
        float(softmax_cross_entropy(logits, labels, mask)), want,
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seq_chunk", [8, 5])
def test_chunked_xent_matches_reference_loss_and_grad(seq_chunk):
    """The mirror of tests/test_lru_loss_kernels.py's chunked-loss test,
    against the JAX package's chunked loss and its gradients too (5 does
    not divide S: one chunk, as in the JAX package)."""
    rng = np.random.default_rng(0)
    b, s, d, v = 2, 32, 16, 50
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    emb = rng.standard_normal((v, d)).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    labels[0, -3:] = -1
    tl = torch.from_numpy(labels)
    ref_loss = []
    for fn in (lambda x, e: softmax_cross_entropy(x @ e.T, tl),
               lambda x, e: chunked_unembed_cross_entropy(
                   x, e, tl, seq_chunk=seq_chunk,
                   compute_dtype=torch.float32)):
        xt, et = (torch.from_numpy(a).requires_grad_() for a in (x, emb))
        loss = fn(xt, et)
        loss.backward()
        ref_loss.append((float(loss.detach()), xt.grad, et.grad))
    (l0, gx0, ge0), (l1, gx1, ge1) = ref_loss
    np.testing.assert_allclose(l0, l1, rtol=1e-6)
    for a, bb in ((gx0, gx1), (ge0, ge1)):
        np.testing.assert_allclose(a.numpy(), bb.numpy(), rtol=1e-5,
                                   atol=1e-6)
    jl, jg = jax.value_and_grad(
        lambda x, e: ref_chunked_xent(x, e, jnp.asarray(labels),
                                      seq_chunk=seq_chunk,
                                      compute_dtype=jnp.float32),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(emb))
    np.testing.assert_allclose(l1, float(jl), rtol=1e-6)
    np.testing.assert_allclose(gx1.numpy(), np.asarray(jg[0]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ge1.numpy(), np.asarray(jg[1]), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------- launch

def test_launch_train_runs_on_the_cpu(capsys, tmp_path):
    path = os.path.join(tmp_path, "ck.npz")
    launch_train.main(["--arch", ARCH, "--reduced", "--steps", "3",
                       "--batch", "2", "--seq", "16", "--device", "cpu",
                       "--ckpt", path])
    out = capsys.readouterr().out
    assert "step    0 loss" in out and "step    2 loss" in out
    assert f"saved -> {path}" in out and np.load(path)["meta/step"] == 3


def test_training_entry_points_default_to_cuda_and_never_fall_back():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--arch", ARCH, "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(SyntheticLM(configs.get_reduced(ARCH), SHAPE).batches(1))
