"""The port's training and serving examples against the JAX package's.

``examples/torch_train_lm.py``'s loop (``train_lm``), started from the JAX
package's initial parameters (carried across by
``interop.lm_params_from_reference``) at a 2-layer, width-64 preset in
fp32, gives the loss of ``repro.train.loop.make_train_step`` at each of
the first 5 steps on the same ``SyntheticLM`` batches, within
``test_train_step_matches_the_jax_step``'s 1e-4; its checkpoint restores
bit for bit. ``examples/torch_serve_decode.py``'s traffic (``serve``) on
qwen3-4b's reduced config in fp32 from converted parameters gives the
JAX ``ServingEngine``'s tokens and stats, as the serving parity tests
of ``test_torch_lm.py`` hold them."""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import ModelConfig as RefConfig, \
    ShapeConfig as RefShape, TrainConfig as RefTrainConfig
from repro.configs import get_reduced as ref_get_reduced
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models.model import build_model as ref_build_model
from repro.nn.core import init_params
from repro.serve.engine import Request as RefRequest, \
    ServingEngine as RefEngine
from repro.train.loop import make_train_step as ref_make_train_step
from repro.train.optim import adamw_init as ref_adamw_init
from repro_torch import interop
from repro_torch.common.config import ModelConfig
from repro_torch.configs import get_reduced
from repro_torch.models.model import build_model
from repro_torch.train.optim import adamw_init, master_params

REPO = Path(__file__).resolve().parent.parent
TINY = dict(name="lm-tiny", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=4, d_ff=256, vocab_size=512, remat="none",
            dtype="float32")
STEPS, BATCH, SEQ = 5, 2, 32


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _port_model(cfg, ref_params):
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    model.load_state_dict(interop.lm_params_from_reference(
        jax.tree.map(np.asarray, ref_params), "cpu"))
    return model


@pytest.fixture(scope="module")
def trained():
    """(the JAX losses, the example's losses, masters, AdamW state)."""
    ex = _example("torch_train_lm")
    ref_cfg = RefConfig(**TINY)
    ref = ref_build_model(ref_cfg)
    params = init_params(ref.param_specs(), jax.random.PRNGKey(0))
    data = RefSyntheticLM(ref_cfg, RefShape("train", SEQ, BATCH, "train"),
                          seed=0, bigram_q=0.7)
    tc = ex.train_config(STEPS)
    step = jax.jit(ref_make_train_step(
        ref, RefTrainConfig(**dataclasses.asdict(tc))))
    want = []
    p, opt = params, ref_adamw_init(params)
    for i in range(STEPS):
        p, opt, metrics = step(p, opt, {k: jnp.asarray(v) for k, v in
                                        data.batch(i).items()})
        want.append(float(metrics["loss"]))

    cfg = ModelConfig(**TINY)
    model = _port_model(cfg, params)
    masters = master_params(model)
    masters, state, rec = ex.train_lm(
        model, masters, adamw_init(masters), ex.corpus(cfg, BATCH, SEQ),
        tc, STEPS, log=lambda *_: None)
    return want, rec, masters, state, ex


def test_train_lm_losses_match_the_jax_train_step(trained):
    want, rec, *_ = trained
    assert len(rec["losses"]) == STEPS and rec["backwards"] == STEPS
    for got, ref in zip(rec["losses"], want):
        assert got == pytest.approx(ref, rel=1e-4)
    assert [r["step"] for r in rec["log"]] == [0, STEPS - 1]


def test_train_lm_checkpoint_restores_bit_for_bit(trained, tmp_path):
    _, _, masters, state, ex = trained
    assert state["step"] == STEPS
    assert ex.checkpoint_round_trip(str(tmp_path / "ck.npz"), masters,
                                    state, STEPS)
    # bits, not values: -0.0 equals 0.0 but is not the same bits
    assert not ex._same_bits(torch.tensor([0.0]), torch.tensor([-0.0]))
    assert ex._same_bits(torch.tensor([-0.0]), torch.tensor([-0.0]))


def test_serve_decode_gives_the_jax_engines_tokens():
    ex = _example("torch_serve_decode")
    ref = ref_build_model(dataclasses.replace(ref_get_reduced("qwen3-4b"),
                                              dtype="float32"))
    params = init_params(ref.param_specs(), jax.random.PRNGKey(0))
    model = _port_model(dataclasses.replace(get_reduced("qwen3-4b"),
                                            dtype="float32"), params)
    done, engine, _ = ex.serve(model, requests=6, max_new=12)

    ref_eng = RefEngine(ref, params, max_batch=4)
    rng = np.random.RandomState(0)
    for _ in range(6):
        plen = rng.randint(4, 20)
        ref_eng.submit(RefRequest(
            prompt=rng.randint(0, ref.cfg.vocab_size, plen).astype(np.int32),
            max_new_tokens=12))
    want = ref_eng.run()
    assert [r.out_tokens for r in done] == [r.out_tokens for r in want]
    assert [list(r.prompt) for r in done] == [list(r.prompt) for r in want]
    assert all(len(r.out_tokens) == 12 for r in done)
    for key in ("prefills", "decode_steps", "requests"):
        assert engine.stats[key] == ref_eng.stats[key]
