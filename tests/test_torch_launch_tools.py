"""The port's launch tools (ROADMAP A11c-6) against the JAX package's:
``repro_torch.launch.roofline`` (the analytic FLOP, parameter and cache
counts with the H100's constants), the meta stand-ins of
``repro_torch.models.io`` and ``repro_torch.launch.dryrun``, the build and
step check of every supported (architecture x shape) on the meta device,
with the kernel wrappers' meta routes it runs through.

Mirrors ``tests/test_dryrun_small.py``: ``test_model_flops_sanity``, and
``test_dryrun_lowers_on_test_mesh`` as the dry run on the meta device for
its four (arch, shape) pairs (there is no mesh). Two tests there have no
counterpart: ``test_roofline_collective_parser`` parses XLA's HLO for the
bytes collectives move between chips, and
``test_moe_expert_parallel_matches_reference`` checks the shard_map
expert-parallel MoE on 8 devices; the port compiles no HLO and runs on one
card.
"""
import json

import jax
import pytest
import torch

from repro.common.config import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import roofline as ref_rl
from repro.models import io as ref_io
from repro.models.model import build_model as ref_build_model
from repro.nn.core import ParamSpec
from repro_torch.common.config import H100, SHAPES, HardwareSpec
from repro_torch.configs import ALL_ARCHS, ASSIGNED, get_config
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.models import io
from repro_torch.models.model import build_model

ARCH_SHAPES = [(a, s) for a in ASSIGNED for s in SHAPES]


def _c13(cfg, shape) -> float:
    """The encoder attention FLOPs the JAX package's model_flops leaves
    out (ROADMAP C13): it counts a context of encoder_seq / 2 where the
    bidirectional encoder attends to all encoder_seq frames."""
    if not cfg.is_encdec:
        return 0.0
    enc_d = cfg.encoder_d_model or cfg.d_model
    missing = shape.global_batch * cfg.encoder_seq * cfg.encoder_layers \
        * 2 * 2 * (cfg.encoder_seq / 2) * enc_d
    return missing * (3.0 if shape.mode == "train" else 1.0)


@pytest.mark.parametrize("arch,shape", ARCH_SHAPES)
def test_roofline_counts_are_the_jax_packages(arch, shape):
    """model_flops, param_count, active_param_count, cache_bytes and the
    decode bytes on one chip equal the JAX package's for every assigned
    config and shape; whisper-medium's model_flops equals the JAX figure
    plus the bidirectional encoder's missing half (C13)."""
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    sh, ref_sh = SHAPES[shape], REF_SHAPES[shape]
    want = ref_rl.model_flops(ref_cfg, ref_sh) + _c13(cfg, sh)
    assert rl.model_flops(cfg, sh) == pytest.approx(want, rel=1e-15)
    if not cfg.is_encdec:
        assert rl.model_flops(cfg, sh) == ref_rl.model_flops(ref_cfg, ref_sh)
    assert rl.param_count(cfg) == ref_rl.param_count(ref_cfg)
    assert rl.active_param_count(cfg) == ref_rl.active_param_count(ref_cfg)
    assert rl.cache_bytes(cfg, sh) == ref_rl.cache_bytes(ref_cfg, ref_sh)
    assert rl.analytic_decode_bytes_per_chip(cfg, sh) == \
        ref_rl.analytic_decode_bytes_per_chip(ref_cfg, ref_sh, 1)


def test_c13_adds_the_encoders_full_context():
    """whisper-medium's encoder attends to all 1,500 frames: the port's
    train_4k FLOPs exceed the JAX package's by exactly the other half of
    its score and context products, and only for the encoder-decoder."""
    cfg = get_config("whisper-medium")
    sh = SHAPES["train_4k"]
    extra = rl.model_flops(cfg, sh) - ref_rl.model_flops(
        ref_get_config("whisper-medium"), REF_SHAPES["train_4k"])
    assert extra == pytest.approx(3 * 256 * 1500 * 24 * 2 * 2 * 750 * 1024)
    assert extra > 0


def test_model_flops_sanity():
    """Analytic FLOPs ~ 6ND for a dense model at short context (the JAX
    package's test, on the port's roofline)."""
    cfg = get_config("qwen3-4b")
    shape = SHAPES["train_4k"]
    mf = rl.model_flops(cfg, shape)
    n = rl.param_count(cfg) - cfg.vocab_size * cfg.d_model  # non-embedding
    d = shape.global_batch * shape.seq_len
    ratio = mf / (6 * n * d)
    assert 0.8 < ratio < 1.8, ratio


def test_the_roofline_takes_the_h100_and_no_tpu_constant():
    """The card's data-sheet peaks the kernel bounds use, the card named
    with its power limit; no interconnect or VMEM field (the JAX
    package's V5E has both), and one device's report has no collective
    term."""
    assert (H100.peak_flops, H100.hbm_bw, H100.hbm_bytes) == \
        (989e12, 3.35e12, 80e9)
    assert H100.card == "NVIDIA H100 80GB HBM3, 700 W"
    fields = {f.name for f in HardwareSpec.__dataclass_fields__.values()}
    assert fields == {"card", "peak_flops", "hbm_bw", "hbm_bytes"}
    cfg = get_config("qwen3-4b")
    r = rl.build_report("qwen3-4b", SHAPES["decode_32k"], cfg, 3.35e12)
    assert r.collective_s == 0.0 and r.chips == 1
    assert r.memory_s == pytest.approx(1.0)
    assert r.compute_s == pytest.approx(
        rl.model_flops(cfg, SHAPES["decode_32k"]) / 989e12)
    assert r.dominant == "memory"


def _ref_param_elements(arch) -> int:
    specs = ref_build_model(ref_get_config(arch)).param_specs()
    total = 0
    for spec in jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, ParamSpec)):
        n = 1
        for dim in spec.shape:
            n *= dim
        total += n
    return total


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_the_meta_build_has_the_jax_packages_parameter_count(arch):
    """Every full config built on the meta device holds exactly as many
    parameter elements as the JAX package's ``param_specs()``, each fp32,
    and none has data."""
    model = build_model(get_config(arch), device="meta")
    params = list(model.parameters())
    assert all(p.device.type == "meta" and p.dtype == torch.float32
               for p in params)
    assert sum(p.numel() for p in params) == _ref_param_elements(arch)


@pytest.mark.parametrize("arch", ASSIGNED)
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_meta_stand_ins_have_the_jax_packages_shapes(arch, shape):
    """batch_struct and decode_tokens_struct: the JAX package's
    ShapeDtypeStruct shapes and dtypes, as meta tensors;
    decode_state_struct's index is S - 1."""
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    sh, ref_sh = SHAPES[shape], REF_SHAPES[shape]
    got = io.batch_struct(cfg, sh)
    want = ref_io.batch_struct(ref_cfg, ref_sh)
    assert set(got) == set(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape)
        assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype)
    tok = io.decode_tokens_struct(cfg, sh)
    ref_tok = ref_io.decode_tokens_struct(ref_cfg, ref_sh)
    assert tuple(tok.shape) == tuple(ref_tok.shape) and \
        tok.dtype == torch.int32 and tok.device.type == "meta"
    if shape == "decode_32k":
        state = io.decode_state_struct(build_model(cfg, device="meta"), sh)
        assert state.index == sh.seq_len - 1
        assert all(t.device.type == "meta"
                   for t in dryrun._cache_tensors(state.caches))


def _check_record(rec, arch, shape):
    assert rec["arch"] == arch and rec["shape"] == shape
    assert rec["device"] == "meta" and rec["chips"] == 1
    assert rec["card"] == "NVIDIA H100 80GB HBM3, 700 W"
    assert rec["roofline"]["dominant"] in ("compute", "memory")
    assert rec["roofline"]["collective_s"] == 0.0
    assert rec["model_flops"] > 0
    assert rec["param_count"]["built"] == _ref_param_elements(arch)
    assert rec["param_count"]["analytic"] == ref_rl.param_count(
        ref_get_config(arch))
    assert rec["cards_for_state"] >= 1
    n = rec["param_count"]["built"]
    state = rec["state_bytes"]
    if rec["mode"] == "train":
        assert state == {"masters": 4 * n, "gradients": 4 * n,
                         "adamw_m_v": 8 * n}
        assert rec["saved_activation_bytes"] > 0
    else:
        assert state["weights_bf16"] == 2 * n and state["cache"] > 0
    if rec["mode"] == "decode":
        # the cache the step reads, as built, is the roofline's cache_bytes
        assert state["cache"] == rec["cache_bytes_analytic"]


@pytest.mark.parametrize("arch,shape", [
    ("stablelm-1.6b", "train_4k"),
    ("deepseek-v2-lite-16b", "decode_32k"),
    ("rwkv6-1.6b", "long_500k"),
    ("qwen3-4b", "train_4k"),
])
def test_dryrun_runs_on_meta(arch, shape, tmp_path):
    """The JAX package's test_dryrun_lowers_on_test_mesh pairs through the
    port's command line: one JSON each, on the meta device, one card,
    H100 terms, dominant compute or memory, model_flops > 0."""
    out = tmp_path / "dr"
    dryrun.main(["--arch", arch, "--shape", shape, "--out", str(out)])
    files = list(out.iterdir())
    assert len(files) == 1
    _check_record(json.loads(files[0].read_text()), arch, shape)


def test_dryrun_all_lists_the_jax_packages_combos():
    """``--all`` runs every supported (arch x shape) of the assigned ids
    and qwen3-4b-sw at long_500k, as the JAX package's does."""
    from repro.configs import ASSIGNED as REF_ASSIGNED, supports_shape
    want = [(a, s) for a in REF_ASSIGNED for s, sh in REF_SHAPES.items()
            if supports_shape(ref_get_config(a), sh)]
    want.append(("qwen3-4b-sw", "long_500k"))
    assert dryrun.combos() == want


@pytest.mark.parametrize("arch,shape", dryrun.combos())
def test_dryrun_every_combo(arch, shape):
    """Each combo of ``--all`` builds and steps on the meta device (``--all``
    takes over a minute in one process, so it is checked combo by combo)."""
    _check_record(dryrun.run_one(arch, shape, out_dir="", verbose=False),
                  arch, shape)


def test_the_dry_run_finds_paligemma_and_whisper_training_fits():
    """At the training configs chip_smoke.py runs on the card (B = 4,
    768 and 1,500 + 448 positions) the step's resident bytes fit one
    card."""
    import dataclasses
    from repro_torch.common.config import ShapeConfig
    for arch, seq in (("paligemma-3b", 768), ("whisper-medium", 448)):
        cfg = dataclasses.replace(get_config(arch), remat="full",
                                  loss_chunk=512 if arch == "paligemma-3b"
                                  else 0)
        rec = dryrun.train_record(build_model(cfg, device="meta"), cfg,
                                 ShapeConfig("t", seq, 4, "train"))
        assert rec["resident_bytes"] <= H100.hbm_bytes, (arch, rec)


@pytest.mark.parametrize("wrapper", ["swa", "lru_scan"])
def test_a_wrong_meta_shape_is_caught(wrapper, monkeypatch):
    """A planted fault: a kernel wrapper's meta route that returns one
    position too many makes the dry run raise, so the check sees the
    shapes the kernels hand back."""
    from repro_torch.kernels.lru_scan import ops as lru_ops
    from repro_torch.kernels.swa import ops as swa_ops
    if wrapper == "swa":
        real = swa_ops.swa_forward

        def wrong(q, *a, **kw):
            out = real(q, *a, **kw)
            if q.device.type != "meta":
                return out
            b, h, s, d = q.shape
            bad = torch.empty((b, h, s + 1, d), dtype=q.dtype,
                              device="meta")
            return (bad,) + tuple(out[1:])
        monkeypatch.setattr(swa_ops, "swa_forward", wrong)
        arch = "qwen3-4b"
    else:
        real = lru_ops._scan

        def wrong(a, b, h0):
            out = real(a, b, h0)
            if a.device.type != "meta":
                return out
            n, s, w = a.shape
            return torch.empty((n, s + 1, w), device="meta")
        monkeypatch.setattr(lru_ops, "_scan", wrong)
        arch = "recurrentgemma-9b"
    with pytest.raises(RuntimeError):
        dryrun.run_one(arch, "prefill_32k", out_dir="", verbose=False)


def test_meta_routes_give_the_plain_versions_shapes_and_dtypes():
    """swa (with lse and the fp32 output), its backward and lru_scan (both
    directions, with da) on meta tensors return what the CPU route
    returns, in shape and dtype, on meta; a mix of meta and CPU operands
    raises."""
    from repro_torch.kernels.lru_scan.ops import lru_scan, lru_scan_reverse
    from repro_torch.kernels.swa.ops import swa_backward, swa_forward
    g = torch.Generator().manual_seed(0)
    cpu = {"q": torch.randn(2, 4, 40, 32, generator=g).bfloat16(),
           "k": torch.randn(2, 2, 40, 32, generator=g).bfloat16(),
           "a": torch.rand(2, 40, 16, generator=g),
           "h0": torch.zeros(2, 16)}
    for dev in ("cpu", "meta"):
        t = {k: v.to(dev) for k, v in cpu.items()}
        q, k, a, h0 = t["q"], t["k"], t["a"], t["h0"]
        fwd = swa_forward(q, k, k, 16, True, 8)
        bwd = swa_backward(q, k, k, fwd[2], fwd[1], q, window=16, prefix=8)
        scans = (lru_scan(a, a, h0),) + lru_scan_reverse(a, a, h0, h=a,
                                                         h_init=h0)
        outs = [(tuple(x.shape), x.dtype, x.device.type)
                for x in (*fwd, *bwd, *scans)]
        if dev == "cpu":
            want = [(s, d, "meta") for s, d, _ in outs]
        else:
            assert outs == want
    with pytest.raises(ValueError, match="several devices"):
        swa_forward(cpu["q"], cpu["k"].to("meta"), cpu["k"], 16)


def test_only_the_builders_and_the_dry_run_take_meta():
    """build_model and the dry run accept device="meta"; the engine and
    the serve and train launchers keep refusing it."""
    from repro_torch.common.device import explicit_device
    from repro_torch.core.engine import AlchemistEngine
    from repro_torch.launch import serve, train
    assert explicit_device("meta", allow_meta=True).type == "meta"
    with pytest.raises(ValueError, match="unsupported device"):
        explicit_device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        AlchemistEngine(device="meta")
    for launcher, args in ((serve, []), (train, ["--reduced"])):
        with pytest.raises(ValueError, match="unsupported device"):
            launcher.main(["--arch", "qwen3-4b", "--device", "meta", *args])
