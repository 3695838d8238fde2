"""End-to-end training example on the PyTorch port (``repro_torch``): train a
~100M-parameter decoder LM on the synthetic bigram corpus, with
checkpointing and the Alchemist-offloaded GaLore projector refresh (the
engine's randomized SVD, on the same device).

Defaults are CPU-tractable in size (--preset 20m --steps 60); the
full-size run is --preset 100m --steps 300.

    PYTHONPATH=src python examples/torch_train_lm.py [--preset 20m|100m] \
        [--steps N] [--galore-rank 8] [--device cpu]

The model and the engine run on one CUDA card by default; ``--device cpu``
runs both on the CPU. Parameters are random from a generator seeded 0.
After the last step the checkpoint is written, read back and held to the
trained parameters and AdamW state bit for bit.
"""
import argparse
import time

import torch

from repro_torch.common.config import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.common.device import explicit_device
from repro_torch.core import AlchemistContext
from repro_torch.core.libraries import elemental
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.launch.roofline import param_count
from repro_torch.models.model import build_model
from repro_torch.train.checkpoint import restore_checkpoint, \
    save_checkpoint
from repro_torch.train.loop import make_train_step, value_and_grad
from repro_torch.train.optim import adamw_init, master_params, \
    refresh_projectors

PRESETS = {
    "20m": ModelConfig(name="lm-20m", num_layers=6, d_model=384,
                       num_heads=6, num_kv_heads=6, d_ff=1536,
                       vocab_size=8192, remat="none"),
    "100m": ModelConfig(name="lm-100m", num_layers=12, d_model=768,
                        num_heads=12, num_kv_heads=12, d_ff=3072,
                        vocab_size=32768, remat="none"),
}
# a directory .gitignore lists
DEFAULT_CKPT = "results/train_lm/torch_train_lm_ckpt.npz"
LOG_EVERY = 10


def train_config(steps: int) -> TrainConfig:
    return TrainConfig(learning_rate=6e-4, warmup_steps=20,
                       total_steps=steps)


def corpus(cfg: ModelConfig, batch: int, seq: int) -> SyntheticLM:
    shape = ShapeConfig("train", seq_len=seq, global_batch=batch,
                        mode="train")
    return SyntheticLM(cfg, shape, seed=0, bigram_q=0.7)


def train_lm(model, params: dict, opt: dict, data: SyntheticLM,
             tc: TrainConfig, steps: int, galore_rank: int = 0,
             galore_refresh: int = 50, ac=None, log=print) -> tuple:
    """The example's loop from ``params`` (fp32 masters) and ``opt``
    (AdamW state): with ``galore_rank`` the projectors come from the
    engine behind ``ac`` on the gradient of batch 0, and again after every
    ``galore_refresh``-th step. Returns (params, opt, record): record's
    "losses" holds every step's loss, "log" the logged steps (loss, lr,
    grad norm, elapsed seconds, tokens/s since the start), "backwards"
    the loss gradients taken (the steps' and the refreshes'),
    "refreshes" and "projectors" the GaLore refreshes and tensors."""
    dev = model.device
    shape = data.shape
    tokens = shape.global_batch * shape.seq_len
    gal = None
    backwards = 0
    refreshes = 0

    def refresh(step):
        nonlocal backwards, refreshes
        _, _, grads = value_and_grad(model, params,
                                     to_device(data.batch(step), dev))
        backwards += 1
        refreshes += 1
        return refresh_projectors(ac, grads, rank=galore_rank)

    if galore_rank:
        gal = refresh(0)
        log(f"galore: projecting {len(gal.projectors)} tensors to rank "
            f"{galore_rank} (offloaded randomized SVD)")
    step_fn = make_train_step(model, tc, galore_state=gal)
    losses, history = [], []
    t0 = time.perf_counter()
    for step in range(steps):
        params, opt, metrics = step_fn(params, opt,
                                       to_device(data.batch(step), dev))
        backwards += 1
        losses.append(metrics["loss"])
        if step % LOG_EVERY == 0 or step == steps - 1:
            rec = {"step": step, "loss": float(metrics["loss"]),
                   "lr": float(metrics["lr"]),
                   "grad_norm": float(metrics["grad_norm"]),
                   "elapsed_s": time.perf_counter() - t0}
            rec["tok_s"] = (step + 1) * tokens / rec["elapsed_s"]
            history.append(rec)
            log(f"step {step:4d}  loss {rec['loss']:.4f}  "
                f"lr {rec['lr']:.2e}  grad_norm {rec['grad_norm']:.2f}  "
                f"{rec['tok_s']:,.0f} tok/s")
        if galore_rank and step and step % galore_refresh == 0:
            gal = refresh(step)
            step_fn = make_train_step(model, tc, galore_state=gal)
            log(f"step {step:4d}  [galore refresh via Alchemist]")
    record = {"losses": [float(x) for x in losses], "log": history,
              "backwards": backwards, "refreshes": refreshes,
              "projectors": len(gal.projectors) if gal else 0}
    return params, opt, record


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.detach().reshape(-1).view(torch.uint8),
        b.detach().reshape(-1).view(torch.uint8))


def checkpoint_round_trip(path: str, params: dict, opt: dict,
                          step: int) -> bool:
    """Write ``params`` and ``opt`` at ``step`` to ``path``, read them
    back, and tell whether every tensor and both step counts came back
    bit for bit."""
    save_checkpoint(path, params, opt, step=step)
    got_p, got_o, got_step = restore_checkpoint(path, params, opt)
    return (got_step == step and got_o["step"] == opt["step"]
            and got_p.keys() == params.keys()
            and all(_same_bits(got_p[k], v) for k, v in params.items())
            and all(_same_bits(got_o[part][k], v)
                    for part in ("m", "v") for k, v in opt[part].items()))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="20m", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--galore-rank", type=int, default=0,
                    help=">0 enables offload-refreshed low-rank projection")
    ap.add_argument("--galore-refresh", type=int, default=50)
    ap.add_argument("--ckpt", default=DEFAULT_CKPT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = explicit_device(args.device, "torch_train_lm")
    cfg = PRESETS[args.preset]
    model = build_model(cfg, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
    print(f"model {cfg.name}: ~{param_count(cfg) / 1e6:.0f}M params "
          f"on {dev}")
    params = master_params(model)
    data = corpus(cfg, args.batch, args.seq)
    opt = adamw_init(params)

    ac = None
    if args.galore_rank:
        ac = AlchemistContext(num_workers=1, device=dev)
        ac.register_library("elemental", elemental)
    params, opt, _ = train_lm(model, params, opt, data,
                              train_config(args.steps), args.steps,
                              galore_rank=args.galore_rank,
                              galore_refresh=args.galore_refresh, ac=ac)
    if ac is not None:
        ac.stop()
    if not checkpoint_round_trip(args.ckpt, params, opt, args.steps):
        raise SystemExit(f"checkpoint {args.ckpt} did not restore bit for "
                         "bit")
    print(f"checkpoint -> {args.ckpt} (restored bit for bit)")


if __name__ == "__main__":
    main()
