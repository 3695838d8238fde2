"""Model inputs: concrete random batches for smoke tests and examples.

The modality-frontend carve-out lives here, as in the JAX package's
``models/io.py``: whisper gets precomputed frame embeddings, paligemma
precomputed patch embeddings — the transformer backbone is what the port
implements. :func:`make_batch` draws the JAX package's numpy
``RandomState`` values in its order, so a batch equals the JAX package's
for the same (config, shape, seed), and puts them on an explicit device.
:func:`batch_struct`, :func:`decode_state_struct` and
:func:`decode_tokens_struct` are the JAX package's ShapeDtypeStruct
stand-ins for the dry run (``launch/dryrun.py``): meta tensors of the same
shapes and dtypes. Its sharding annotations (``attach_shardings``) have no
counterpart on one device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.config import ModelConfig, ShapeConfig
from repro_torch.common.device import explicit_device


def text_len(cfg: ModelConfig, seq_len: int) -> int:
    """Text tokens of a sequence of ``seq_len`` positions: a prefix-LM's
    prefix takes the first ``prefix_len``."""
    return seq_len - cfg.prefix_len if cfg.prefix_len else seq_len


def make_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
               device="cuda") -> dict:
    """Concrete random batch on ``device`` (default cuda, which raises
    without CUDA): int32 ``tokens`` (and ``labels`` in train mode) of
    :func:`text_len` tokens, bf16 ``patch_embeds`` (B, P, d) for a
    prefix-LM, bf16 ``frames`` (B, encoder_seq, d_enc) for an
    encoder-decoder."""
    dev = explicit_device(device, "make_batch")
    rng = np.random.RandomState(seed)
    b, s = shape.global_batch, shape.seq_len
    st = text_len(cfg, s)

    def ids():
        return torch.from_numpy(
            rng.randint(0, cfg.vocab_size, (b, st)).astype(np.int32)).to(dev)

    def embeds(*dims):
        x = torch.from_numpy(rng.randn(b, *dims) * 0.02)
        return x.to(torch.bfloat16).to(dev)

    out = {"tokens": ids()}
    if shape.mode == "train":
        out["labels"] = ids()
    if cfg.prefix_len:
        out["patch_embeds"] = embeds(cfg.prefix_len, cfg.d_model)
    if cfg.is_encdec:
        out["frames"] = embeds(cfg.encoder_seq,
                               cfg.encoder_d_model or cfg.d_model)
    return out


def batch_struct(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta tensors for one train/prefill batch: int32 ``tokens`` (and
    ``labels`` in train mode) of :func:`text_len` tokens, bf16
    ``patch_embeds`` (B, P, d) for a prefix-LM, bf16 ``frames``
    (B, encoder_seq, d_enc) for an encoder-decoder."""
    b, s = shape.global_batch, shape.seq_len
    st = text_len(cfg, s)

    def meta(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    out = {"tokens": meta((b, st), torch.int32)}
    if shape.mode == "train":
        out["labels"] = meta((b, st), torch.int32)
    if cfg.prefix_len:
        out["patch_embeds"] = meta((b, cfg.prefix_len, cfg.d_model),
                                   torch.bfloat16)
    if cfg.is_encdec:
        out["frames"] = meta((b, cfg.encoder_seq,
                              cfg.encoder_d_model or cfg.d_model),
                             torch.bfloat16)
    return out


def decode_state_struct(model, shape: ShapeConfig):
    """The DecodeState of ``model`` (built on the meta device) at a cache
    of ``shape.seq_len`` positions for ``shape.global_batch`` rows, its
    index at the last position (S - 1), as the JAX package's."""
    from repro_torch.models.model import DecodeState
    b, s = shape.global_batch, shape.seq_len
    return DecodeState(caches=model.init_cache(b, s), index=s - 1)


def decode_tokens_struct(cfg: ModelConfig, shape: ShapeConfig):
    """Meta int32 (B, 1): one decode step's tokens."""
    return torch.empty((shape.global_batch, 1), dtype=torch.int32,
                       device="meta")


def stub_extras(cfg: ModelConfig, batch: int, rng) -> dict:
    """A wave's inputs for the stub modality frontends, drawn from the
    numpy ``RandomState`` ``rng`` as the JAX package's serving launcher
    draws them (0.02 x standard normal, fp32): a prefix-LM's
    ``patch_embeds`` (B, P, d), an encoder-decoder's ``frames``
    (B, encoder_seq, d_enc); none for a text-only model."""
    if cfg.prefix_len:
        return {"patch_embeds": 0.02 * rng.randn(
            batch, cfg.prefix_len, cfg.d_model).astype(np.float32)}
    if cfg.is_encdec:
        return {"frames": 0.02 * rng.randn(
            batch, cfg.encoder_seq,
            cfg.encoder_d_model or cfg.d_model).astype(np.float32)}
    return {}
