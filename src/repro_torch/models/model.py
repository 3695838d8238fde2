"""The decoder-only LM of the port: embedding, a stack of blocks, final
norm, unembedding; a full forward, the training loss, and prefill + decode
over caches for serving.

The JAX package stacks layers of one structure into segments and scans
them; the port keeps one module per layer in ``layers`` (a ``ModuleList``
in the order of ``cfg.block_kinds()``: RecurrentGemma-9B's 38 layers are
12 (rec, rec, local) cycles and a (rec, rec) tail; DeepSeek-V2's dense
first layer and its MoE layers are two segments there), so a layer's
parameters are ``layers.{n}.<path>`` where the JAX package has
``segments/{i}/b{j}/<path>[l]``. The MoE layers' router losses are summed
into the loss's aux, as the JAX package carries them through its scan.
With ``remat`` each layer runs under ``torch.utils.checkpoint`` (the JAX
package checkpoints its scan body), the aux coming out of the checkpoint
beside the hidden state; training differentiates through the swa and
lru_scan kernels' autograd Functions on the card. The encoder-decoder and
prefix-LM models wait for ROADMAP A11c-4 and A11c-5.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import explicit_device
from repro_torch.kernels.device import settle_cpu_vector_math
from repro_torch.models.blocks import check_buildable, init_block_cache, \
    make_block, uses_moe
from repro_torch.nn.core import normal
from repro_torch.nn.linear import Embedding
from repro_torch.nn.norms import norm
from repro_torch.train.loss import chunked_unembed_cross_entropy, \
    softmax_cross_entropy


@dataclasses.dataclass
class DecodeState:
    caches: list          # per layer: KVCache, RGLRUCache, RWKVCache or
    #                       MLACache
    index: int            # number of tokens already in the caches


class DecoderLM(nn.Module):
    """``generator`` draws the random parameters (default: a generator on
    ``device`` seeded 0); ``device`` defaults to ``"cuda"`` and raises
    without CUDA. Parameters are fp32; ops compute in ``cfg.dtype``."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_buildable(cfg)
        dev = explicit_device(device, "DecoderLM")
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        self.cfg = cfg
        self.compute_dtype = getattr(torch, cfg.dtype)
        v, d = cfg.vocab_size, cfg.d_model
        self.embed = Embedding(normal((v, d), 1.0, generator, dev))
        self.final_norm = norm(d, cfg.use_layernorm, cfg.norm_eps,
                               device=dev)
        self.layers = nn.ModuleList(
            make_block(cfg, kind, generator=generator, device=dev,
                       use_moe=uses_moe(cfg, n))
            for n, kind in enumerate(cfg.block_kinds()))
        self.lm_head = None if cfg.tie_embeddings else \
            Embedding(normal((v, d), 0.02, generator, dev))

    @property
    def device(self) -> torch.device:
        return self.embed.embedding.device

    def forward(self, tokens: torch.Tensor, *,
                caches: Optional[list] = None, index: Optional[int] = None,
                remat: bool = False):
        """tokens: (B, S) ids. Without ``index`` the positions are
        0..S-1 (a full forward, or a prefill that fills ``caches``); with
        it every token sits at position ``index`` (decode, S == 1). With
        ``remat`` (no caches) each layer's activations are recomputed in
        the backward pass instead of kept. Returns (final-norm hidden
        states (B, S, d), new caches)."""
        x, new_caches, _ = self.forward_with_aux(tokens, caches=caches,
                                                 index=index, remat=remat)
        return x, new_caches

    def forward_with_aux(self, tokens: torch.Tensor, *,
                         caches: Optional[list] = None,
                         index: Optional[int] = None, remat: bool = False):
        """:meth:`forward`, also returning the sum of the MoE layers'
        router losses (a scalar fp32 tensor, zero without MoE layers): the
        JAX package's ``forward``."""
        cd = self.compute_dtype
        if tokens.device.type == "cpu":
            # the layers' first exp, tanh, softplus of a process on large
            # CPU tensors must not be split across threads (ROADMAP C4)
            settle_cpu_vector_math()
        x = self.embed.embed(tokens, cd)
        x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=cd)
        b, s, _ = x.shape
        if index is None:
            positions = torch.arange(s, device=x.device).expand(b, s)
        else:
            positions = torch.full((b, s), index, device=x.device)
        new_caches = []
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for n, layer in enumerate(self.layers):
            if remat and caches is None:
                x, aux = _checkpointed(layer, x, positions, cd)
                nc = None
            else:
                x, nc, aux = layer(x, positions,
                                   cache=caches[n] if caches is not None
                                   else None,
                                   cache_index=index, compute_dtype=cd)
            if aux is not None:
                aux_total = aux_total + aux
            new_caches.append(nc)
        return self.final_norm(x), new_caches, aux_total

    def loss(self, batch: dict):
        """Mean next-token nll of ``batch`` ({"tokens", "labels"}: (B, S)
        ids on the model's device; labels < 0 are ignored). Returns
        (loss, {"nll", "aux"}): aux, the MoE layers' summed router loss
        (0 without MoE layers), is added to the loss, as the JAX package
        adds it. ``cfg.remat == "full"`` recomputes each layer in the
        backward pass; ``cfg.loss_chunk`` selects the chunked unembed +
        cross-entropy."""
        cfg = self.cfg
        x, _, aux = self.forward_with_aux(batch["tokens"],
                                          remat=cfg.remat == "full")
        labels = batch["labels"]
        if cfg.loss_chunk:
            head = self.lm_head if self.lm_head is not None else self.embed
            nll = chunked_unembed_cross_entropy(
                x, head.embedding, labels, seq_chunk=cfg.loss_chunk,
                compute_dtype=self.compute_dtype)
        else:
            nll = softmax_cross_entropy(self.unembed(x), labels)
        return nll + aux, {"nll": nll, "aux": aux}

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        head = self.lm_head if self.lm_head is not None else self.embed
        return head.unembed(x, self.compute_dtype)

    def init_cache(self, batch: int, seq_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> list:
        return [init_block_cache(self.cfg, layer.kind, batch, seq_len,
                                 dtype, self.device)
                for layer in self.layers]

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, seq_len: Optional[int] = None):
        """Run the prompt through the model, filling caches sized for
        ``seq_len`` tokens. Returns (last-token logits (B, V),
        DecodeState)."""
        b, s = tokens.shape
        caches = self.init_cache(b, seq_len or s)
        x, new_caches = self.forward(tokens, caches=caches)
        logits = self.unembed(x[:, -1:])[:, 0]
        return logits, DecodeState(caches=new_caches, index=s)

    @torch.inference_mode()
    def decode_step(self, state: DecodeState, tokens: torch.Tensor):
        """tokens: (B, 1). Returns (logits (B, V), the next state). The
        attention caches of ``state`` are updated in place."""
        x, new_caches = self.forward(tokens, caches=state.caches,
                                     index=state.index)
        logits = self.unembed(x[:, -1:])[:, 0]
        return logits, DecodeState(caches=new_caches, index=state.index + 1)


def _checkpointed(layer: nn.Module, x: torch.Tensor,
                  positions: torch.Tensor, compute_dtype: torch.dtype):
    """(x, aux) of ``layer(x, positions)`` under
    ``torch.utils.checkpoint``: the MoE router loss comes out of the
    checkpoint beside the hidden state (None for a dense layer). The
    layer's parameters go in as explicit inputs and the recomputation
    runs on exactly those tensors (``torch.func.functional_call``), so it
    is right whether the layer holds its own parameters or is called
    inside another ``functional_call`` (the train step's bf16 copies),
    which has put its originals back by the time the backward pass
    recomputes."""
    names, tensors = zip(*layer.named_parameters())

    def run(x, *params):
        out, _, aux = torch.func.functional_call(
            layer, dict(zip(names, params)), (x, positions),
            {"compute_dtype": compute_dtype})
        return out, aux
    return checkpoint(run, x, *tensors, use_reentrant=False)
