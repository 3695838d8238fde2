"""The LMs of the port: the decoder-only LM (dense / MoE / hybrid / SSM /
prefix-VLM) and the encoder-decoder (Whisper-style): embedding, a stack of
blocks, final norm, unembedding; a full forward, the training loss, and
prefill + decode over caches for serving.

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
lru_scan kernels' autograd Functions on the card.

A prefix-LM (PaliGemma) takes precomputed patch embeddings in front of its
text, unscaled, every global layer attending bidirectionally within them;
an encoder-decoder (Whisper) takes precomputed frame embeddings into its
encoder (``encoder.blocks.{l}``, the JAX package's stacked
``encoder/blocks``), and its decoder blocks cross-attend to the encoder's
output. The modality frontends are stubs in both packages.
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
from repro_torch.models.blocks import EncoderBlock, init_block_cache, \
    make_block, uses_moe
from repro_torch.nn.attention import KVCache
from repro_torch.nn.core import normal
from repro_torch.nn.linear import Embedding
from repro_torch.nn.norms import norm
from repro_torch.nn.rope import sinusoidal_positions
from repro_torch.train.loss import chunked_unembed_cross_entropy, \
    softmax_cross_entropy


@dataclasses.dataclass
class DecodeState:
    caches: list          # per layer: KVCache, RGLRUCache, RWKVCache or
    #                       MLACache; an encoder-decoder's {"self", "cross"}
    index: int            # number of tokens already in the caches


def _default_generator(dev: torch.device) -> torch.Generator:
    """A generator on ``dev`` seeded 0; on the meta device, where nothing
    is drawn, a CPU generator (meta tensors take no generator of their
    own)."""
    return torch.Generator("cpu" if dev.type == "meta" else dev) \
        .manual_seed(0)


class DecoderLM(nn.Module):
    """``generator`` draws the random parameters (default: a generator on
    ``device`` seeded 0); ``device`` defaults to ``"cuda"`` and raises
    without CUDA, and ``"meta"`` builds the shapes alone (the dry run).
    Parameters are fp32; ops compute in ``cfg.dtype``."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = explicit_device(device, type(self).__name__, allow_meta=True)
        if generator is None:
            generator = _default_generator(dev)
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
                patch_embeds: Optional[torch.Tensor] = None,
                caches: Optional[list] = None, index: Optional[int] = None,
                remat: bool = False):
        """tokens: (B, S) ids; ``patch_embeds`` (B, P, d), a prefix-LM's
        precomputed image patches, go in front of the text. Without
        ``index`` the positions are 0..P+S-1 (a full forward, or a prefill
        that fills ``caches``); with it every token sits at position
        ``index`` (decode, S == 1). With ``remat`` (no caches) each layer's
        activations are recomputed in the backward pass instead of kept.
        Returns (final-norm hidden states (B, P + S, d), new caches)."""
        x, new_caches, _ = self.forward_with_aux(
            tokens, patch_embeds=patch_embeds, caches=caches, index=index,
            remat=remat)
        return x, new_caches

    def forward_with_aux(self, tokens: torch.Tensor, *,
                         patch_embeds: Optional[torch.Tensor] = None,
                         caches: Optional[list] = None,
                         index: Optional[int] = None, remat: bool = False):
        """:meth:`forward`, also returning the sum of the MoE layers'
        router losses (a scalar fp32 tensor, zero without MoE layers): the
        JAX package's ``forward``. Only the text embeddings are scaled by
        sqrt(d); the patch embeddings are cast and put in front
        unscaled."""
        x = self._embed(tokens)
        if patch_embeds is not None:
            x = torch.cat([patch_embeds.to(self.compute_dtype), x], dim=1)
        return self._decode_layers(x, caches, index, remat,
                                   prefix_len=self.cfg.prefix_len)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The text embeddings in the compute dtype, scaled by sqrt(d)."""
        cd = self.compute_dtype
        if tokens.device.type == "cpu":
            # the layers' first exp, tanh, softplus of a process on large
            # CPU tensors must not be split across threads (ROADMAP C4)
            settle_cpu_vector_math()
        x = self.embed.embed(tokens, cd)
        return x * torch.tensor(self.cfg.d_model ** 0.5, dtype=cd)

    def _decode_layers(self, x: torch.Tensor, caches: Optional[list],
                       index: Optional[int], remat: bool,
                       enc_out: Optional[torch.Tensor] = None,
                       prefix_len: int = 0):
        """The layers and the final norm over embeddings ``x``: (hidden
        states, new caches, summed router loss). A layer's cache entry is
        its cache, or ``{"self", "cross"}`` in an encoder-decoder."""
        cd = self.compute_dtype
        b, s, _ = x.shape
        if index is None:
            positions = torch.arange(s, device=x.device).expand(b, s)
        else:
            positions = torch.full((b, s), index, device=x.device)
        new_caches = []
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for n, layer in enumerate(self.layers):
            entry = caches[n] if caches is not None else None
            cross = isinstance(entry, dict)
            if remat and caches is None:
                x, aux = _checkpointed(layer, x, positions, cd,
                                       enc_out=enc_out,
                                       prefix_len=prefix_len)
                nc = None
            else:
                x, nc, ncross, aux = layer(
                    x, positions, cache=entry["self"] if cross else entry,
                    cache_index=index, enc_out=enc_out,
                    cross_cache=entry["cross"] if cross else None,
                    prefix_len=prefix_len, compute_dtype=cd)
                if cross:
                    nc = {"self": nc, "cross": ncross}
            if aux is not None:
                aux_total = aux_total + aux
            new_caches.append(nc)
        return self.final_norm(x), new_caches, aux_total

    def loss(self, batch: dict):
        """Mean next-token nll of ``batch`` ({"tokens", "labels"}: (B, S)
        ids on the model's device, and a prefix-LM's ``patch_embeds``;
        labels < 0 are ignored). Returns (loss, {"nll", "aux"}): aux, the
        MoE layers' summed router loss (0 without MoE layers), is added to
        the loss, as the JAX package adds it. A prefix-LM's text
        predictions start at the last prefix position, as the JAX
        package's. ``cfg.remat == "full"`` recomputes each layer in the
        backward pass; ``cfg.loss_chunk`` selects the chunked unembed +
        cross-entropy."""
        cfg = self.cfg
        x, _, aux = self.forward_with_aux(
            batch["tokens"], patch_embeds=batch.get("patch_embeds"),
            remat=cfg.remat == "full")
        labels = batch["labels"]
        if cfg.prefix_len:
            x = x[:, cfg.prefix_len - 1:cfg.prefix_len - 1 + labels.shape[1]]
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
    def prefill(self, tokens: torch.Tensor, seq_len: Optional[int] = None,
                *, patch_embeds: Optional[torch.Tensor] = None):
        """Run the prompt (behind a prefix-LM's ``patch_embeds``) through
        the model, filling caches sized for ``seq_len`` positions (default
        the prompt's and the prefix's). Returns (last-token logits (B, V),
        DecodeState at index S + prefix_len)."""
        b, s = tokens.shape
        total = s + self.cfg.prefix_len
        caches = self.init_cache(b, seq_len or total)
        x, new_caches = self.forward(tokens, patch_embeds=patch_embeds,
                                     caches=caches)
        logits = self.unembed(x[:, -1:])[:, 0]
        return logits, DecodeState(caches=new_caches, index=total)

    @torch.inference_mode()
    def decode_step(self, state: DecodeState, tokens: torch.Tensor):
        """tokens: (B, 1). Returns (logits (B, V), the next state). The
        attention caches of ``state`` are updated in place."""
        x, new_caches = self.forward(tokens, caches=state.caches,
                                     index=state.index)
        logits = self.unembed(x[:, -1:])[:, 0]
        return logits, DecodeState(caches=new_caches, index=state.index + 1)


class EncDecLM(DecoderLM):
    """Whisper-style encoder-decoder. The modality frontend is a stub, as
    in the JAX package: the input is precomputed frame embeddings
    (B, encoder_seq, encoder_d_model). The encoder is ``encoder.blocks``
    (:class:`EncoderBlock`, every head its own kv head, no rope) and
    ``encoder.final_norm``; each decoder block cross-attends to its
    output."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        if not cfg.is_encdec:
            raise ValueError(f"{cfg.name} has no encoder (encoder_layers "
                             "= 0): build it as a DecoderLM")
        dev = explicit_device(device, "EncDecLM", allow_meta=True)
        if generator is None:
            generator = _default_generator(dev)
        super().__init__(cfg, device=dev, generator=generator)
        enc_cfg = dataclasses.replace(
            cfg, d_model=cfg.encoder_d_model or cfg.d_model,
            num_kv_heads=cfg.num_heads)
        self.encoder = nn.Module()
        self.encoder.blocks = nn.ModuleList(
            EncoderBlock(enc_cfg, generator=generator, device=dev)
            for _ in range(cfg.encoder_layers))
        self.encoder.final_norm = norm(enc_cfg.d_model, cfg.use_layernorm,
                                       cfg.norm_eps, device=dev)

    def init_cache(self, batch: int, seq_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> list:
        """Each decoder layer's ``{"self": its cache, "cross": K/V of
        (batch, encoder_seq, K, Dh)}``, the JAX package's cache entry."""
        cfg = self.cfg
        shape = (batch, cfg.encoder_seq, cfg.num_kv_heads,
                 cfg.resolved_head_dim)

        def zeros():
            return torch.zeros(shape, dtype=dtype, device=self.device)
        return [{"self": c, "cross": KVCache(k=zeros(), v=zeros())}
                for c in super().init_cache(batch, seq_len, dtype)]

    def encode(self, frames: torch.Tensor,
               remat: bool = False) -> torch.Tensor:
        """frames: (B, T, d_enc) stub embeddings -> the encoder's output
        (B, T, d_enc) in the compute dtype: sinusoidal positions added,
        bidirectional attention through the swa kernel (window = prefix
        = T)."""
        cd = self.compute_dtype
        if frames.device.type == "cpu":
            settle_cpu_vector_math()
        b, t, d = frames.shape
        x = frames.to(cd) + sinusoidal_positions(t, d, frames.device).to(
            cd)[None]
        positions = torch.arange(t, device=x.device).expand(b, t)
        for block in self.encoder.blocks:
            if remat:
                x, _ = _checkpointed(block, x, positions, cd)
            else:
                x = block(x, positions, compute_dtype=cd)
        return self.encoder.final_norm(x)

    def forward(self, tokens: torch.Tensor, *,
                frames: Optional[torch.Tensor] = None,
                enc_out: Optional[torch.Tensor] = None,
                caches: Optional[list] = None, index: Optional[int] = None,
                remat: bool = False):
        """The decoder over ``tokens`` (B, S), cross-attending to
        ``enc_out`` (or to the encoding of ``frames``) in a full forward
        or prefill, to the cross caches in decode. Returns (final-norm
        hidden states (B, S, d), new caches)."""
        x, new_caches, _ = self.forward_with_aux(
            tokens, frames=frames, enc_out=enc_out, caches=caches,
            index=index, remat=remat)
        return x, new_caches

    def forward_with_aux(self, tokens: torch.Tensor, *,
                         frames: Optional[torch.Tensor] = None,
                         enc_out: Optional[torch.Tensor] = None,
                         caches: Optional[list] = None,
                         index: Optional[int] = None, remat: bool = False):
        if enc_out is None and frames is not None:
            enc_out = self.encode(frames, remat=remat)
        return self._decode_layers(self._embed(tokens), caches, index, remat,
                                   enc_out=enc_out)

    def loss(self, batch: dict):
        """Mean next-token nll of ``batch`` ({"tokens", "labels", "frames"}
        on the model's device), plus the (zero) router loss, as the JAX
        package's ``EncDecLM.loss`` (no chunked cross-entropy)."""
        x, _, aux = self.forward_with_aux(
            batch["tokens"], frames=batch["frames"],
            remat=self.cfg.remat == "full")
        nll = softmax_cross_entropy(self.unembed(x), batch["labels"])
        return nll + aux, {"nll": nll, "aux": aux}

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, seq_len: Optional[int] = None,
                *, frames: torch.Tensor):
        """Encode ``frames``, then run the prompt through the decoder,
        filling the self caches (sized for ``seq_len`` tokens, default the
        prompt's) and the cross caches. Returns (last-token logits (B, V),
        DecodeState)."""
        b, s = tokens.shape
        enc_out = self.encode(frames)
        caches = self.init_cache(b, seq_len or s)
        x, new_caches = self.forward(tokens, enc_out=enc_out, caches=caches)
        logits = self.unembed(x[:, -1:])[:, 0]
        return logits, DecodeState(caches=new_caches, index=s)


def build_model(cfg: ModelConfig, *, device="cuda",
                generator: Optional[torch.Generator] = None) -> DecoderLM:
    """The model of ``cfg``: an :class:`EncDecLM` for an encoder-decoder,
    else a :class:`DecoderLM`, on ``device`` ("cuda", "cpu", or "meta" for
    the dry run's shapes)."""
    cls = EncDecLM if cfg.is_encdec else DecoderLM
    return cls(cfg, device=device, generator=generator)


def _checkpointed(layer: nn.Module, x: torch.Tensor,
                  positions: torch.Tensor, compute_dtype: torch.dtype,
                  enc_out: Optional[torch.Tensor] = None,
                  prefix_len: int = 0):
    """(x, aux) of ``layer(x, positions)`` under
    ``torch.utils.checkpoint``: the MoE router loss comes out of the
    checkpoint beside the hidden state (None for a dense layer or an
    :class:`EncoderBlock`). The layer's parameters go in as explicit
    inputs and the recomputation runs on exactly those tensors
    (``torch.func.functional_call``), so it is right whether the layer
    holds its own parameters or is called inside another
    ``functional_call`` (the train step's bf16 copies), which has put its
    originals back by the time the backward pass recomputes. A decoder
    block's ``enc_out`` goes in as an input too."""
    names, tensors = zip(*layer.named_parameters())
    encoder = isinstance(layer, EncoderBlock)

    def run(x, enc_out, *params):
        kwargs = {"compute_dtype": compute_dtype}
        if not encoder:
            kwargs.update(enc_out=enc_out, prefix_len=prefix_len)
        out = torch.func.functional_call(
            layer, dict(zip(names, params)), (x, positions), kwargs)
        return (out, None) if encoder else (out[0], out[3])
    return checkpoint(run, x, enc_out, *tensors, use_reentrant=False)
