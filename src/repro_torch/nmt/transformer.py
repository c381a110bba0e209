"""Marian-style encoder-decoder Transformer (paper model #3), in PyTorch.

Port of ``repro/nmt/transformer.py``: a post-norm Transformer base
(sinusoidal positions, 6+6 layers, 8 heads).  The computational profile
the paper measures — a parallel encoder vs strictly sequential decoding
(T linear in M) — comes from its two paths:

* ``encode``      — one parallel pass over all N tokens; attention goes
  through :func:`repro_torch.kernels.ops.flash_attention`;
* ``decode_step`` — one token at a time against a preallocated KV cache;
  self- and cross-attention go through
  :func:`repro_torch.kernels.ops.flash_decode` (lengths = pos+1 and the
  source lengths).

Every path is the batched one: the per-sequence ``encode`` /
``init_cache`` / ``decode_step`` / ``make_translate`` run it at B=1, so
every path on the card reaches the kernels.  The attention backend
follows the tensors' device (kernel on the card, plain version on the
CPU), so there is no ``attn_impl`` knob.

Weights live in the module.  They are drawn from an explicit seeded
``torch.Generator`` at construction; :func:`repro_torch.convert.
marian_params_from_jax` loads the reference's parameters instead.  The
model is inference-only (parameters do not require grad);
``forward_teacher`` and ``loss`` belong to training, not ported yet.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from repro_torch.data.tokenizer import PAD_ID
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.nmt.common import (
    TransformerConfig,
    build_decode_from_states,
    build_encode_states,
    build_translate_batched,
    dense,
    embed_init_,
    greedy_decode,
)


def sinusoidal(max_len: int, d_model: int,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """(max_len, d_model) float32 sinusoidal table, computed in float32
    as the reference computes it."""
    pos = torch.arange(max_len, device=device)[:, None].float()
    dim = torch.arange(0, d_model, 2, device=device)[None, :].float()
    angle = pos / torch.pow(10000.0, dim / d_model)
    pe = torch.zeros((max_len, d_model), device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)
    return pe


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, *, device, generator):
        super().__init__()
        mk = lambda: dense(d_model, d_model, device=device,
                           generator=generator)
        self.q, self.k, self.v, self.o = mk(), mk(), mk(), mk()


class FeedForward(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *, device, generator):
        super().__init__()
        self.inp = dense(d_model, d_ff, device=device, generator=generator)
        self.out = dense(d_ff, d_model, device=device, generator=generator)

    def forward(self, x):
        return self.out(F.relu(self.inp(x)))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig, *, device, generator):
        super().__init__()
        d = cfg.d_model
        self.attn = MultiHeadAttention(d, device=device, generator=generator)
        self.ln1 = nn.LayerNorm(d, eps=1e-5, device=device)
        self.ffn = FeedForward(d, cfg.d_ff, device=device,
                               generator=generator)
        self.ln2 = nn.LayerNorm(d, eps=1e-5, device=device)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig, *, device, generator):
        super().__init__()
        d = cfg.d_model
        self.self_attn = MultiHeadAttention(d, device=device,
                                            generator=generator)
        self.ln1 = nn.LayerNorm(d, eps=1e-5, device=device)
        self.cross = MultiHeadAttention(d, device=device, generator=generator)
        self.ln2 = nn.LayerNorm(d, eps=1e-5, device=device)
        self.ffn = FeedForward(d, cfg.d_ff, device=device,
                               generator=generator)
        self.ln3 = nn.LayerNorm(d, eps=1e-5, device=device)


class MarianTransformer(nn.Module):
    def __init__(self, cfg: TransformerConfig, *, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        kw = dict(device=dev, generator=gen)
        self.enc = nn.ModuleList(EncoderLayer(cfg, **kw)
                                 for _ in range(cfg.enc_layers))
        self.dec = nn.ModuleList(DecoderLayer(cfg, **kw)
                                 for _ in range(cfg.dec_layers))
        self.src_embed = skip_init(nn.Embedding, cfg.vocab_src, cfg.d_model,
                                   device=dev)
        self.tgt_embed = skip_init(nn.Embedding, cfg.vocab_tgt, cfg.d_model,
                                   device=dev)
        with torch.no_grad():
            embed_init_(self.src_embed.weight, gen)
            embed_init_(self.tgt_embed.weight, gen)
        self.out = dense(cfg.d_model, cfg.vocab_tgt, **kw)
        self.register_buffer(
            "_pe", sinusoidal(max(cfg.max_src_len, cfg.max_decode_len) + 1,
                              cfg.d_model, dev), persistent=False)
        self._emb_scale = math.sqrt(float(cfg.d_model))
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self._pe.device

    def _heads(self, x):
        """(B,S,D) -> (B,S,h,dh) view."""
        b, s, d = x.shape
        return x.view(b, s, self.cfg.heads, d // self.cfg.heads)

    # ------------------------------------------------------------- encode
    def encode(self, src_tokens, src_mask=None):
        """(N,) -> (enc_outs (N,D), mask); batched (B,N) -> ((B,N,D), (B,N)).

        Masks are prefix masks (real tokens first, padding after) — the
        serving batcher's discipline.  The per-sequence form is the
        batched one at B=1.
        """
        if src_tokens.ndim == 1:
            enc, m = self._encode_batch(
                src_tokens[None], None if src_mask is None else src_mask[None])
            return enc[0], m[0]
        return self._encode_batch(src_tokens, src_mask)

    def _attend_batch(self, p: MultiHeadAttention, q_in, kv_in, lengths, *,
                      causal: bool):
        """Batched MHA with valid-key-prefix masking through the
        attention kernel.  q_in (B,S,D), kv_in (B,T,D), lengths (B,)."""
        out = ops.flash_attention(self._heads(p.q(q_in)),
                                  self._heads(p.k(kv_in)),
                                  self._heads(p.v(kv_in)), lengths,
                                  causal=causal)
        b, sq = q_in.shape[0], q_in.shape[1]
        return p.o(out.reshape(b, sq, -1))

    def _encode_batch(self, src_tokens, src_mask):
        b, n = src_tokens.shape
        if n > self._pe.shape[0]:
            raise ValueError(f"source length {n} exceeds the position "
                             f"table ({self._pe.shape[0]} rows)")
        if src_mask is None:
            src_mask = torch.ones((b, n), device=src_tokens.device)
        # >= 1 valid key per row: the attention kernels' contract (an
        # all-pad row then attends slot 0 only; its output is discarded)
        lengths = torch.clamp((src_mask > 0).sum(dim=-1, dtype=torch.int32),
                              min=1)
        x = F.embedding(src_tokens, self.src_embed.weight) * self._emb_scale
        x = x + self._pe[:n]
        for layer in self.enc:
            a = self._attend_batch(layer.attn, x, x, lengths, causal=False)
            x = layer.ln1(x + a)
            x = layer.ln2(x + layer.ffn(x))
        return x, src_mask

    # ---------------------------------------------------- decoder w/ cache
    def init_cache(self, enc_outs, enc_mask):
        """Pre-compute cross-attention K/V; allocate the self K/V caches.

        Each decoder layer gets (B, max_decode_len, D) self K/V buffers,
        preallocated once and written in place at ``pos`` by every step
        (the JAX reference rebuilds them with ``.at[bidx, pos].set``).
        Per-sequence ``enc_outs`` (N,D) give the B=1 batched state.
        """
        if enc_outs.ndim == 2:
            enc_outs, enc_mask = enc_outs[None], enc_mask[None]
        cfg = self.cfg
        b = enc_outs.shape[0]
        shape = (b, cfg.max_decode_len, cfg.d_model)
        layers = [{"k": torch.zeros(shape, device=enc_outs.device),
                   "v": torch.zeros(shape, device=enc_outs.device),
                   "xk": layer.cross.k(enc_outs),
                   "xv": layer.cross.v(enc_outs)} for layer in self.dec]
        src_lens = torch.clamp((enc_mask > 0).sum(dim=-1, dtype=torch.int32),
                               min=1)
        return {"layers": layers,
                "pos": torch.zeros((b,), dtype=torch.int32,
                                   device=enc_outs.device),
                "enc_mask": enc_mask, "src_lens": src_lens}

    def _cached_attn_batch(self, q, kh, vh, lengths):
        """One query token against a (B,T,D) cache through the decode
        kernel, which reads the heads-folded buffers as strided
        (B,T,h,dh) views.  q (B,D), lengths (B,) -> (B,D)."""
        b, t, d = kh.shape
        h = self.cfg.heads
        out = ops.flash_decode(q.view(b, h, d // h), kh.view(b, t, h, d // h),
                               vh.view(b, t, h, d // h), lengths)
        return out.reshape(b, d)

    def decode_step(self, state, token):
        """One step for a batch: token (B,) -> (state, logits (B,V)).

        A 0-d ``token`` (the per-sequence form) runs the B=1 batch and
        returns logits (V,).  The state's caches are updated in place and
        the same state dict is returned with ``pos`` advanced.
        """
        if token.ndim == 0:
            state, logits = self._decode_step_batch(state, token[None])
            return state, logits[0]
        return self._decode_step_batch(state, token)

    def _decode_step_batch(self, state, token):
        pos = state["pos"]                                    # (B,) int32
        b = token.shape[0]
        bidx = torch.arange(b, device=token.device)
        slot = pos.long()
        self_lens = pos + 1
        x = F.embedding(token, self.tgt_embed.weight) * self._emb_scale
        x = x + self._pe.index_select(0, pos)                 # (B,D)
        for layer, cache in zip(self.dec, state["layers"]):
            sa = layer.self_attn
            cache["k"][bidx, slot] = sa.k(x)
            cache["v"][bidx, slot] = sa.v(x)
            a = self._cached_attn_batch(sa.q(x), cache["k"], cache["v"],
                                        self_lens)
            x = layer.ln1(x + sa.o(a))
            a = self._cached_attn_batch(layer.cross.q(x), cache["xk"],
                                        cache["xv"], state["src_lens"])
            x = layer.ln2(x + layer.cross.o(a))
            x = layer.ln3(x + layer.ffn(x))
        state["pos"] = self_lens
        return state, self.out(x)

    # ---------------------------------------------------------- translate
    def _check_forced_len(self, forced_len):
        """The caches hold ``max_decode_len`` slots; the reference drops
        writes past them silently, the port refuses."""
        if forced_len is not None and forced_len > self.cfg.max_decode_len:
            raise ValueError(f"forced_len {forced_len} exceeds "
                             f"max_decode_len {self.cfg.max_decode_len}")

    def make_translate(self):
        """Per-sequence translate: host-loop greedy decode at B=1.

        ``translate(src_tokens, forced_len=None) -> (m_out, tokens)``;
        one host sync per token (the Fig. 2a timing path).
        """
        def translate(src_tokens, forced_len=None):
            self._check_forced_len(forced_len)
            src = torch.as_tensor(np.asarray(src_tokens, np.int32),
                                  device=self.device)
            with torch.inference_mode():
                enc_outs, mask = self.encode(src)
                state = self.init_cache(enc_outs, mask)
                return greedy_decode(self.decode_step, state,
                                     self.cfg.max_decode_len,
                                     forced_len=forced_len,
                                     device=self.device)

        return translate

    def make_translate_batched(self, *, compiled: bool = True):
        """Batched translate: (B,N) [+ (B,N) mask] -> (lengths, tokens).

        ``compiled=True`` is the device loop with on-device EOS masking
        and one transfer at the end; ``compiled=False`` is the
        per-sequence host loop whose wall-clock stays linear in M.
        """
        def make_state(src, mask):
            enc_outs, m = self.encode(src, mask)
            return self.init_cache(enc_outs, m)

        translate = build_translate_batched(self, make_state,
                                            compiled=compiled)

        def checked(src, src_mask=None, forced_len=None):
            self._check_forced_len(forced_len)
            return translate(src, src_mask, forced_len)

        return checked

    def make_encode_states(self):
        """Encode leg of a split placement: ships only the encoder memory
        (B,N,D) and the mask — NOT the decoder cache.  The cross-attention
        K/V projections use *decoder* weights, so they are rebuilt on the
        decode tier (``make_decode_from_states``), keeping the wire
        payload at n x d_model as the scheduler's ``ActivationCostModel``
        prices it."""
        return build_encode_states(self, self.encode)

    def make_decode_from_states(self):
        """Decode leg: rebuilds the cache (cross K/V projections and empty
        self K/V) from the shipped memory with ``init_cache``, then runs
        the batched greedy loop of the fused path."""
        def state_from_data(data):
            enc_outs, mask = data
            return self.init_cache(enc_outs, mask)

        decode = build_decode_from_states(self, state_from_data)

        def checked(states, forced_len=None):
            self._check_forced_len(forced_len)
            return decode(states, forced_len)

        return checked


def make_executors(model: MarianTransformer):
    """The engine-facing executors of a Marian tier.

    Returns ``(executor, batched_executor)``:

    * ``executor(tokens) -> (m_out, tokens)`` translates one request
      through ``make_translate_batched`` at B=1 (``Tier.executor``);
    * ``batched_executor(block (b,w), lengths=None) -> [(m_out, tokens),
      ...]`` translates one padded :class:`TokenBatcher` block with a
      prefix mask (``Tier.batched_executor``); ``lengths`` defaults to
      the width minus each row's trailing PADs.

    Request ids outside the source vocabulary are clipped to its last id
    (the corpus tokenizer is larger than the model's vocabulary).  Both
    return host values, so the engine's clock stops after the device.
    """
    translate = model.make_translate_batched()
    top = model.cfg.vocab_src - 1

    def executor(tokens):
        toks = np.minimum(np.asarray(tokens, np.int32), top)[None, :]
        lens, out = translate(toks)
        m = int(lens[0])
        return m, out[0, :m]

    def batched_executor(block, lengths: Optional[Sequence[int]] = None
                         ) -> List[tuple]:
        toks = np.minimum(np.asarray(block, np.int32), top)
        if toks.ndim != 2:
            raise ValueError("batched executor expects a (b, width) block")
        width = toks.shape[1]
        if lengths is None:
            real = np.asarray(block) != PAD_ID
            trailing = np.where(real.any(1), np.argmax(real[:, ::-1], axis=1),
                                width)
            lens_in = np.maximum(width - trailing, 1)
        else:
            lens_in = np.asarray(lengths, np.int64)
        mask = (np.arange(width)[None, :] < lens_in[:, None]).astype(
            np.float32)
        lens, out = translate(toks, mask)
        return [(int(m), out[i, :int(m)]) for i, m in enumerate(lens)]

    return executor, batched_executor

