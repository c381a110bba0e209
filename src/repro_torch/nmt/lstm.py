"""2-layer BiLSTM encoder + attention LSTM decoder (paper model #1), in
PyTorch.

Port of ``repro/nmt/lstm.py``: the OpenNMT recipe the paper cites
([16]) — a bidirectional LSTM encoder, a unidirectional LSTM decoder
with Luong (dot) global attention, hidden size 500 on IWSLT'14 DE-EN.
The recurrences are Python loops over plain tensor ops: the strict step
dependency is exactly what makes T_exe linear in N and M (paper §II-A).

Weights live in the module, drawn from a seeded ``torch.Generator`` at
construction; :func:`repro_torch.convert.bilstm_params_from_jax` loads
the reference's instead.  Inference only: ``forward_teacher`` and
``loss`` belong to training, not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from repro_torch.device import resolve_device
from repro_torch.nmt.common import (
    LSTMCell,
    RNNConfig,
    build_decode_from_states,
    build_encode_states,
    build_translate_batched,
    dense,
    embed_init_,
    greedy_decode,
    luong_attention,
    luong_attention_batch,
    masked_scan_rnn,
    scan_rnn,
)


class BiLSTMLayer(nn.Module):
    """One encoder layer: forward and backward cells, and the ``2H -> H``
    projection of their concatenated outputs."""

    def __init__(self, d_in: int, hidden: int, *, device, generator):
        super().__init__()
        self.fwd = LSTMCell(d_in, hidden, device=device, generator=generator)
        self.bwd = LSTMCell(d_in, hidden, device=device, generator=generator)
        self.proj = dense(2 * hidden, hidden, device=device,
                          generator=generator)


class BiLSTMSeq2Seq(nn.Module):
    def __init__(self, cfg: RNNConfig, *, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        kw = dict(device=dev, generator=gen)
        widths = [cfg.embed] + [cfg.hidden] * (cfg.layers - 1)
        self.enc = nn.ModuleList(BiLSTMLayer(d, cfg.hidden, **kw)
                                 for d in widths)
        self.dec = nn.ModuleList(LSTMCell(d, cfg.hidden, **kw)
                                 for d in widths)
        self.src_embed = skip_init(nn.Embedding, cfg.vocab_src, cfg.embed,
                                   device=dev)
        self.tgt_embed = skip_init(nn.Embedding, cfg.vocab_tgt, cfg.embed,
                                   device=dev)
        with torch.no_grad():
            embed_init_(self.src_embed.weight, gen)
            embed_init_(self.tgt_embed.weight, gen)
        self.attn_combine = dense(2 * cfg.hidden, cfg.hidden, **kw)
        self.out = dense(cfg.hidden, cfg.vocab_tgt, **kw)
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.out.weight.device

    # ------------------------------------------------------------- encode
    def encode(self, src_tokens, src_mask=None):
        """src_tokens (N,) -> (enc_outs (N,H), decoder init carries, mask).

        Batched (B,N) inputs take the masked-scan path: the recurrence
        freezes on padding steps (both directions), so each prefix-padded
        row's final states match its trimmed self; pad positions of
        ``enc_outs`` are zeros and masked out of attention downstream.
        Decoder layer l starts from the mean of encoder layer l's final
        forward and backward states.
        """
        x = F.embedding(src_tokens, self.src_embed.weight)
        if src_mask is None:
            src_mask = torch.ones(src_tokens.shape, device=x.device)
        batched = src_tokens.ndim == 2
        h0 = torch.zeros((src_tokens.shape[0], self.cfg.hidden) if batched
                         else (self.cfg.hidden,), device=x.device)
        carries = []
        for layer in self.enc:
            if batched:
                (hf, cf), outs_f = masked_scan_rnn(layer.fwd, (h0, h0), x,
                                                   src_mask)
                (hb, cb), outs_b = masked_scan_rnn(layer.bwd, (h0, h0), x,
                                                   src_mask, reverse=True)
            else:
                (hf, cf), outs_f = scan_rnn(layer.fwd, (h0, h0), x)
                (hb, cb), outs_b = scan_rnn(layer.bwd, (h0, h0), x,
                                            reverse=True)
            x = torch.tanh(layer.proj(torch.cat([outs_f, outs_b], dim=-1)))
            carries.append((0.5 * (hf + hb), 0.5 * (cf + cb)))
        return x, tuple(carries), src_mask

    def _state(self, src, mask):
        """The decode state (carries, enc_outs, enc_mask) of a batch: also
        the split payload, verbatim."""
        enc_outs, carries, m = self.encode(src, mask)
        return (carries, enc_outs, m)

    # -------------------------------------------------------- decode step
    def decode_step(self, state, token):
        """One autoregressive step.  state = (carries, enc_outs, enc_mask).

        Batch-polymorphic: with ``token`` (B,) and a state with a leading
        batch dimension it advances all sequences at once; a 0-d token
        takes the per-sequence state.
        """
        carries, enc_outs, enc_mask = state
        x = F.embedding(token, self.tgt_embed.weight)
        new_carries = []
        for cell, carry in zip(self.dec, carries):
            carry, x = cell(carry, x)
            new_carries.append(carry)
        attend = luong_attention_batch if token.ndim else luong_attention
        ctx = attend(x, enc_outs, enc_mask)
        x = torch.tanh(self.attn_combine(torch.cat([x, ctx], dim=-1)))
        return (tuple(new_carries), enc_outs, enc_mask), self.out(x)

    # ---------------------------------------------------------- translate
    def make_translate(self):
        """Per-sequence translate: ``translate(src_tokens, forced_len=None)
        -> (m_out, tokens)``, one host sync per token (Fig. 2a)."""
        def translate(src_tokens, forced_len=None):
            src = torch.as_tensor(np.asarray(src_tokens, np.int32),
                                  device=self.device)
            with torch.inference_mode():
                return greedy_decode(self.decode_step, self._state(src, None),
                                     self.cfg.max_decode_len,
                                     forced_len=forced_len,
                                     device=self.device)

        return translate

    def make_translate_batched(self, *, compiled: bool = True):
        """Batched translate: (B,N) [+ (B,N) mask] -> (lengths, tokens).

        ``compiled=True`` is the device loop with on-device EOS masking;
        ``compiled=False`` the per-sequence host loop (timing path).
        """
        return build_translate_batched(self, self._state, compiled=compiled)

    def make_encode_states(self):
        """Encode leg of a split placement: ships the decode-step state
        verbatim — (carries, annotation vectors (B,N,H), enc mask)."""
        return build_encode_states(self, self._state)

    def make_decode_from_states(self):
        """Decode leg: EncoderStates -> (lengths, tokens); the shipped
        data is already the decode carry."""
        return build_decode_from_states(self, lambda data: data)
