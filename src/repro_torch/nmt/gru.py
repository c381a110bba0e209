"""Single-layer GRU encoder/decoder, hidden 256 (paper model #2), in PyTorch.

Port of ``repro/nmt/gru.py``: the paper's FR-EN model ([18]), a minimal
seq2seq without attention — the encoder's final hidden state is the
fixed-size context handed to the decoder (the classic "context vector"
architecture of Fig. 1a).  Like the reference it is one layer whatever
``cfg.layers`` says.

Weights live in the module, drawn from a seeded ``torch.Generator`` at
construction; :func:`repro_torch.convert.gru_params_from_jax` loads the
reference's instead.  Parameters are frozen at construction; a trainer
unfreezes them (``model.requires_grad_(True)``).  Training
(``forward_teacher``, ``loss``) runs the same cells; no kernel is
involved.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from repro_torch.device import resolve_device
from repro_torch.nmt.common import (
    GRUCell,
    RNNConfig,
    build_decode_from_states,
    build_encode_states,
    build_translate_batched,
    cross_entropy,
    dense,
    embed_init_,
    greedy_decode,
    masked_scan_rnn,
    scan_rnn,
)


class GRUSeq2Seq(nn.Module):
    def __init__(self, cfg: RNNConfig, *, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        kw = dict(device=dev, generator=gen)
        self.src_embed = skip_init(nn.Embedding, cfg.vocab_src, cfg.embed,
                                   device=dev)
        self.tgt_embed = skip_init(nn.Embedding, cfg.vocab_tgt, cfg.embed,
                                   device=dev)
        with torch.no_grad():
            embed_init_(self.src_embed.weight, gen)
            embed_init_(self.tgt_embed.weight, gen)
        self.enc = GRUCell(cfg.embed, cfg.hidden, **kw)
        self.dec = GRUCell(cfg.embed, cfg.hidden, **kw)
        self.out = dense(cfg.hidden, cfg.vocab_tgt, **kw)
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.out.weight.device

    def encode(self, src_tokens, src_mask=None):
        """(N,) -> context (H,); or batched (B,N) [+ mask] -> (B,H).

        The batched path freezes the recurrence on padding steps, so a
        prefix-padded row yields the same context as its trimmed self.
        """
        x = F.embedding(src_tokens, self.src_embed.weight)
        if src_tokens.ndim == 2:
            if src_mask is None:
                src_mask = torch.ones(src_tokens.shape, device=x.device)
            h0 = torch.zeros((src_tokens.shape[0], self.cfg.hidden),
                             device=x.device)
            h, _ = masked_scan_rnn(self.enc, h0, x, src_mask)
            return h
        h, _ = scan_rnn(self.enc, torch.zeros((self.cfg.hidden,),
                                              device=x.device), x)
        return h

    def decode_step(self, state, token):
        """One step; state (H,) + 0-d token, or (B,H) + (B,) tokens."""
        h, _ = self.dec(state, F.embedding(token, self.tgt_embed.weight))
        return h, self.out(h)

    def make_translate(self):
        """Per-sequence translate: ``translate(src_tokens, forced_len=None)
        -> (m_out, tokens)``, one host sync per token (Fig. 2a)."""
        def translate(src_tokens, forced_len=None):
            src = torch.as_tensor(np.asarray(src_tokens, np.int32),
                                  device=self.device)
            with torch.inference_mode():
                return greedy_decode(self.decode_step, self.encode(src),
                                     self.cfg.max_decode_len,
                                     forced_len=forced_len,
                                     device=self.device)

        return translate

    def make_translate_batched(self, *, compiled: bool = True):
        """Batched translate: (B,N) [+ (B,N) mask] -> (lengths, tokens).

        ``compiled=True`` is the device loop with on-device EOS masking;
        ``compiled=False`` the per-sequence host loop (timing path).
        """
        return build_translate_batched(self, self.encode, compiled=compiled)

    def make_encode_states(self):
        """Encode leg of a split placement: (B,N) [+ mask] ->
        :class:`EncoderStates` carrying the final hidden state (B,H) —
        the GRU's fixed-size context is the whole payload."""
        return build_encode_states(self, self.encode)

    def make_decode_from_states(self):
        """Decode leg: EncoderStates -> (lengths, tokens); the shipped
        hidden state IS the decode carry, no rebuild needed."""
        return build_decode_from_states(self, None)

    def forward_teacher(self, src, src_mask, tgt_in):
        """Teacher-forced logits: (B,N), (B,N), (B,M) -> (B,M,V).

        As the reference's (a ``vmap`` of its per-sequence encode, whose
        scan ignores the mask), the encoder runs over every position,
        padding included; then one decode step per target token."""
        h = self.encode(src, torch.ones_like(src_mask))
        logits = []
        for t in range(tgt_in.shape[1]):
            h, lg = self.decode_step(h, tgt_in[:, t])
            logits.append(lg)
        return torch.stack(logits, dim=1)

    def loss(self, batch):
        """Masked token-mean cross entropy on a ``padded_batches`` batch
        (tensors on the model's device)."""
        logits = self.forward_teacher(batch["src"], batch["src_mask"],
                                      batch["tgt_in"])
        return cross_entropy(logits, batch["tgt_out"], batch["tgt_mask"])
