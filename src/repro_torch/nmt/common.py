"""Shared building blocks for the seq2seq models (the Marian half).

Port of ``repro/nmt/common.py``.  Two greedy-decode paths live here, with
opposite goals:

* :func:`greedy_decode` — the HOST loop: one model step per token and
  one host sync per token (``int(token)``).  Its wall-clock is linear in
  M by construction, which is the paper-faithful timing path (§II-A,
  Fig. 2a).
* :func:`batched_greedy_decode` — the fast path: a Python loop over
  decode steps with a leading batch dimension and the EOS ``done`` mask
  kept on the device.  Nothing inside the loop reads a value back to the
  host, so the CPU enqueues kernels ahead of the card; the results come
  back in one transfer at the end (:func:`build_translate_batched`).

The RNN cells, ``masked_scan_rnn``, ``EncoderStates`` and the split
encode/decode legs are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn
from torch.nn.utils import skip_init

from repro_torch.data.tokenizer import BOS_ID, EOS_ID, PAD_ID


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_src: int = 8000
    vocab_tgt: int = 8000
    d_model: int = 256
    heads: int = 8
    d_ff: int = 1024
    enc_layers: int = 6
    dec_layers: int = 6
    max_decode_len: int = 256
    max_src_len: int = 512


# ------------------------------------------------------------------ init --
def glorot_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """Glorot-uniform init in place (symmetric in fan-in and fan-out, so
    the (d_out, d_in) ``nn.Linear`` layout draws from the same law as the
    reference's (d_in, d_out))."""
    fan_out, fan_in = weight.shape[-2], weight.shape[-1]
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    weight.uniform_(-lim, lim, generator=generator)


def embed_init_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """N(0, 1/dim) embedding init in place."""
    weight.normal_(0.0, weight.shape[-1] ** -0.5, generator=generator)


def dense(d_in: int, d_out: int, *, device: torch.device,
          generator: torch.Generator) -> nn.Linear:
    """The reference's ``dense`` layer (``x @ w + b``, glorot ``w``, zero
    ``b``) as an ``nn.Linear``, whose weight is stored transposed, as
    (d_out, d_in)."""
    lin = skip_init(nn.Linear, d_in, d_out, device=device)
    with torch.no_grad():
        glorot_(lin.weight, generator)
        lin.bias.zero_()
    return lin


# ----------------------------------------------------------------- decode --
def greedy_decode(decode_step, init_state, max_len: int,
                  forced_len: int | None = None, *,
                  device: torch.device):
    """Host-side greedy autoregressive loop.

    ``decode_step(state, token) -> (state, logits)`` takes a 0-d token
    tensor.  Returns (m_out, tokens) with tokens a numpy int32 array.
    The loop syncs with the device once per token, on purpose: its
    wall-clock is linear in the number of generated tokens M — the very
    property (paper §II-A, Fig. 2a) C-NMT's latency plane relies on.

    ``forced_len`` runs EXACTLY that many steps ignoring EOS — used by the
    offline characterization to sweep a controlled (N, M) grid.
    """
    token = torch.tensor(BOS_ID, dtype=torch.int32, device=device)
    state = init_state
    out = []
    steps = forced_len if forced_len is not None else max_len
    for _ in range(steps):
        state, logits = decode_step(state, token)
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        tid = int(token)
        if forced_len is None and tid == EOS_ID:
            break
        out.append(tid)
    return len(out), np.asarray(out, np.int32)


def greedy_update(tok, done, *, keep_eos: bool = False,
                  forced: bool = False):
    """ONE emission step of the greedy EOS bookkeeping, on the device.

    ``tok`` (B,) is the carried token about to be emitted, ``done`` (B,)
    the rows already past their EOS.  Returns ``(emit, live, done2)``:
    the PAD-masked emission, the rows that emitted a real pre-EOS token
    this step (what ``lengths`` counts), and the updated done mask.
    """
    if forced:
        return tok, torch.ones_like(tok, dtype=torch.bool), done
    is_eos = tok == EOS_ID
    live = ~(done | is_eos)                  # emits a real token now
    pad = torch.full_like(tok, PAD_ID)
    emit = (torch.where(done, pad, tok) if keep_eos
            else torch.where(live, tok, pad))
    return emit, live, done | is_eos


def scan_greedy_steps(decode_step, state, token0, batch: int, steps: int, *,
                      keep_eos: bool = False, forced: bool = False):
    """The shared greedy-decode loop body over ``steps`` emissions.

    Each iteration emits the carried token, then steps the model once to
    produce the next (``decode_step(state, tokens (B,)) -> (state, logits
    (B,V))``).  EOS bookkeeping stays on the device:

    * ``keep_eos=False`` PAD-masks the EOS slot itself (the NMT models'
      contract — emitted tokens are exactly the pre-EOS output);
    * ``keep_eos=True`` emits the EOS token and PAD-masks only the
      positions after it;
    * ``forced=True`` ignores EOS entirely (controlled-(N, M) grids).

    Like the reference's ``lax.scan`` it runs all ``steps`` emissions and
    does not stop early when every row is done.  The model step after
    the last emission is skipped: its output is never read, and at
    ``steps == max_decode_len`` it would write past the end of the cache
    (the reference's scan runs it and drops the write).

    Returns ``(lengths (B,) int32, tokens (B, steps) int32)`` on the
    device, lengths counting pre-EOS tokens either way.
    """
    done = torch.zeros((batch,), dtype=torch.bool, device=token0.device)
    tok = token0
    emits, lives = [], []
    for i in range(steps):
        emit, live, done = greedy_update(tok, done, keep_eos=keep_eos,
                                         forced=forced)
        emits.append(emit)
        lives.append(live)
        if i + 1 < steps:
            state, logits = decode_step(state, tok)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
    if not emits:
        empty = torch.zeros((batch, 0), dtype=torch.int32,
                            device=token0.device)
        return empty.sum(dim=1, dtype=torch.int32), empty
    lengths = torch.stack(lives, dim=1).sum(dim=1, dtype=torch.int32)
    return lengths, torch.stack(emits, dim=1)


def batched_greedy_decode(decode_step, init_state, batch: int, max_len: int,
                          forced_len: int | None = None, *,
                          device: torch.device):
    """Batched greedy decode with on-device EOS masking.

    ``decode_step(state, tokens (B,)) -> (state, logits (B,V))`` carries a
    leading batch dimension.  A ``done`` mask freezes finished sequences
    (their emitted slots become PAD) while the loop keeps stepping the
    still-live ones — no per-token host round-trip.

    Returns ``(lengths (B,) int32, tokens (B, steps) int32)`` on the
    device: per-sequence output length EXCLUDING the EOS token (the
    paper's M, matching :func:`greedy_decode`'s ``m_out`` per sequence)
    and the emitted tokens, PAD-masked at and after each EOS.

    ``forced_len`` runs exactly that many steps ignoring EOS — same
    controlled-(N, M)-grid contract as :func:`greedy_decode`.
    """
    steps = forced_len if forced_len is not None else max_len
    bos = torch.full((batch,), BOS_ID, dtype=torch.int32, device=device)
    state, logits = decode_step(init_state, bos)
    token0 = torch.argmax(logits, dim=-1).to(torch.int32)
    return scan_greedy_steps(decode_step, state, token0, batch, steps,
                             keep_eos=False, forced=forced_len is not None)


def build_translate_batched(model, make_state, *, compiled: bool = True):
    """Shared scaffolding behind the models' ``make_translate_batched``.

    ``make_state(src (B,N), src_mask (B,N)) -> batched decode state`` is
    the only model-specific piece (encode + state assembly); stepping is
    ``model.decode_step`` with a leading batch dim.  ``compiled=True``
    (the name kept from the reference, where it meant one XLA dispatch)
    is the batched device loop; ``compiled=False`` is the per-sequence
    host loop (the paper-faithful, linear-in-M timing path).  Both return
    ``translate(src, src_mask=None, forced_len=None) -> (lengths (B,),
    tokens (B, steps))`` as numpy int32 arrays, after the device has
    finished.
    """
    if not compiled:
        translate = model.make_translate()

        def translate_host(src, src_mask=None, forced_len=None):
            return host_translate_batched(translate, src, src_mask,
                                          forced_len)
        return translate_host

    def translate_batch(src, src_mask=None, forced_len=None):
        src = np.asarray(src, np.int32)
        mask = (np.ones(src.shape, np.float32) if src_mask is None
                else np.asarray(src_mask, np.float32))
        with torch.inference_mode():
            state = make_state(torch.as_tensor(src, device=model.device),
                               torch.as_tensor(mask, device=model.device))
            lengths, toks = batched_greedy_decode(
                model.decode_step, state, src.shape[0],
                model.cfg.max_decode_len, forced_len, device=model.device)
            # the one transfer off the device; it waits for the last kernel
            host = torch.cat([lengths[:, None], toks], dim=1).cpu().numpy()
        return host[:, 0], host[:, 1:]

    return translate_batch


def host_translate_batched(translate, src_tokens, src_mask=None,
                           forced_len: int | None = None):
    """Paper-faithful batch fallback: per-sequence HOST-loop translate.

    Runs ``translate`` (a model's ``make_translate`` closure) row by row
    over a prefix-padded batch — one model step and one host sync per
    token per sequence.  Returns ``(lengths (B,), tokens (B, width))``
    numpy arrays, PAD-filled past each row's length, mirroring
    :func:`batched_greedy_decode`'s contract.
    """
    src = np.asarray(src_tokens, np.int32)
    b, n = src.shape
    mask = (np.ones((b, n), np.float32) if src_mask is None
            else np.asarray(src_mask))
    src_lens = mask.astype(bool).sum(axis=1)
    lengths = np.zeros((b,), np.int32)
    rows = []
    for i in range(b):
        m_out, toks = translate(src[i, :int(src_lens[i])],
                                forced_len=forced_len)
        lengths[i] = int(m_out)
        rows.append(np.asarray(toks, np.int32))
    width = max(1, max(len(r) for r in rows))
    out = np.full((b, width), PAD_ID, np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return lengths, out
