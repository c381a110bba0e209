"""Shared building blocks for the paper's three seq2seq models.

Port of ``repro/nmt/common.py``: the configs, the LSTM and GRU cells and
their scans, Luong attention, the split placement's
:class:`EncoderStates` hand-off and its two legs, and the greedy decode
loops.  Two greedy-decode paths live here, with opposite goals:

* :func:`greedy_decode` — the HOST loop: one model step per token and
  one host sync per token (``int(token)``).  Its wall-clock is linear in
  M by construction, which is the paper-faithful timing path (§II-A,
  Fig. 2a).
* :func:`batched_greedy_decode` — the fast path: a Python loop over
  decode steps with a leading batch dimension and the EOS ``done`` mask
  kept on the device.  Nothing inside the loop reads a value back to the
  host, so the CPU enqueues kernels ahead of the card; the results come
  back in one transfer at the end (:func:`build_translate_batched`).

The cells are plain tensor ops (not ``nn.LSTM`` / ``nn.GRU``, whose
cuDNN cells differ: the LSTM here adds a fixed +1 to the forget gate,
the GRU carries its bias on the input side only), so the same code runs
on the CPU and on the card.
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
class RNNConfig:
    vocab_src: int = 8000
    vocab_tgt: int = 8000
    embed: int = 256
    hidden: int = 256
    layers: int = 1
    max_decode_len: int = 256


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


# ----------------------------------------------------------------- cells --
class _Cell(nn.Module):
    """The weights of one recurrent cell, stored as the reference stores
    them: ``wx`` (d_in, G*H), ``wh`` (H, G*H) glorot, ``b`` (G*H,) zero.

    ``project(x)`` is the input side of the cell; a scan applies it to
    every step at once (one GEMM) and ``step(carry, xw)`` runs the rest
    one step at a time.  ``cell(carry, x)`` is both for one step."""

    GATES = 0

    def __init__(self, d_in: int, hidden: int, *, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        width = self.GATES * hidden
        self.wx = nn.Parameter(torch.empty((d_in, width), device=device),
                               requires_grad=False)
        self.wh = nn.Parameter(torch.empty((hidden, width), device=device),
                               requires_grad=False)
        self.b = nn.Parameter(torch.zeros((width,), device=device),
                              requires_grad=False)
        with torch.no_grad():
            glorot_(self.wx, generator)
            glorot_(self.wh, generator)

    def forward(self, carry, x):
        return self.step(carry, self.project(x))


class LSTMCell(_Cell):
    """The reference's LSTM cell; carry = (h, c), gates (i, f, g, o) and a
    fixed +1 on the forget gate."""

    GATES = 4

    def project(self, x):
        return x @ self.wx

    def step(self, carry, xw):
        h, c = carry
        gates = xw + h @ self.wh + self.b   # the reference's order of adds
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (h, c), h


class GRUCell(_Cell):
    """The reference's GRU cell; carry = h, the bias on the input side
    only (``n = tanh(xn + r * hn)``)."""

    GATES = 3

    def project(self, x):
        return x @ self.wx + self.b

    def step(self, h, xz):
        xr, xu, xn = xz.chunk(3, dim=-1)
        hr, hu, hn = (h @ self.wh).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        u = torch.sigmoid(xu + hu)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - u) * n + u * h
        return h, h


def scan_rnn(cell: _Cell, init_carry, xs, reverse: bool = False):
    """Run ``cell`` over the leading (time) axis of ``xs`` (N, d).
    Returns ``(final_carry, outs (N, H))``."""
    xw = cell.project(xs)
    carry, outs = init_carry, [None] * xs.shape[0]
    steps = range(xs.shape[0])
    for t in (reversed(steps) if reverse else steps):
        carry, outs[t] = cell.step(carry, xw[t])
    return carry, torch.stack(outs)


def _where(keep, new, old):
    if isinstance(new, tuple):
        return tuple(torch.where(keep, n, o) for n, o in zip(new, old))
    return torch.where(keep, new, old)


def masked_scan_rnn(cell: _Cell, init_carry, xs, mask,
                    reverse: bool = False):
    """Batched cell over the TIME axis of batch-major ``xs`` (B,N,d).

    ``mask`` (B,N) freezes the carry on padding steps (the ragged
    prefix-padded batches of the batched decode path), so the final
    carry equals what the per-sequence unpadded scan would produce; pad
    positions emit zeros.  ``reverse=True`` visits a prefix-padded row's
    pad steps first, with the carry still at ``init_carry``.  Returns
    ``(final_carry, outs (B,N,H))``.
    """
    xw = cell.project(xs)
    keep = (mask > 0)[..., None]
    carry, outs = init_carry, [None] * xs.shape[1]
    steps = range(xs.shape[1])
    for t in (reversed(steps) if reverse else steps):
        new, out = cell.step(carry, xw[:, t])
        carry = _where(keep[:, t], new, carry)
        outs[t] = torch.where(keep[:, t], out, 0.0)
    return carry, torch.stack(outs, dim=1)


# ------------------------------------------------------------- attention --
def luong_attention(query_h, enc_outs, enc_mask):
    """Dot-product (Luong) attention: (H,), (N,H), (N,) -> context (H,)."""
    scores = torch.where(enc_mask > 0, enc_outs @ query_h, -1e30)
    return torch.softmax(scores, dim=-1) @ enc_outs


def luong_attention_batch(query_h, enc_outs, enc_mask):
    """Batched Luong: (B,H), (B,N,H), (B,N) -> context (B,H)."""
    scores = torch.bmm(enc_outs, query_h[:, :, None])[:, :, 0]
    scores = torch.where(enc_mask > 0, scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    return torch.bmm(w[:, None, :], enc_outs)[:, 0]


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


def _decode_to_host(model, state, batch: int, forced_len):
    """Batched greedy decode from ``state``, then the one transfer off the
    device (it waits for the last kernel).  The fused translate and the
    split decode leg both end here, so they run the same operations."""
    lengths, toks = batched_greedy_decode(
        model.decode_step, state, batch, model.cfg.max_decode_len,
        forced_len, device=model.device)
    host = torch.cat([lengths[:, None], toks], dim=1).cpu().numpy()
    return host[:, 0], host[:, 1:]


def _as_device_batch(model, src, src_mask):
    """(B,N) tokens and a prefix mask (default all ones) as int32 and
    float32 tensors on the model's device."""
    src = np.asarray(src, np.int32)
    mask = (np.ones(src.shape, np.float32) if src_mask is None
            else np.asarray(src_mask, np.float32))
    return (torch.as_tensor(src, device=model.device),
            torch.as_tensor(mask, device=model.device))


def _leaves(node):
    if isinstance(node, (tuple, list)):
        for child in node:
            yield from _leaves(child)
    else:
        yield node


def _map(fn, node):
    if isinstance(node, (tuple, list)):
        return tuple(_map(fn, child) for child in node)
    return fn(node)


@dataclasses.dataclass
class EncoderStates:
    """The wire format of a split placement's encoder→decoder hand-off.

    ``data`` is the model-specific encoder output, a nested tuple of
    tensors (hidden state for the GRU, carries + annotation vectors +
    mask for the BiLSTM, memory + mask for the transformer); ``src_lens``
    (B,) int32 carries the true source lengths so the decode tier can
    rebuild ragged masks without re-reading the tokens.
    """

    data: object
    src_lens: torch.Tensor

    @property
    def batch(self) -> int:
        return int(self.src_lens.shape[0])

    def payload_bytes(self) -> int:
        """Actual wire size: the sum of every tensor's bytes (what a split
        executor reports to the engine, vs. the scheduler's a-priori
        ``ActivationCostModel`` estimate)."""
        return int(sum(t.numel() * t.element_size()
                       for t in _leaves((self.data, self.src_lens))))

    def to(self, device) -> "EncoderStates":
        """The states on ``device``: the decode leg's end of the wire."""
        return EncoderStates(_map(lambda t: t.to(device), self.data),
                             self.src_lens.to(device))


def build_encode_states(model, encode_data):
    """Shared scaffolding behind the models' ``make_encode_states``.

    ``encode_data(src (B,N), src_mask (B,N)) -> nested tuple of tensors``
    is the model-specific encoder pass; the wrapper packs its result
    into :class:`EncoderStates` with the per-row source lengths.
    ``encode_states(src, src_mask=None)`` takes numpy arrays; the states
    stay on the model's device.
    """
    def encode_states(src, src_mask=None):
        with torch.inference_mode():
            src_t, mask_t = _as_device_batch(model, src, src_mask)
            data = encode_data(src_t, mask_t)
            lens = (mask_t > 0).sum(dim=-1, dtype=torch.int32)
        return EncoderStates(data, lens)

    return encode_states


def build_decode_from_states(model, state_from_data):
    """Shared scaffolding behind the models' ``make_decode_from_states``.

    ``state_from_data(data) -> batched decode state`` rebuilds the
    model's decode-step carry from the shipped :class:`EncoderStates`
    payload (identity for the RNNs; the transformer re-derives its
    cross-attention K/V cache decoder-side so only the raw memory
    crosses the wire).  The states are first moved to the model's
    device.  The decode itself is the batched greedy loop the fused
    path runs, so ``decode_from_states(encode_states(src, mask))`` equals
    ``make_translate_batched()(src, mask)`` bit for bit on one device.
    Returns ``(lengths (B,), tokens (B, steps))`` numpy int32.
    """
    def decode_from_states(states: EncoderStates, forced_len=None):
        states = states.to(model.device)
        with torch.inference_mode():
            return _decode_to_host(model, state_from_data(states.data),
                                   states.batch, forced_len)

    return decode_from_states


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
        with torch.inference_mode():
            src_t, mask_t = _as_device_batch(model, src, src_mask)
            return _decode_to_host(model, make_state(src_t, mask_t),
                                   src_t.shape[0], forced_len)

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
