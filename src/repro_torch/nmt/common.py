"""Shared building blocks for the paper's three seq2seq models.

Port of ``repro/nmt/common.py``: the configs, the LSTM and GRU cells and
their scans, Luong attention, the split placement's
:class:`EncoderStates` hand-off and its two legs, the greedy decode
loops, and the training loss (:func:`cross_entropy`).  Two greedy-decode paths live here, with opposite goals:

* :func:`greedy_decode` — the HOST loop: one model step per token and
  one host sync per token (``int(token)``).  Its wall-clock is linear in
  M by construction, which is the paper-faithful timing path (§II-A,
  Fig. 2a).
* :func:`batched_greedy_decode` — the fast path: a loop over decode
  steps with a leading batch dimension (:class:`GreedySteps`) and the
  EOS bookkeeping on the device (:func:`greedy_columns`).  Nothing in a
  step reads a value back to the host, so on the card each step is a
  replay of one CUDA graph (``repro_torch.runtime.graphs``; the
  reference's single ``lax.scan`` dispatch), and on the CPU or under
  ``graphs.eager()`` a Python loop; the results come back in one
  transfer at the end (:func:`build_translate_batched`).

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


def greedy_columns(cols, *, keep_eos: bool = False, forced: bool = False):
    """The greedy EOS bookkeeping of a whole decode at once.

    ``cols`` (B, steps) holds the carried token of each emission step (what
    :func:`greedy_update` would be given, step after step).  Returns
    ``(lengths (B,) int32, tokens (B, steps) int32)``, exactly what
    :func:`greedy_update` run over the columns gives: a row is live until
    its first EOS, ``lengths`` counts its live (pre-EOS) tokens;
    ``keep_eos=False`` PAD-masks the EOS and everything after it,
    ``keep_eos=True`` keeps the EOS and PAD-masks what follows it;
    ``forced=True`` ignores EOS (every token emitted and counted).
    """
    b, steps = cols.shape
    if forced:
        return torch.full((b,), steps, dtype=torch.int32,
                          device=cols.device), cols.clone()
    is_eos = cols == EOS_ID
    seen = torch.cumsum(is_eos, dim=1, dtype=torch.int32)   # EOS so far
    live = seen == 0
    pad = torch.full_like(cols, PAD_ID)
    emit = (torch.where(seen - is_eos.to(torch.int32) > 0, pad, cols)
            if keep_eos else torch.where(live, cols, pad))
    return live.sum(dim=1, dtype=torch.int32), emit


class GreedySteps:
    """The static buffers of a batched greedy decode, and its step.

    ``state`` is the model's decode state (a tree of tensors), ``tok``
    (B,) int32 the carried token, ``cols`` (B, width) int32 the tokens
    the steps produce, one column a step at the step index ``idx`` (1,)
    kept on the device.  :meth:`step` runs ``decode_step(state, tok) ->
    (state, logits)`` once, copies every state tensor it returned as a
    new tensor back into its buffer (the RNNs return new carries; the
    transformer and the LM update theirs in place), takes the argmax as
    the next ``tok`` and writes it at column ``idx``.  Nothing in it reads
    a value back to the host, so one CUDA graph of it serves every step
    of every decode of its shapes (``repro_torch.runtime.graphs``); on
    the CPU, and under ``graphs.eager()``, a Python loop calls it.
    """

    def __init__(self, decode_step, state, tok, width: int):
        from repro_torch.runtime import graphs

        self.decode_step = decode_step
        self.state = state
        self.tok = tok
        self.cols = torch.full((tok.shape[0], max(width, 1)), PAD_ID,
                               dtype=torch.int32, device=tok.device)
        self.idx = torch.zeros((1,), dtype=torch.long, device=tok.device)
        self._leaves = graphs.leaves
        self._static = graphs.leaves(state)

    def static(self) -> tuple:
        """Every buffer :meth:`step` writes."""
        return (self.state, self.tok, self.cols, self.idx)

    def start(self, tok, first: bool = False) -> None:
        """Load the carried token (B,); ``first=True`` also writes it as
        column 0 and starts the steps at column 1."""
        self.tok.copy_(tok)
        if first:
            self.cols[:, 0] = tok
        self.idx.fill_(1 if first else 0)

    def step(self) -> None:
        state, logits = self.decode_step(self.state, self.tok)
        new = self._leaves(state)
        if len(new) != len(self._static):
            raise ValueError("decode_step changed the state's structure")
        for old, fresh in zip(self._static, new):
            if fresh is not old:
                old.copy_(fresh)
        self.tok.copy_(torch.argmax(logits, dim=-1))
        self.cols.index_copy_(1, self.idx, self.tok[:, None])
        self.idx.add_(1)


def scan_greedy_steps(decode_step, state, token0, batch: int, steps: int, *,
                      keep_eos: bool = False, forced: bool = False):
    """The greedy decode over ``steps`` emissions, eagerly.

    Each emission is the carried token; between two emissions the model
    steps once to produce the next (``decode_step(state, tokens (B,)) ->
    (state, logits (B,V))``), through :class:`GreedySteps`, and the EOS
    bookkeeping (:func:`greedy_columns`) stays on the device:

    * ``keep_eos=False`` PAD-masks the EOS slot itself (the NMT models'
      contract — emitted tokens are exactly the pre-EOS output);
    * ``keep_eos=True`` emits the EOS token and PAD-masks only the
      positions after it;
    * ``forced=True`` ignores EOS entirely (controlled-(N, M) grids).

    Like the reference's ``lax.scan`` it runs all ``steps`` emissions and
    does not stop early when every row is done.  The model step after
    the last emission is skipped: its output is never read, and at
    ``steps == max_decode_len`` it would write past the end of the cache
    (the reference's scan runs it and drops the write).  ``state`` is
    advanced in place.

    Returns ``(lengths (B,) int32, tokens (B, steps) int32)`` on the
    device, lengths counting pre-EOS tokens either way.
    """
    if steps <= 0:
        empty = torch.zeros((batch, 0), dtype=torch.int32,
                            device=token0.device)
        return empty.sum(dim=1, dtype=torch.int32), empty
    loop = GreedySteps(decode_step, state, token0.clone(), steps)
    loop.start(token0, first=True)
    for _ in range(steps - 1):
        loop.step()
    return greedy_columns(loop.cols[:, :steps], keep_eos=keep_eos,
                          forced=forced)


def batched_greedy_decode(decode_step, init_state, batch: int, max_len: int,
                          forced_len: int | None = None, *,
                          device: torch.device):
    """Batched greedy decode with on-device EOS masking, eagerly.

    ``decode_step(state, tokens (B,)) -> (state, logits (B,V))`` carries a
    leading batch dimension.  The loop steps every row from BOS, ``steps``
    model steps in all; finished rows keep stepping and their emitted
    slots become PAD — no per-token host round-trip.

    Returns ``(lengths (B,) int32, tokens (B, steps) int32)`` on the
    device: per-sequence output length EXCLUDING the EOS token (the
    paper's M, matching :func:`greedy_decode`'s ``m_out`` per sequence)
    and the emitted tokens, PAD-masked at and after each EOS.

    ``forced_len`` runs exactly that many steps ignoring EOS — same
    controlled-(N, M)-grid contract as :func:`greedy_decode`.
    """
    steps = forced_len if forced_len is not None else max_len
    bos = torch.full((batch,), BOS_ID, dtype=torch.int32, device=device)
    loop = GreedySteps(decode_step, init_state, bos, steps)
    for _ in range(steps):
        loop.step()
    return greedy_columns(loop.cols[:, :steps], forced=forced_len is not None)


# graph keys an NMT model keeps: one per (leg, batch, source width), each
# a decoder cache of B x max_decode_len x d_model floats a layer at most
# (Marian en-zh: 6 MB at B=1, 50 MB at B=8); an engine's B=1 requests
# bring a key per distinct source length
NMT_GRAPH_KEYS = 64


class _DecodeGraphs:
    """One key's graphs: the static ``inputs``, ``prep`` (the graph that
    makes the decode state from them; None when the inputs are the state)
    and the greedy loop over that state with its step graph."""

    def __init__(self, model, make_state, args, batch: int, width: int):
        from repro_torch.runtime import graphs

        cache = graphs.owner_cache(model, NMT_GRAPH_KEYS)
        self.inputs = _map(torch.clone, args)
        if make_state is None:
            self.prep, state = None, self.inputs[0]
        else:
            self.prep = cache.capture(lambda: make_state(*self.inputs))
            state = self.prep.outputs
            graphs.copy_into(self.inputs, args)
            self.prep.replay()          # a real state for the step's warm-up
        bos = torch.full((batch,), BOS_ID, dtype=torch.int32,
                         device=model.device)
        self.loop = GreedySteps(model.decode_step, state, bos, width)
        self.step = cache.capture(self.loop.step, static=self.loop.static())

    def run(self, args, steps: int):
        from repro_torch.runtime import graphs, telemetry

        with telemetry.span("repro_torch.nmt.prep"):
            graphs.copy_into(self.inputs, args)
            if self.prep is not None:
                self.prep.replay()
        with telemetry.span("repro_torch.nmt.steps", steps=steps):
            self.loop.start(torch.full_like(self.loop.tok, BOS_ID))
            self.step.replay(steps)
        return self.loop.cols[:, :steps]


def _decode_to_host(model, kind: str, make_state, args, batch: int,
                    forced_len):
    """Greedy decode of the state ``make_state(*args)`` makes (a copy of
    ``args[0]`` when ``make_state`` is None), then the one transfer off the
    device (it waits for the last kernel).  The fused translate and the
    split decode leg both end here, so they run the same operations.

    On the card (outside ``graphs.eager()``) the state and the steps come
    from CUDA graphs kept per ``(kind, shapes of args, width)``: the
    state's graph replays once, the step's ``steps`` times, with no host
    sync between; elsewhere the same step runs in a Python loop."""
    from repro_torch.runtime import graphs, telemetry

    steps = forced_len if forced_len is not None else \
        model.cfg.max_decode_len
    if graphs.active(model.device):
        width = max(model.cfg.max_decode_len, steps, 1)
        key = (kind, graphs.signature(args), width)
        with telemetry.span("repro_torch.nmt.graphs"):
            entry = graphs.owner_cache(model, NMT_GRAPH_KEYS).get(
                key, lambda: _DecodeGraphs(model, make_state, args, batch,
                                           width))
        cols = entry.run(args, steps)
        with telemetry.span("repro_torch.nmt.columns"):
            lengths, toks = greedy_columns(cols,
                                           forced=forced_len is not None)
            both = torch.cat([lengths[:, None], toks], dim=1)
    else:
        with telemetry.span("repro_torch.nmt.prep"):
            state = (_map(torch.clone, args[0]) if make_state is None
                     else make_state(*args))
        with telemetry.span("repro_torch.nmt.steps", steps=steps):
            lengths, toks = batched_greedy_decode(
                model.decode_step, state, batch,
                model.cfg.max_decode_len, forced_len, device=model.device)
        with telemetry.span("repro_torch.nmt.columns"):
            both = torch.cat([lengths[:, None], toks], dim=1)
    with telemetry.span("repro_torch.nmt.fetch"):
        host = both.cpu().numpy()
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
    from repro_torch.runtime import graphs, telemetry

    def encode(src_t, mask_t):
        return (encode_data(src_t, mask_t),
                (mask_t > 0).sum(dim=-1, dtype=torch.int32))

    def encode_states(src, src_mask=None):
        with torch.inference_mode():
            with telemetry.span("repro_torch.nmt.upload"):
                src_t, mask_t = _as_device_batch(model, src, src_mask)
            if graphs.active(model.device):
                with telemetry.span("repro_torch.nmt.graphs"):
                    entry = graphs.owner_cache(model, NMT_GRAPH_KEYS).get(
                        ("encode", graphs.signature((src_t, mask_t))),
                        lambda: _EncodeGraph(model, encode,
                                             (src_t, mask_t)))
                with telemetry.span("repro_torch.nmt.prep"):
                    data, lens = entry.run((src_t, mask_t))
            else:
                with telemetry.span("repro_torch.nmt.prep"):
                    data, lens = encode(src_t, mask_t)
        return EncoderStates(data, lens)

    return encode_states


class _EncodeGraph:
    """The encode leg's graph of one shape: static inputs, the encoder's
    graph, and fresh copies of its outputs for each call (the caller keeps
    the states past the next call)."""

    def __init__(self, model, encode, args):
        from repro_torch.runtime import graphs

        self.inputs = _map(torch.clone, args)
        self.graph = graphs.owner_cache(model, NMT_GRAPH_KEYS).capture(
            lambda: encode(*self.inputs))

    def run(self, args):
        from repro_torch.runtime import graphs

        graphs.copy_into(self.inputs, args)
        self.graph.replay()
        return _map(torch.clone, self.graph.outputs)


def build_decode_from_states(model, state_from_data):
    """Shared scaffolding behind the models' ``make_decode_from_states``.

    ``state_from_data(data) -> batched decode state`` rebuilds the
    model's decode-step carry from the shipped :class:`EncoderStates`
    payload (the transformer re-derives its cross-attention K/V cache
    decoder-side so only the raw memory crosses the wire); None (the
    RNNs) means the payload is the carry, which the decode advances in a
    copy.  The states are first moved to the model's device.  The decode
    itself is the batched greedy loop the fused path runs, so
    ``decode_from_states(encode_states(src, mask))`` equals
    ``make_translate_batched()(src, mask)`` bit for bit on one device.
    Returns ``(lengths (B,), tokens (B, steps))`` numpy int32.
    """
    from repro_torch.runtime import telemetry

    def decode_from_states(states: EncoderStates, forced_len=None):
        with telemetry.span("repro_torch.nmt.upload"):
            states = states.to(model.device)
        with torch.inference_mode():
            return _decode_to_host(model, "decode", state_from_data,
                                   (states.data,), states.batch, forced_len)

    return decode_from_states


def build_translate_batched(model, make_state, *, compiled: bool = True):
    """Shared scaffolding behind the models' ``make_translate_batched``.

    ``make_state(src (B,N), src_mask (B,N)) -> batched decode state`` is
    the only model-specific piece (encode + state assembly); stepping is
    ``model.decode_step`` with a leading batch dim.  ``compiled=True``
    is the batched device loop, on the card the reference's compiled
    decode in its port's form: the state from one CUDA graph and every
    step a replay of another (:func:`_decode_to_host`);
    ``compiled=False`` is the per-sequence host loop (the
    paper-faithful, linear-in-M timing path), eager everywhere.  Both return
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

    from repro_torch.runtime import telemetry

    def translate_batch(src, src_mask=None, forced_len=None):
        with torch.inference_mode():
            with telemetry.span("repro_torch.nmt.upload"):
                src_t, mask_t = _as_device_batch(model, src, src_mask)
            return _decode_to_host(model, "translate", make_state,
                                   (src_t, mask_t), src_t.shape[0],
                                   forced_len)

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


def cross_entropy(logits, targets, mask):
    """Masked token-mean CE. logits (…,V), targets (…), mask (…).

    The divisor is ``max(mask.sum(), 1)``, as the reference's."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)
