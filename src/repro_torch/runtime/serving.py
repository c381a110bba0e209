"""LM serving: greedy batched generation, continuous in-flight batching
and the engine's executor factory.

Port of the LM half of ``repro/runtime/serving.py``.

:class:`GenerationSession` serves a :class:`~repro_torch.models.model.LM`
(its weights live in the module).  Decode has two paths:

* **device loop** (default): prefill once, then ``max_new - 1`` steps
  of the shared :class:`~repro_torch.nmt.common.GreedySteps` with the
  EOS bookkeeping on the device and ONE transfer to the host at the end.
  On the card each step is a replay of one CUDA graph, captured per
  (``max_len``, state shapes: the padded batch, the plan and whisper's
  frame count) over a persistent decode state, and the prefill is a
  replay of one graph per prompt block (its shape, whether it is ragged,
  the frames' shape), which writes that state and the first token in
  place (``repro_torch.runtime.graphs``; the reference's jitted prefill
  and single ``lax.scan`` dispatch; a sharded LM's collectives are
  captured with the rest); on the CPU and under ``graphs.eager()`` the
  prefill runs eagerly and a Python loop runs the same step;
* **host loop** (``host_loop=True``): the per-token loop, one scalar
  sync per step for its early exit — the paper-faithful timing path
  (§II-A), kept for characterization runs.

Batches are padded to a power-of-two size (the reference's shape
buckets, so the step graphs meet few shapes).  MLA plans
(deepseek-v3) are position-masked like attention: their latent caches
(``ckv``, ``kpe``) take ragged prefill and ride the same row copies.  In
an MoE plan whose capacity drops assignments, the padding rows (and a
slot table's free slots) share the decode step's routing group with the
real rows and can move their outputs, as in the reference.  Plans with
a recurrent mixer (mamba2, rwkv6) take no ragged prefill — their carried
state would fold right-padding in — so only the batch is padded for them,
and the batched executor runs one sub-batch per distinct prompt length.

:class:`ContinuousGenerationSession` is continuous in-flight batching
over a persistent slot table of ``max_slots`` sequences on the model's
device: one decode step over the whole table per ``step()`` (on the
card a replay of the session's one CUDA graph of it), finished
rows evicted between steps, queued prompts prefilled into the freed
slots of the live batch (one bucketed ``prefill`` per admission wave,
its real rows copied into the resident state; on the card a replay of
one graph per wave key), and tokens streamed out per step.  EOS bookkeeping is the same
:func:`~repro_torch.nmt.common.greedy_update` the device loop uses.

:func:`build_executor` is the one factory for the executor shapes a
:class:`~repro_torch.runtime.engine.Tier` accepts: ``kind="solo"``
(per-request), ``kind="batched"`` (one drained ``TokenBatcher`` block per
call), ``kind="split"`` (the two legs of a split placement over an NMT
model's ``EncoderStates``), ``kind="raw"`` (pass-through, to apply
``faults=``).  A continuous session goes to a tier as its
``continuous_session``.

Both sessions serve a sharded LM
(:class:`~repro_torch.runtime.sharded.ShardedLM`, built by
:func:`~repro_torch.runtime.sharded.make_sharded_session`) as they serve
an LM, graphs included: it takes and returns the whole batch on every
rank, and the slot table's admission copies rows through the model's
``copy_rows``.
"""

from __future__ import annotations

import warnings
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.tokenizer import PAD_ID
from repro_torch.nmt.common import (
    GreedySteps,
    greedy_columns,
    greedy_update,
    scan_greedy_steps,
)
from repro_torch.runtime import graphs

# mixers whose decode caches are position-masked per sequence (slot ==
# position, mask idx <= pos), making right-padded ragged prefill exact
_POSITION_MASKED_MIXERS = ("attn", "mla", "shared_attn")


# step-graph keys an LM keeps for GenerationSession: each holds a decode
# state (a KV cache of B x max_len slots a layer)
SESSION_GRAPH_KEYS = 4
# prefill graphs a GenerationSession key keeps, one per prompt block shape
# (a recurrent plan's exact widths make one per prompt length)
SESSION_PREFILL_KEYS = 8
# admission-wave graphs a slot table keeps, one per (batch, width, ragged)
WAVE_GRAPH_KEYS = 16


def _ragged_plan_ok(model) -> bool:
    return all(g.mixer in _POSITION_MASKED_MIXERS
               for g in model.cfg.layer_plan)


def _graphs_on(model) -> bool:
    """Whether ``model``'s decode steps replay CUDA graphs: on the card,
    outside ``graphs.eager()``, for a model that says it is
    ``graph_safe``: an LM, and a sharded LM, whose NCCL collectives a
    graph captures; not the LM inside a sharded one, whose calls alone
    would not cut the batch."""
    return graphs.active(model.device) and getattr(model, "graph_safe",
                                                   False)


def make_prefill_step(model, *, max_len: Optional[int] = None) -> Callable:
    """prefill_step(tokens[, lengths][, frames]) -> (last_logits,
    decode_state): the unit the dry-run prices for prefill_32k.  The
    reference's step also takes ``params``; the port's weights live in
    the model."""

    def prefill_step(tokens, lengths=None, frames=None):
        kw = {"frames": frames} if frames is not None else {}
        return model.prefill(tokens, max_len=max_len, lengths=lengths, **kw)

    return prefill_step


def make_serve_step(model) -> Callable:
    """serve_step(state, tokens (B,1)) -> (logits (B,V), state): ONE new
    token per sequence against the fixed-capacity decode state, the unit
    the dry-run prices for decode_32k / long_500k."""

    def serve_step(state, tokens):
        return model.decode_step(state, tokens)

    return serve_step


def _next_pow2(n: int, floor: int = 1) -> int:
    return max(floor, 1 << (max(n, 1) - 1).bit_length())


class TierFaultError(RuntimeError):
    """A tier executor crashed (or was made to crash by injection).

    The engine's failover loop treats ANY exception escaping ``Tier.run``
    as a tier-down signal; this named type lets fault-injection wrappers
    and tests raise and catch something more specific.
    """


def _faulty_wrap(executor: Callable, should_fail,
                 *, message: str = "injected tier fault") -> Callable:
    """Wrap a real tier executor with deterministic fault injection.

    ``should_fail`` is a ``Callable[[int], bool]`` of the 0-based call
    index or a collection of call indices.  A failing call raises
    :class:`TierFaultError` instead of executing; ``.calls`` counts
    ``{"n": total, "faults": raised}``.
    """
    if not callable(should_fail):
        wanted = frozenset(int(i) for i in should_fail)
        should_fail = wanted.__contains__
    calls = {"n": 0, "faults": 0}

    def faulty(*args, **kwargs):
        i = calls["n"]
        calls["n"] += 1
        if should_fail(i):
            calls["faults"] += 1
            raise TierFaultError(f"{message} (call {i})")
        return executor(*args, **kwargs)

    faulty.calls = calls
    return faulty


def _clip(tokens, vocab_clip: Optional[int]) -> np.ndarray:
    toks = np.asarray(tokens, np.int32)
    return toks if vocab_clip is None else np.minimum(toks, vocab_clip - 1)


def _solo_executor(session: "GenerationSession", *, max_new: int = 16,
                   vocab_clip: Optional[int] = None) -> Callable:
    """Per-request ``executor(tokens) -> (m_out, out_tokens)``; ``m_out``
    is the true pre-EOS output length."""

    def executor(tokens: np.ndarray):
        lens, out = session.generate_with_lengths(
            _clip(tokens, vocab_clip)[None, :], max_new=max_new)
        m = int(lens[0])
        return m, out[0, :max(m, 1)]

    return executor


def _batched_executor(session: "GenerationSession", *, max_new: int = 16,
                      vocab_clip: Optional[int] = None) -> Callable:
    """Real batched ``executor(batch, lengths=None) -> [(m_out, tokens),
    ...]`` over one padded (b, width) block; ``lengths`` defaults to the
    width minus each row's trailing PADs."""

    def executor(batch: np.ndarray, lengths: Optional[Sequence[int]] = None):
        toks = _clip(batch, vocab_clip)
        if toks.ndim != 2:
            raise ValueError("batched executor expects a (b, width) block")
        if lengths is None:
            real = toks != PAD_ID
            trailing = np.where(real.any(1), np.argmax(real[:, ::-1], axis=1),
                                toks.shape[1])
            lens_in = np.maximum(toks.shape[1] - trailing, 1).astype(np.int32)
        else:
            lens_in = np.asarray(lengths, np.int32)
        if session.supports_ragged or np.all(lens_in == toks.shape[1]):
            m_out, out = session.generate_with_lengths(
                toks, max_new=max_new, lengths=lens_in)
            return [(int(m), out[i, :max(int(m), 1)])
                    for i, m in enumerate(m_out)]
        # recurrent-state plans take no ragged right-padding: one uniform
        # (trimmed) sub-batch per distinct length
        results: List[Optional[tuple]] = [None] * toks.shape[0]
        for length in np.unique(lens_in):
            rows = np.flatnonzero(lens_in == length)
            m_out, out = session.generate_with_lengths(
                toks[rows, :int(length)], max_new=max_new)
            for j, r in enumerate(rows):
                results[r] = (int(m_out[j]), out[j, :max(int(m_out[j]), 1)])
        return results

    return executor


def _split_executors(model, *, vocab_clip: Optional[int] = None
                     ) -> Tuple[Callable, Callable]:
    """Adapt an NMT model into the two LEGS of a split placement.

    Returns ``(encode_executor, decode_executor)`` for
    :class:`~repro_torch.runtime.engine.Tier`:

    * ``encode_executor(tokens) -> EncoderStates`` runs just the encoder
      (1-D int token array in, states on the model's device out);
    * ``decode_executor(states) -> (m_out, out_tokens)`` moves the states
      onto its model's device and runs the batched greedy decode.

    ``decode_executor(encode_executor(t))`` is bit for bit the fused
    ``make_translate_batched`` path on one device — splitting is a
    placement choice, never a quality change.  Give the encode tier the
    first and the decode tier the second; a tier serving both legs of
    different requests can carry both.
    """
    encode_states = model.make_encode_states()
    decode_from_states = model.make_decode_from_states()

    def encode_executor(tokens: np.ndarray):
        return encode_states(_clip(tokens, vocab_clip)[None, :])

    def decode_executor(states):
        lens, out = decode_from_states(states)
        m = int(lens[0])
        return m, out[0, :max(m, 1)]

    return encode_executor, decode_executor


def build_executor(session_or_model, *, kind: str = "solo",
                   max_new: int = 16, vocab_clip: Optional[int] = None,
                   faults=None, fault_message: str = "injected tier fault"):
    """The one factory for the executor shapes a Tier accepts.

    * ``"solo"`` — a :class:`GenerationSession` in; the per-request
      ``executor(tokens) -> (m_out, out_tokens)`` out.
    * ``"batched"`` — the same in; the real batched ``executor(batch,
      lengths=None) -> [(m_out, tokens), ...]`` the engine's
      ``submit_batch`` drives (``Tier.batched_executor``).
    * ``"split"`` — an NMT model in (its weights live in it, so no
      ``params=``); the ``(encode_executor, decode_executor)`` pair of a
      split placement out (``Tier.encode_executor`` /
      ``Tier.decode_executor``).
    * ``"raw"`` — an executor callable in, passed through (to apply
      ``faults=``).

    ``faults`` wraps the result with deterministic fault injection (see
    :class:`TierFaultError`); the wrapper exposes ``.calls``.  It composes
    with every kind except ``"split"`` (two legs — wrap each leg with
    ``kind="raw"``).
    """
    if kind == "solo":
        executor = _solo_executor(session_or_model, max_new=max_new,
                                  vocab_clip=vocab_clip)
    elif kind == "batched":
        executor = _batched_executor(session_or_model, max_new=max_new,
                                     vocab_clip=vocab_clip)
    elif kind == "raw":
        if not callable(session_or_model):
            raise ValueError("kind='raw' expects an executor callable")
        executor = session_or_model
    elif kind == "split":
        if faults is not None:
            raise ValueError(
                "faults= does not compose with kind='split' (two legs); "
                "wrap each leg via build_executor(leg, kind='raw', "
                "faults=...)")
        if not hasattr(session_or_model, "make_encode_states"):
            raise ValueError(
                "kind='split' expects an NMT model with make_encode_states, "
                f"got {type(session_or_model).__name__}")
        return _split_executors(session_or_model, vocab_clip=vocab_clip)
    else:
        raise ValueError(
            f"kind must be 'solo'|'batched'|'split'|'raw', got {kind!r}")
    if faults is not None:
        executor = _faulty_wrap(executor, faults, message=fault_message)
    return executor


def _warn_deprecated(old: str, new: str) -> None:
    warnings.warn(f"{old} is deprecated; use {new}", DeprecationWarning,
                  stacklevel=3)


def make_tier_executor(session, *, max_new: int = 16,
                       vocab_clip: Optional[int] = None) -> Callable:
    """Deprecated alias for ``build_executor(session, kind='solo')``."""
    _warn_deprecated("make_tier_executor",
                     "build_executor(session, kind='solo')")
    return build_executor(session, kind="solo", max_new=max_new,
                          vocab_clip=vocab_clip)


def make_batched_tier_executor(session, *, max_new: int = 16,
                               vocab_clip: Optional[int] = None) -> Callable:
    """Deprecated alias for ``build_executor(session, kind='batched')``."""
    _warn_deprecated("make_batched_tier_executor",
                     "build_executor(session, kind='batched')")
    return build_executor(session, kind="batched", max_new=max_new,
                          vocab_clip=vocab_clip)


def make_split_tier_executors(model, params=None, *,
                              vocab_clip: Optional[int] = None
                              ) -> Tuple[Callable, Callable]:
    """Deprecated alias for ``build_executor(model, kind='split')``.
    ``params`` is the reference's argument; the port's weights live in
    the model, so it must be None."""
    _warn_deprecated("make_split_tier_executors",
                     "build_executor(model, kind='split', params=...)")
    if params is not None:
        raise ValueError("the port's models hold their weights: pass no "
                         "params")
    return build_executor(model, kind="split", vocab_clip=vocab_clip)


def make_faulty_executor(executor: Callable, should_fail,
                         *, message: str = "injected tier fault") -> Callable:
    """Deprecated alias for ``build_executor(executor, kind='raw',
    faults=...)``."""
    _warn_deprecated("make_faulty_executor",
                     "build_executor(executor, kind='raw', faults=...)")
    return build_executor(executor, kind="raw", faults=should_fail,
                          fault_message=message)


class GenerationSession:
    """Greedy batched generation over an LM's prefill and decode_step.

    ``host_loop=True`` selects the per-token loop (the paper-faithful,
    linear-in-M timing path, eager everywhere); the default keeps the
    EOS bookkeeping on the device, replays one CUDA graph a step on the
    card and syncs once at the end.  The batch is padded to a power of two,
    and for position-masked plans the prompt width as well (ragged
    prefill with true ``lengths``).
    """

    def __init__(self, model, *, max_len: int = 64, host_loop: bool = False):
        self.model = model
        self.max_len = max_len
        self.host_loop = host_loop
        self._ragged_ok = _ragged_plan_ok(model)
        self._decode_keys: dict = {}    # prefill key -> its decode key

    @property
    def supports_ragged(self) -> bool:
        """True when ragged right-padded prompts are exact for this plan."""
        return self._ragged_ok

    def _step(self, state, tok):
        """``scan_greedy_steps``'s contract: tokens (B,) -> (state, logits)."""
        logits, state = self.model.decode_step(state, tok[:, None])
        return state, logits

    # ------------------------------------------------------------ public --
    def generate(self, tokens: np.ndarray, *, max_new: int = 16,
                 frames: Optional[np.ndarray] = None,
                 lengths: Optional[Sequence[int]] = None) -> np.ndarray:
        """tokens (B,S) -> generated (B, <=max_new) int32, PAD after each
        row's EOS; trailing all-PAD columns trimmed (width >= 1 kept)."""
        lens, out = self.generate_with_lengths(tokens, max_new=max_new,
                                               frames=frames,
                                               lengths=lengths)
        width = int(min(max(int(lens.max()) + 1, 1), out.shape[1]))
        return out[:, :width]

    def generate_with_lengths(
            self, tokens: np.ndarray, *, max_new: int = 16,
            frames: Optional[np.ndarray] = None,
            lengths: Optional[Sequence[int]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """tokens (B,S) -> (lengths (B,), tokens (B,max_new)) numpy int32.

        ``lengths`` out counts each row's pre-EOS tokens (the paper's M);
        the token block keeps the EOS and is PAD-masked after it.
        ``lengths`` in marks true prompt lengths in a right-padded batch
        (position-masked plans only).  ``frames`` (B,T,D) feed an
        encoder-decoder's encoder; as in the reference, the batch is then
        not padded to a shape bucket and prefill takes no ``lengths``.
        """
        tokens = np.asarray(tokens, np.int32)
        b, s = tokens.shape
        if s + max_new > self.max_len:
            raise ValueError("exceeds session capacity")
        lens_in = None if lengths is None else np.asarray(lengths, np.int32)
        if lens_in is not None and not self._ragged_ok:
            if np.all(lens_in == s):
                lens_in = None           # uniform full width: nothing ragged
            else:
                raise ValueError(
                    "ragged prompt lengths need position-masked mixers "
                    f"(plan has {[g.mixer for g in self.model.cfg.layer_plan]})")
        if frames is None:
            tokens, lens_in = self._bucket_pad(tokens, lens_in, max_new)
        else:
            # the LM casts to its dtype; the encoder's frame mask is all
            # ones, a key prefix, so nothing is left to check on the device
            lens_in = None
            frames = torch.as_tensor(frames)
        graph = not self.host_loop and max_new > 0 and \
            _graphs_on(self.model)
        with torch.inference_mode():
            logits, state, entry = self._prefill(tokens, lens_in, frames,
                                                 graph=graph)
            if entry is not None:
                lens_out, out = greedy_columns(entry.run(max_new),
                                               keep_eos=True)
            else:
                tok0 = torch.argmax(logits, dim=-1).to(torch.int32)
                if self.host_loop:
                    lens_out, out = self._host_decode(state, tok0, max_new)
                else:
                    lens_out, out = scan_greedy_steps(
                        self._step, state, tok0, tok0.shape[0], max_new,
                        keep_eos=True)
            # the one transfer off the device; it waits for the last kernel
            host = torch.cat([lens_out[:, None], out], dim=1).cpu().numpy()
        return host[:b, 0], host[:b, 1:]

    # ----------------------------------------------------------- helpers --
    def _prefill(self, tokens: np.ndarray, lens_in, frames, *,
                 graph: bool):
        """The prefill of a bucketed block: (last logits, decode state,
        the step-graph entry whose state it is, or None).

        With ``graph`` the block's prefill graph writes the state and the
        first token of its decode key's entry (the model's, shared by its
        sessions) in place; the logits and the state are the graphs'
        buffers, rewritten by the next call.  A block shape's first call
        captures its prefill and makes the call real
        (``GraphCache.run_and_capture``; a new decode key runs one eager
        prefill more, which gives the state its buffers)."""
        dev = self.model.device
        if not graph:
            logits, state = self.model.prefill(
                torch.as_tensor(tokens, device=dev), max_len=self.max_len,
                lengths=None if lens_in is None
                else torch.as_tensor(lens_in, device=dev),
                frames=None if frames is None else frames.to(dev))
            return logits, state, None
        cache = graphs.owner_cache(self.model, SESSION_GRAPH_KEYS)
        pkey = (tokens.shape, lens_in is not None,
                None if frames is None else (tuple(frames.shape),
                                             frames.dtype))
        dkey = self._decode_keys.get(pkey)
        entry = None if dkey is None else cache.peek(dkey)
        if entry is None:
            # the decode key of this block's state (another session of
            # the model may have made its entry and this block's graph)
            # (a sharded LM's state is the rank's block: the batch is
            # named, since two batches may leave blocks of one shape)
            _, state, _ = self._prefill(tokens, lens_in, frames, graph=False)
            b = tokens.shape[0]
            dkey = ("generate", self.max_len, b, graphs.signature(state))
            entry = cache.get(dkey, lambda: _SessionGraph(
                cache, self._step, state, b, self.max_len))
            self._decode_keys[pkey] = dkey
        block = entry.prefills.peek(pkey)
        if block is None:
            block = entry.prefills.get(pkey, lambda: _PrefillGraph(
                entry, self.model, self.max_len, tokens, lens_in, frames))
            return block.first, entry.loop.state, entry
        block.load(tokens, lens_in, frames)
        block.graph.replay()
        return block.graph.outputs, entry.loop.state, entry

    def _bucket_pad(self, tokens, lens_in, max_new):
        """Pad (b, s) up to the shape bucket; returns (tokens, lengths)."""
        b, s = tokens.shape
        bb = _next_pow2(b)
        if self._ragged_ok:
            sb = max(min(_next_pow2(s, floor=8), self.max_len - max_new), s)
            if lens_in is None:
                lens_in = np.full((b,), s, np.int32)
        else:
            sb = s                       # recurrent state: exact width only
        if (bb, sb) != (b, s):
            padded = np.full((bb, sb), PAD_ID, np.int32)
            padded[:b, :s] = tokens
            tokens = padded
            if lens_in is not None:
                lens_in = np.concatenate(
                    [lens_in, np.ones((bb - b,), np.int32)])
        return tokens, lens_in

    def _host_decode(self, state, tok0, max_new: int):
        """Per-token loop (timing path).  ``done`` stays on the device; the
        early-exit check syncs ONE scalar per step."""
        tok = tok0
        done = torch.zeros_like(tok0, dtype=torch.bool)
        emitted, lives = [], []
        for i in range(max_new):
            emit, live, done = greedy_update(tok, done, keep_eos=True)
            emitted.append(emit)
            lives.append(live)
            if i + 1 == max_new or bool(done.all()):
                break
            logits, state = self.model.decode_step(state, tok[:, None])
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out = torch.full((tok0.shape[0], max_new), PAD_ID, dtype=torch.int32,
                         device=tok0.device)
        out[:, :len(emitted)] = torch.stack(emitted, dim=1)
        return torch.stack(lives, dim=1).sum(dim=1, dtype=torch.int32), out


class _SessionGraph:
    """One GenerationSession key: a decode state (``state``'s buffers,
    adopted), the greedy loop over it (``batch`` rows: the whole batch,
    which a sharded state's block may not show), its step graph and the
    prefill graphs of the prompt blocks that fill it (``prefills``, in
    the owner's pool).  A call replays a prefill, which writes the state
    and the first token, then the step."""

    def __init__(self, cache: graphs.GraphCache, step, state, batch: int,
                 max_len: int):
        pos = state["pos"]
        tok = torch.full((batch,), PAD_ID, dtype=torch.int32,
                         device=pos.device)
        self.loop = GreedySteps(step, state, tok, max_len)
        self.loop.start(tok, first=True)
        self.step = cache.capture(self.loop.step, static=self.loop.static())
        self.prefills = graphs.GraphCache(SESSION_PREFILL_KEYS,
                                          pool_of=cache)

    def run(self, steps: int):
        """The decode after a prefill: ``steps - 1`` step replays; the
        token columns (B, steps)."""
        self.step.replay(steps - 1)
        return self.loop.cols[:, :steps]

    def release(self) -> None:
        self.prefills.clear()
        self.step.release()


class _PrefillGraph:
    """One prompt block of a :class:`_SessionGraph`: its static tokens,
    lengths and frames, and the graph of the prefill that writes the
    entry's decode state (``LM.prefill(into=)``, its checks made on the
    host) and its first token.  Made by the block's first call, which
    captures it and makes that call real (``first``: its logits;
    ``GraphCache.run_and_capture``)."""

    def __init__(self, entry: _SessionGraph, model, max_len: int,
                 tokens, lens_in, frames):
        dev = model.device
        self.tokens = torch.as_tensor(tokens, device=dev).clone()
        self.lengths = (None if lens_in is None
                        else torch.as_tensor(lens_in, device=dev).clone())
        self.frames = None if frames is None else frames.to(dev, copy=True)
        loop = entry.loop

        def prefill():
            logits, _ = model.prefill(
                self.tokens, max_len=max_len, lengths=self.lengths,
                frames=self.frames, check=False, into=loop.state)
            loop.start(torch.argmax(logits, dim=-1).to(torch.int32),
                       first=True)
            return logits

        self.graph, self.first = entry.prefills.run_and_capture(
            prefill, static=loop.static())

    def load(self, tokens, lens_in, frames) -> None:
        """Copy a call's inputs into the static buffers (one host-to-device
        copy each)."""
        self.tokens.copy_(graphs.host_tensor(tokens))
        if lens_in is not None:
            self.lengths.copy_(graphs.host_tensor(lens_in))
        if frames is not None:
            self.frames.copy_(frames)

    def release(self) -> None:
        self.graph.release()


class _WaveGraph:
    """One admission-wave key of a slot table, ``(batch, width, ragged)``:
    static tokens, lengths and row indices, and the graph of the
    reference's jitted ``_prefill`` + ``_write``: the bucketed prefill,
    its rows copied into the resident state (``LM.copy_rows``) and the
    carried token and ``done`` written.  The real rows' slots come first
    in ``rows``; a padding row names the first real row's slot and takes
    that row's values (``src``), so it lands in no other slot, and the
    duplicate writes carry the same bits.  Made by the key's first wave,
    which the capture makes real (``GraphCache.run_and_capture``):
    nothing of the live table is saved or restored."""

    def __init__(self, sess: "ContinuousGenerationSession", block, lengths,
                 slots: List[int]):
        model = sess.model
        dev = model.device
        self.tokens = torch.as_tensor(block, device=dev).clone()
        self.lengths = (None if lengths is None
                        else torch.as_tensor(lengths, device=dev).clone())
        rows, src = _wave_rows(slots, block.shape[0])
        self.rows = torch.as_tensor(rows, device=dev)
        self.src = torch.as_tensor(src, device=dev)

        def wave():
            logits, new = model.prefill(self.tokens, max_len=sess.max_len,
                                        lengths=self.lengths, check=False)
            model.copy_rows(sess._state, new, self.rows, self.src)
            sess._tok.index_copy_(0, self.rows, torch.argmax(
                logits.index_select(0, self.src), dim=-1).to(torch.int32))
            sess._done.index_fill_(0, self.rows, False)

        self.graph, _ = sess._waves.run_and_capture(wave, static=sess._table)

    def load(self, block, lengths, slots: List[int]) -> None:
        """Copy a wave's inputs into the static buffers."""
        self.tokens.copy_(graphs.host_tensor(block))
        if lengths is not None:
            self.lengths.copy_(graphs.host_tensor(lengths))
        rows, src = _wave_rows(slots, self.rows.shape[0])
        self.rows.copy_(graphs.host_tensor(rows))
        self.src.copy_(graphs.host_tensor(src))

    def release(self) -> None:
        self.graph.release()


def _wave_rows(slots: List[int], kp: int):
    """(destination slots, source rows), each (kp,) int64, of a wave of
    ``len(slots)`` real rows padded to ``kp``: padding rows repeat the
    first real row's slot and row."""
    k = len(slots)
    rows = np.asarray(list(slots) + [slots[0]] * (kp - k), np.int64)
    src = np.concatenate([np.arange(k), np.zeros(kp - k)]).astype(np.int64)
    return rows, src


def greedy_margins(model, prompt: np.ndarray, tokens: np.ndarray, *,
                   frames: Optional[np.ndarray] = None) -> np.ndarray:
    """The top-2 logit margin behind each of ``tokens``, a greedy
    continuation of ``prompt`` (1-D): entry i is the margin of the logits
    that chose token i (prefill for i = 0, then one B=1 decode step per
    token, teacher-forced on ``tokens``).  ``frames`` (T, D) feed an
    encoder-decoder's encoder.

    Generations from different batch shapes may round differently in the
    last bits (a GEMM's kernel, a split plan and a query tile all depend
    on the shape), so a token behind a margin near 0 may flip; comparisons
    across batch shapes stop at the first such token."""
    dev = model.device
    toks = np.asarray(tokens, np.int32).reshape(-1)
    out = []
    with torch.inference_mode():
        logits, state = model.prefill(
            torch.as_tensor(np.asarray(prompt, np.int32)[None, :],
                            device=dev),
            max_len=len(prompt) + max(len(toks), 1),
            frames=None if frames is None else torch.as_tensor(
                frames, device=dev)[None])
        for i, t in enumerate(toks):
            top2 = torch.topk(logits[0].float(), 2).values
            out.append(top2[0] - top2[1])
            if i + 1 < len(toks):
                logits, state = model.decode_step(state, torch.full(
                    (1, 1), int(t), dtype=torch.int32, device=dev))
        return torch.stack(out).cpu().numpy() if out else np.zeros(0)


class ContinuousGenerationSession:
    """Continuous in-flight batching over a persistent slot table.

    ``max_slots`` sequences share ONE resident decode state on the model's
    device (capacity ``max_len`` per slot).  The batch is re-formed
    between decode steps:

    * :meth:`step` runs one decode step over the whole slot table, brings
      each slot's emitted token, live flag and done flag to the host in
      one transfer (``max_slots`` scalars each), streams the live slots'
      tokens and EVICTS rows that emitted EOS or used up their
      ``max_new`` budget; their slots free at once.  Free slots step too
      (their rows are done, their output ignored, their ``pos`` grows
      past ``max_len``, where the decode writes nothing);
    * :meth:`admit` PREFILLS queued prompts into free slots of the live
      batch: one bucketed ``LM.prefill(max_len=, lengths=)`` per admission
      wave, and its real rows copied into the resident state (every cache
      tensor at batch axis 1, after the leading layer axis; ``pos``, the
      carried token and ``done`` at axis 0).  The reference scatters the
      batch-padding rows to an out-of-bounds index that JAX drops; here
      only the real rows are copied, and a wave's graph (one per
      ``(batch, width, ragged)``, :class:`_WaveGraph`) writes each
      padding row over the first real row's slot with that row's
      values.

    EOS/done bookkeeping is :func:`repro_torch.nmt.common.greedy_update`
    with ``keep_eos=True``, the semantics of
    :meth:`GenerationSession.generate_with_lengths`, so a row's tokens and
    pre-EOS length are what a solo generate gives, up to the rounding of
    another batch shape (see :func:`greedy_margins`).

    Position-masked plans (attention) admit one bucketed ragged wave per
    call (batch padded to a power of two, width to ``_next_pow2(w, 8)``
    capped at ``max_len - max_new``); recurrent plans (mamba2, rwkv6)
    admit one exact-width wave per distinct prompt length.  The resident
    state starts as ``model.init_decode_state(max_slots, max_len,
    ring=False)``, whose tensors have the shapes every admission prefill
    produces (the reference seeds it with a one-token dummy prefill, which
    leaves a mamba2 conv buffer of the wrong shape).  Under a sliding
    window that is a ring when ``max_len`` equals the window and a linear
    cache of ``max_len`` slots, decoded under the window, when it is
    longer: the reference's dummy prefill gives the same.
    """

    def __init__(self, model, *, max_slots: int = 8, max_len: int = 64,
                 bucket_shapes: bool = True):
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        if model.cfg.is_encoder_decoder:
            raise ValueError("continuous batching needs a decoder-only LM")
        self.model = model
        self.max_slots = max_slots
        self.max_len = max_len
        self.bucket_shapes = bucket_shapes
        self._ragged_ok = _ragged_plan_ok(model)
        # the table's graphs share the pool of the model's session graphs
        pool = lambda: graphs.owner_cache(model, SESSION_GRAPH_KEYS)
        self._graphs = graphs.GraphCache(max_keys=1, pool_of=pool)
        self._waves = graphs.GraphCache(WAVE_GRAPH_KEYS, pool_of=pool)
        self._table = None
        self.reset()

    def reset(self) -> None:
        """Empty the slot table and zero the counters.  The table's
        buffers stay where they are (a fresh state is copied into them),
        so the step graph and the wave graphs stay valid."""
        dev = self.model.device
        with torch.inference_mode():
            fresh = (self.model.init_decode_state(
                self.max_slots, self.max_len, ring=False),
                torch.full((self.max_slots,), PAD_ID, dtype=torch.int32,
                           device=dev),
                torch.ones((self.max_slots,), dtype=torch.bool, device=dev))
            if self._table is None:
                self._state, self._tok, self._done = fresh
                self._out = torch.zeros((3, self.max_slots),
                                        dtype=torch.int32, device=dev)
                self._table = (self._state, self._tok, self._done, self._out)
            else:
                graphs.copy_into(self._table[:3], fresh)
        # host-side slot table
        self._live = np.zeros(self.max_slots, bool)
        self._req: List[object] = [None] * self.max_slots
        self._emitted: List[List[int]] = [[] for _ in range(self.max_slots)]
        self._m = np.zeros(self.max_slots, np.int64)      # pre-EOS count
        self._steps_left = np.zeros(self.max_slots, np.int64)
        self.n_steps = 0
        self.n_prefills = 0
        self.peak_live = 0

    # ---------------------------------------------------------- queries --
    @property
    def supports_ragged(self) -> bool:
        return self._ragged_ok

    @property
    def live_count(self) -> int:
        return int(self._live.sum())

    @property
    def free_slots(self) -> int:
        return self.max_slots - self.live_count

    # ------------------------------------------------------------- admit --
    def admit(self, prompts: Sequence[np.ndarray], *, max_new: int = 16,
              req_ids: Optional[Sequence] = None) -> List[int]:
        """Prefill ``prompts`` into free slots of the LIVE batch.

        Returns the assigned slot indices (one per prompt, in order).
        Raises ``ValueError`` when more prompts than free slots are
        offered (the caller's admission control owns queueing), on a
        prompt that does not fit ``max_len`` with ``max_new``, and on an
        empty prompt; a refused call leaves the table as it was.
        """
        if not prompts:
            return []
        free = np.flatnonzero(~self._live)
        if len(prompts) > len(free):
            raise ValueError(
                f"admit({len(prompts)}) exceeds {len(free)} free slots")
        toks = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
        for t in toks:
            if len(t) + max_new > self.max_len:
                raise ValueError("exceeds session capacity")
            if len(t) == 0:
                raise ValueError("empty prompt")
        if req_ids is None:
            req_ids = list(range(len(prompts)))
        slots = [int(free[j]) for j in range(len(prompts))]

        if self._ragged_ok:
            groups = [list(range(len(toks)))]
        else:                     # recurrent state: exact width per group
            by_len: dict = {}
            for j, t in enumerate(toks):
                by_len.setdefault(len(t), []).append(j)
            groups = [by_len[n] for n in sorted(by_len)]
        for idx in groups:
            self._admit_group([toks[j] for j in idx],
                              [slots[j] for j in idx], max_new)

        for j, s in enumerate(slots):
            self._live[s] = True
            self._req[s] = req_ids[j]
            self._emitted[s] = []
            self._m[s] = 0
            self._steps_left[s] = max_new
        self.peak_live = max(self.peak_live, self.live_count)
        return slots

    def _admit_group(self, toks: List[np.ndarray], slots: List[int],
                     max_new: int) -> None:
        """One prefill wave: pad to the (batch, width) bucket, prefill,
        copy the real rows into the resident slot-table state (on the
        card a replay of the wave's graph, :class:`_WaveGraph`)."""
        k = len(toks)
        w = max(len(t) for t in toks)
        lens = np.asarray([len(t) for t in toks], np.int32)
        uniform = bool(np.all(lens == w))
        if self.bucket_shapes:
            kp = _next_pow2(k)
            wp = (max(min(_next_pow2(w, floor=8), self.max_len - max_new), w)
                  if self._ragged_ok else w)
        else:
            kp, wp = k, w
        block = np.full((kp, wp), PAD_ID, np.int32)
        for j, t in enumerate(toks):
            block[j, :len(t)] = t
        lens_in = np.concatenate([lens, np.ones(kp - k, np.int32)])
        dev = self.model.device
        ragged = self._ragged_ok and not (uniform and kp == k and wp == w)
        if _graphs_on(self.model):
            with torch.inference_mode():
                key = (kp, wp, ragged)
                lengths = lens_in if ragged else None
                wave = self._waves.peek(key)
                if wave is None:
                    self._waves.get(key, lambda: _WaveGraph(
                        self, block, lengths, slots))
                else:
                    wave.load(block, lengths, slots)
                    wave.graph.replay()
            self.n_prefills += 1
            return
        with torch.inference_mode():
            logits, new = self.model.prefill(
                torch.as_tensor(block, device=dev), max_len=self.max_len,
                lengths=torch.as_tensor(lens_in, device=dev) if ragged
                else None)
            self.model.copy_rows(self._state, new, slots)
            rows = torch.as_tensor(slots, dtype=torch.long, device=dev)
            self._tok.index_copy_(0, rows, torch.argmax(
                logits[:k], dim=-1).to(torch.int32))
            self._done.index_fill_(0, rows, False)
        self.n_prefills += 1

    # -------------------------------------------------------------- step --
    def step(self) -> Tuple[List[tuple], List[tuple]]:
        """One in-flight decode step for every live slot.

        Returns ``(stream, finished)``: ``stream`` is the step's tokens
        ``[(req_id, token), ...]`` (EOS included when emitted) and
        ``finished`` the rows evicted this step as ``(req_id, m_out,
        tokens)``, ``m_out`` counting pre-EOS tokens and ``tokens`` the
        emitted array (EOS kept, never PAD-padded).  An empty table is a
        no-op.
        """
        if not self._live.any():
            return [], []
        with torch.inference_mode():
            if _graphs_on(self.model):
                self._graphs.get("table", lambda: self._graphs.capture(
                    self._table_step, static=self._table)).replay()
            else:
                self._table_step()
            # the step's one transfer to the host
            emit, live, done = self._out.cpu().numpy()
        self.n_steps += 1

        stream: List[tuple] = []
        finished: List[tuple] = []
        exhausted = []
        for s in np.flatnonzero(self._live):
            # a live slot entered the step with done=False (EOS and budget
            # rows evict at once), so emit is a real token, possibly one
            # whose id equals PAD_ID
            t = int(emit[s])
            self._emitted[s].append(t)
            stream.append((self._req[s], t))
            self._m[s] += int(live[s])
            self._steps_left[s] -= 1
            if done[s] or self._steps_left[s] <= 0:
                if not done[s]:        # budget out: silence the row too
                    exhausted.append(int(s))
                self._live[s] = False
                finished.append((self._req[s], int(self._m[s]),
                                 np.asarray(self._emitted[s], np.int32)))
                self._req[s] = None
                self._emitted[s] = []
        if exhausted:
            with torch.inference_mode():
                self._done.index_fill_(0, torch.as_tensor(
                    exhausted, device=self._done.device), True)
        return stream, finished

    def _table_step(self) -> None:
        """The decode step over the whole table, on its static buffers:
        ``_tok`` and ``_done`` advanced in place, ``_out`` the emitted
        token, live flag and done flag of every slot (one CUDA graph of it
        on the card)."""
        emit, live, done = greedy_update(self._tok, self._done,
                                         keep_eos=True)
        logits, _ = self.model.decode_step(self._state, self._tok[:, None])
        self._tok.copy_(torch.argmax(logits, dim=-1))
        self._done.copy_(done)
        torch.stack([emit, live.to(torch.int32), done.to(torch.int32)],
                    out=self._out)

    # ------------------------------------------------------------- serve --
    def serve(self, prompts: Sequence[np.ndarray], *, max_new: int = 16,
              refill: bool = True) -> List[Tuple[int, np.ndarray]]:
        """Scheduling-free driver: run ``prompts`` through the slot table.

        ``refill=True`` is continuous mode: freed slots are refilled from
        the queue between steps.  ``refill=False`` is block-to-completion:
        a block of up to ``max_slots`` prompts is admitted only into an
        EMPTY table and runs until every member finishes.  Returns
        ``(m_out, tokens)`` per prompt, in prompt order.
        """
        results: List[Optional[Tuple[int, np.ndarray]]] = \
            [None] * len(prompts)
        head = 0
        while head < len(prompts) or self.live_count:
            can_admit = self.free_slots if (refill or self.live_count == 0) \
                else 0
            take = min(can_admit, len(prompts) - head)
            if take:
                idx = list(range(head, head + take))
                head += take
                self.admit([prompts[i] for i in idx], max_new=max_new,
                           req_ids=idx)
            _, finished = self.step()
            for rid, m, toks in finished:
                results[rid] = (m, toks)
        return results  # type: ignore[return-value]
