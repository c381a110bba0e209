"""LM serving: greedy batched generation and the engine's executor factory.

Port of the LM half of ``repro/runtime/serving.py``.

:class:`GenerationSession` serves a :class:`~repro_torch.models.model.LM`
(its weights live in the module).  Decode has two paths:

* **device loop** (default): prefill once, then the shared
  :func:`~repro_torch.nmt.common.scan_greedy_steps` over all ``max_new``
  decode steps with the EOS ``done`` mask kept on the device and ONE
  transfer to the host at the end (the reference's single ``lax.scan``
  dispatch);
* **host loop** (``host_loop=True``): the per-token loop, one scalar
  sync per step for its early exit — the paper-faithful timing path
  (§II-A), kept for characterization runs.

Batches are padded to a power-of-two size (the reference's shape
buckets, kept so a later CUDA-graph decode meets few shapes).  Plans with
a recurrent mixer (mamba2, rwkv6) take no ragged prefill — their carried
state would fold right-padding in — so only the batch is padded for them,
and the batched executor runs one sub-batch per distinct prompt length.

:func:`build_executor` is the one factory for the executor shapes a
:class:`~repro_torch.runtime.engine.Tier` accepts: ``kind="solo"``
(per-request), ``kind="batched"`` (one drained ``TokenBatcher`` block per
call), ``kind="raw"`` (pass-through, to apply ``faults=``).  ``kind=
"split"`` needs the RNN models' ``EncoderStates`` legs, which come in a
later slice.  :class:`ContinuousGenerationSession` and the sharded
sessions are not ported yet.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.tokenizer import PAD_ID
from repro_torch.nmt.common import greedy_update, scan_greedy_steps

# mixers whose decode caches are position-masked per sequence (slot ==
# position, mask idx <= pos), making right-padded ragged prefill exact
_POSITION_MASKED_MIXERS = ("attn", "mla", "shared_attn")


def _ragged_plan_ok(model) -> bool:
    return all(g.mixer in _POSITION_MASKED_MIXERS
               for g in model.cfg.layer_plan)


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


def build_executor(session_or_executor, *, kind: str = "solo",
                   max_new: int = 16, vocab_clip: Optional[int] = None,
                   faults=None, fault_message: str = "injected tier fault"):
    """The one factory for the executor shapes a Tier accepts.

    * ``"solo"`` — a :class:`GenerationSession` in; the per-request
      ``executor(tokens) -> (m_out, out_tokens)`` out.
    * ``"batched"`` — the same in; the real batched ``executor(batch,
      lengths=None) -> [(m_out, tokens), ...]`` the engine's
      ``submit_batch`` drives (``Tier.batched_executor``).
    * ``"raw"`` — an executor callable in, passed through (to apply
      ``faults=``).
    * ``"split"`` — not ported yet (it needs the NMT models'
      ``EncoderStates`` legs).

    ``faults`` wraps the result with deterministic fault injection (see
    :class:`TierFaultError`); the wrapper exposes ``.calls``.
    """
    if kind == "solo":
        executor = _solo_executor(session_or_executor, max_new=max_new,
                                  vocab_clip=vocab_clip)
    elif kind == "batched":
        executor = _batched_executor(session_or_executor, max_new=max_new,
                                     vocab_clip=vocab_clip)
    elif kind == "raw":
        if not callable(session_or_executor):
            raise ValueError("kind='raw' expects an executor callable")
        executor = session_or_executor
    elif kind == "split":
        raise NotImplementedError(
            "kind='split' needs the EncoderStates legs of the NMT models, "
            "which come with the RNN slice of the port")
    else:
        raise ValueError(
            f"kind must be 'solo'|'batched'|'split'|'raw', got {kind!r}")
    if faults is not None:
        executor = _faulty_wrap(executor, faults, message=fault_message)
    return executor


class GenerationSession:
    """Greedy batched generation over an LM's prefill and decode_step.

    ``host_loop=True`` selects the per-token loop (the paper-faithful,
    linear-in-M timing path); the default keeps ``done`` on the device
    and syncs once at the end.  The batch is padded to a power of two,
    and for position-masked plans the prompt width as well (ragged
    prefill with true ``lengths``).
    """

    def __init__(self, model, *, max_len: int = 64, host_loop: bool = False):
        self.model = model
        self.max_len = max_len
        self.host_loop = host_loop
        self._ragged_ok = _ragged_plan_ok(model)

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
                 lengths: Optional[Sequence[int]] = None) -> np.ndarray:
        """tokens (B,S) -> generated (B, <=max_new) int32, PAD after each
        row's EOS; trailing all-PAD columns trimmed (width >= 1 kept)."""
        lens, out = self.generate_with_lengths(tokens, max_new=max_new,
                                               lengths=lengths)
        width = int(min(max(int(lens.max()) + 1, 1), out.shape[1]))
        return out[:, :width]

    def generate_with_lengths(
            self, tokens: np.ndarray, *, max_new: int = 16,
            lengths: Optional[Sequence[int]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """tokens (B,S) -> (lengths (B,), tokens (B,max_new)) numpy int32.

        ``lengths`` out counts each row's pre-EOS tokens (the paper's M);
        the token block keeps the EOS and is PAD-masked after it.
        ``lengths`` in marks true prompt lengths in a right-padded batch
        (position-masked plans only).
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
        tokens, lens_in = self._bucket_pad(tokens, lens_in, max_new)
        dev = self.model.device
        with torch.inference_mode():
            logits, state = self.model.prefill(
                torch.as_tensor(tokens, device=dev), max_len=self.max_len,
                lengths=None if lens_in is None
                else torch.as_tensor(lens_in, device=dev))
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

