"""The composable LM: layer groups assembled into prefill and decode paths.

Port of ``repro/models/model.py`` for every group kind: ``rwkv6/rwkv_cm``
(rwkv6-3b), ``mamba2/none`` and ``shared_attn/dense`` (zamba2-1.2b),
``attn/dense`` with or without qk-norm (qwen3-8b, qwen3-32b,
deepseek-67b, chameleon-34b), ``attn/dense`` with cross-attention behind
a bidirectional encoder (whisper-large-v3), ``attn/moe``
(qwen3-moe-30b-a3b, and moonshot-v1-16b-a3b after its dense first
layer) and ``mla/dense`` + ``mla/moe`` (deepseek-v3-671b), with
deepseek-v3's multi-token-prediction block (``mtp``) and tied
embeddings.  A configuration's ``sliding_window`` (the long-decode
variants of qwen3-8b and zamba2-1.2b) bounds every attention and
shared-attention group.

Structure follows the reference's parameter tree, so the converter maps
it name for name: ``groups[gi][li]`` is layer ``li`` of group ``gi`` (one
module per layer, where the reference stacks a group's layers along a
leading ``count`` axis), and the zamba-style ``shared_attn`` block is
held once and called by every shared group, each call with a KV cache of
its own.  Weights are drawn at construction from a ``torch.Generator``
seeded with ``seed`` on the target device (on the ``meta`` device
nothing is drawn or allocated: shapes only, to size a configuration).

``param_dtype`` (float32 or bfloat16) is the reference's
``LM(param_dtype=)``: matrices in that dtype, norms, biases, decays and
the MoE router in float32 (the layers' constructors hold the rule).  The embedding is read
in ``param_dtype``, so the residual stream, every cache and the logits
are in it; the norms, RoPE, the softmaxes, the router and the scan
kernels compute in float32 and cast back, where the reference does.
Attention runs through the kernels, which take bf16 operands, compute in
float32 and round their output once, where the reference's jnp
attention rounds its scores and weights to the working dtype (ROADMAP
C).
Weights are drawn in float32 and each is cast as it is drawn, so the
bf16 model from a seed is the float32 model from that seed, cast.

``remat=True`` is the reference's ``LM(remat=)``: under autograd each
layer of a group runs under ``torch.utils.checkpoint`` (non-reentrant),
so the backward recomputes the layer's internals and the forward keeps
only the residual stream between layers.  As in the reference (which
checkpoints its scanned groups' bodies), zamba2's shared block, whisper's
encoder and the MTP block are not checkpointed.  The recompute runs in
the backward, outside the forward's contexts: it re-enters the batch
shard a sharded forward installed (``sharding.ctx.recompute_context``),
and under the sharded runtime it gathers the layer's weights again, as
FSDP does.  Gradients equal ``remat=False``'s bitwise.

Entry points:

* ``train_logits(tokens)`` — the full causal forward with no cache, for
  training: attention and both mixers take their differentiable paths
  (the reference's jnp attention and ``mixer_impl="xla"`` chunked scans),
  never a kernel, so autograd runs through it.  Returns ``{"logits",
  "aux_loss"}`` (the sum of the MoE layers' load-balance losses) and,
  with ``mtp_depth``, ``"mtp_logits"``.
* ``prefill(tokens, max_len=, lengths=)`` — full-sequence forward; returns
  the last position's logits and the decode state (KV caches padded to
  ``max_len``, recurrent states, ``pos``).  rwkv6 and mamba2 prefill go
  through the ``rwkv6_wkv`` / ``ssd_scan`` kernels, attention through
  ``flash_attention``.
* ``decode_step(state, tokens)`` — one token per sequence; updates the
  state's caches and ``pos`` in place and returns ``(logits, state)``.
* ``encode(frames, frame_mask)`` — whisper's encoder over precomputed
  frame embeddings (B, T, D): bidirectional self-attention through
  ``flash_attention(causal=False)``.  As the reference's, it applies RoPE
  over frame positions 0..T-1 and attends to every frame, padded ones
  included; only cross-attention reads the mask.  ``train_logits`` and
  ``prefill`` take ``frames=`` / ``frame_mask=`` for an encoder-decoder
  configuration.

The decode state mirrors the reference's: ``{"caches": [one dict per
group, every tensor with a leading count axis], "pos": (B,) int32}``; an
MLA group caches the compressed latent ``{"ckv", "kpe"}``, a
cross-attention group also its frames' ``{"xk", "xv"}`` (at T frames
after prefill, ``max_frames`` in a fresh state), and an encoder-decoder
state carries ``"enc_mask"`` (B, T) float32.  An attention cache is
allocated at ``min(max_len, window)`` slots; an attention group decodes
as a ring cache when its cache is exactly window-sized (a state from
``init_decode_state``, or a prefill whose ``max_len`` is the window) and
as a linear cache with the window mask otherwise.  MoE layers
dispatch within one group per batch row in prefill and training and one
group for the whole batch in decode (the reference's rule), so with a
capacity factor that drops assignments a row's output depends on the
other rows of its batch.

Sharded serving (:mod:`repro_torch.runtime.sharded`) keeps only this
rank's block of each parameter in the module and installs ``unshard``,
a context that makes the given modules' weights whole while they run:
every layer, the embedding and the head run inside ``_whole``.  A
decode step with a sequence shard installed
(:func:`repro_torch.sharding.ctx.decode_seq_shard`) runs each attention
group without cross-attention through
:func:`~repro_torch.models.layers.attention.attn_decode_seq_sharded` on
this rank's slots of its linear cache (the runtime gathers a ring before
the step).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.config import LayerGroup, ModelConfig
from repro_torch.models.layers import attention as att
from repro_torch.models.layers import mamba2 as mb
from repro_torch.models.layers import moe as moe_lib
from repro_torch.models.layers import rwkv6 as rk
from repro_torch.models.layers.basic import (
    Embedding,
    Linear,
    RMSNorm,
    SwiGLU,
    rmsnorm,
)
from repro_torch.sharding import ctx as shard_ctx

NEG_LOGIT = -1e30        # logit of a vocab padding column
_RECURRENT = ("mamba2", "rwkv6")
_ATTENTION = ("attn", "shared_attn")
_ENCODER_GROUP = LayerGroup(mixer="attn", ffn="dense", count=1)


class Block(nn.Module):
    """One layer of group ``g``: mixer + FFN + their norms."""

    def __init__(self, cfg: ModelConfig, g: LayerGroup, *, device,
                 generator, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, generator=generator, dtype=dtype)
        d = cfg.d_model
        self.ln1 = RMSNorm(d, device=device)
        if g.mixer in ("attn", "shared_attn"):
            self.mixer = att.GQA(cfg, cross=g.cross_attn, **kw)
        elif g.mixer == "mamba2":
            self.mixer = mb.Mamba2Mixer(cfg, **kw)
        elif g.mixer == "rwkv6":
            self.mixer = rk.TimeMix(cfg, **kw)
        elif g.mixer == "mla":
            self.mixer = att.MLA(cfg, **kw)
        else:
            raise ValueError(g.mixer)
        if g.cross_attn:
            self.ln_x = RMSNorm(d, device=device)
        if g.ffn != "none":
            self.ln2 = RMSNorm(d, device=device)
        if g.ffn == "dense":
            self.ffn = SwiGLU(d, cfg.d_ff, **kw)
        elif g.ffn == "rwkv_cm":
            self.ffn = rk.ChannelMix(cfg, **kw)
        elif g.ffn == "moe":
            self.ffn = moe_lib.MoE(cfg, **kw)
        elif g.ffn != "none":
            raise ValueError(g.ffn)


def _stack(entries: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([e[k] for e in entries]) for k in entries[0]}


def _write_layer(group: Dict[str, torch.Tensor], li: int,
                 cache: Dict[str, torch.Tensor]) -> None:
    """Write layer ``li``'s prefill cache into a group of a decode state:
    a sequence cache longer than the prompt takes it in its first slots
    and zeros after them (what ``prefill(max_len=)`` pads with)."""
    for name, t in cache.items():
        dst = group[name][li]
        if dst.shape == t.shape:
            dst.copy_(t)
        else:
            s = t.shape[1]
            dst[:, :s].copy_(t)
            dst[:, s:].zero_()


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0,
                 param_dtype=torch.float32, remat: bool = False):
        super().__init__()
        if param_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"param_dtype must be float32 or bfloat16, "
                             f"got {param_dtype}")
        self.cfg = cfg.validate()
        self.param_dtype = param_dtype
        self.remat = remat
        self.unshard = None      # the sharded runtime's per-module gather
        dev = resolve_device(device)
        gen = (None if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(seed))
        kw = dict(device=dev, generator=gen, dtype=param_dtype)
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model, **kw)
        self.final_norm = RMSNorm(cfg.d_model, device=dev)
        if not cfg.tie_embeddings:
            self.lm_head = Linear(cfg.d_model, cfg.padded_vocab, **kw)
        self.groups = nn.ModuleList()
        shared = None
        for g in cfg.layer_plan:
            if g.mixer == "shared_attn":
                # one block, reused by every shared group (its place in
                # ``groups`` stays empty, as the reference's placeholder)
                if shared is None:
                    shared = Block(cfg, g, **kw)
                self.groups.append(nn.ModuleList())
            else:
                self.groups.append(nn.ModuleList(
                    Block(cfg, g, **kw) for _ in range(g.count)))
        if shared is not None:
            self.shared_attn = shared
        if cfg.is_encoder_decoder:
            # whisper's bidirectional encoder: its layers stack along one
            # leaf per name in the reference (``encoder.layers``)
            self.encoder = nn.Module()
            self.encoder.layers = nn.ModuleList(
                Block(cfg, _ENCODER_GROUP, **kw)
                for _ in range(cfg.encoder.num_layers))
            self.encoder.final_norm = RMSNorm(cfg.d_model, device=dev)
        if cfg.mtp_depth:
            # deepseek-v3's depth-1 multi-token prediction: one more block
            # of the last group's kind over [norm(h_t) ; emb(token_t+1)]
            self.mtp = nn.Module()
            self.mtp.proj = Linear(2 * cfg.d_model, cfg.d_model, **kw)
            self.mtp.block = Block(cfg, cfg.layer_plan[-1], **kw)
            self.mtp.norm = RMSNorm(cfg.d_model, device=dev)

    @property
    def device(self) -> torch.device:
        return self.embed.w.device

    @property
    def graph_safe(self) -> bool:
        """Whether a session may capture this LM's calls in CUDA graphs:
        not while a sharded runtime's gather is installed (``unshard``),
        since such an LM is served through its ``ShardedLM``, which
        cuts the batch and may."""
        return self.unshard is None

    def _whole(self, *modules):
        """Context in which ``modules``' weights are whole: the sharded
        runtime's gather (``unshard``) if one is installed."""
        if self.unshard is None:
            return contextlib.nullcontext()
        return self.unshard(*modules)

    def _embed(self, tokens):
        with self._whole(self.embed):
            return self.embed(tokens).to(self.param_dtype)

    # ------------------------------------------------------------ blocks --
    def _ffn(self, p: Block, g: LayerGroup, x, rstate, *, full: bool):
        """The FFN half of a layer; returns (x, rwkv state, MoE aux)."""
        if g.ffn == "none":
            return x, rstate, None
        h = rmsnorm(p.ln2.g, x, self.cfg.norm_eps)
        if g.ffn == "dense":
            return x + p.ffn(h), rstate, None
        if g.ffn == "moe":
            y, aux = moe_lib.moe_ffn(p.ffn, self.cfg, h)
            return x + y, rstate, aux
        y, rstate = (rk.channel_mix_full if full else rk.channel_mix_decode)(
            p.ffn, self.cfg, h, rstate)
        return x + y, rstate, None

    def _block_full(self, p: Block, g: LayerGroup, x, *, kernels: bool,
                    window: Optional[int] = None, causal: bool = True,
                    enc=None):
        """One layer over the full sequence, its mixer through the kernels
        or (``kernels=False``) the training path; ``window`` bounds an
        attention mixer, ``enc`` = (encoder output, frame lengths) feeds a
        cross-attention group.  Returns (x, cache entry, MoE aux or
        None)."""
        cfg = self.cfg
        h = rmsnorm(p.ln1.g, x, cfg.norm_eps)
        rstate = None
        if g.mixer in _ATTENTION:
            y, (k, v) = att.attn_full(p.mixer, cfg, h, window=window,
                                      causal=causal, kernels=kernels)
            cache = {"k": k, "v": v}
            if g.cross_attn:
                enc_out, enc_len = enc
                xk, xv = att.encode_cross_kv(p.mixer, cfg, enc_out)
                x = x + y
                y = att.cross_attn(p.mixer, cfg,
                                   rmsnorm(p.ln_x.g, x, cfg.norm_eps),
                                   xk, xv, enc_len, kernels=kernels)
                cache.update(xk=xk, xv=xv)
        elif g.mixer == "mla":
            y, (ckv, kpe) = att.mla_full(p.mixer, cfg, h)
            cache = {"ckv": ckv, "kpe": kpe}
        elif g.mixer == "mamba2":
            y, st = mb.mamba2_full(p.mixer, cfg, h, kernels=kernels)
            cache = st._asdict()
        else:                                   # rwkv6, from the zero state
            st0 = rk.init_rwkv_state(cfg, x.shape[0], x.dtype, x.device)
            y, rstate = rk.rwkv6_full(p.mixer, cfg, h, st0, kernels=kernels)
        x, rstate, aux = self._ffn(p, g, x + y, rstate, full=True)
        if g.mixer == "rwkv6":
            cache = rstate._asdict()
        return x, cache, aux

    def _block_decode(self, p: Block, g: LayerGroup, x, cache, li: int, pos,
                      enc_len):
        """One layer, one token; writes layer ``li``'s slice of the group's
        cache in place."""
        cfg = self.cfg
        h = rmsnorm(p.ln1.g, x, cfg.norm_eps)
        rstate = None
        if g.mixer in _ATTENTION:
            w = cfg.sliding_window
            seq = shard_ctx.decode_seq_shard()
            if seq is not None and not g.cross_attn:
                # this rank's slots of a linear cache split over seq.group
                y = att.attn_decode_seq_sharded(
                    p.mixer, cfg, h, cache["k"][li], cache["v"][li], pos,
                    group=seq.group, window=w)
            else:
                # a window-sized cache is a ring (the long-decode state)
                ring = bool(w) and cache["k"].shape[2] == w
                y = att.attn_decode(p.mixer, cfg, h, cache["k"][li],
                                    cache["v"][li], pos,
                                    window=None if ring else w, ring=ring)
            if g.cross_attn:
                x = x + y
                y = att.cross_decode(p.mixer, cfg,
                                     rmsnorm(p.ln_x.g, x, cfg.norm_eps),
                                     cache["xk"][li], cache["xv"][li],
                                     enc_len)
        elif g.mixer == "mla":
            y = att.mla_decode(p.mixer, cfg, h, cache["ckv"][li],
                               cache["kpe"][li], pos)
        elif g.mixer == "mamba2":
            y, st = mb.mamba2_decode(p.mixer, cfg, h, mb.MambaState(
                cache["ssm"][li], cache["conv"][li]))
            cache["ssm"][li].copy_(st.ssm)
            cache["conv"][li].copy_(st.conv)
        else:
            y, rstate = rk.rwkv6_decode(p.mixer, cfg, h, rk.RWKVState(
                cache["wkv"][li], cache["shift_tm"][li],
                cache["shift_cm"][li]))
        x, rstate, _ = self._ffn(p, g, x + y, rstate, full=False)
        if rstate is not None:
            for name, value in rstate._asdict().items():
                cache[name][li].copy_(value)
        return x

    def _layers(self, gi: int, g: LayerGroup):
        return [self.shared_attn] if g.mixer == "shared_attn" \
            else self.groups[gi]

    # ----------------------------------------------------------- logits --
    def _logits(self, x):
        cfg = self.cfg
        head = self.embed if cfg.tie_embeddings else self.lm_head
        with self._whole(self.final_norm, head):
            x = rmsnorm(self.final_norm.g, x, cfg.norm_eps)
            logits = (x @ self.embed.w.to(x.dtype).T if cfg.tie_embeddings
                      else self.lm_head(x))
        if cfg.padded_vocab != cfg.vocab_size:
            logits[..., cfg.vocab_size:] = NEG_LOGIT
        return logits

    # ---------------------------------------------------------- encoder --
    def encode(self, frames, frame_mask=None, *, kernels: bool = True):
        """The bidirectional encoder over frame embeddings (B,T,D).
        Returns (encoder output (B,T,D), frame mask (B,T), ones if None).

        As the reference's: RoPE over frame positions 0..T-1, and every
        frame attended to, the padded ones included (the mask is for
        cross-attention only)."""
        b, t, _ = frames.shape
        if frame_mask is None:
            frame_mask = torch.ones((b, t), dtype=torch.float32,
                                    device=frames.device)
        x = frames
        for p in self.encoder.layers:
            with self._whole(p):
                x, _, _ = self._block_full(p, _ENCODER_GROUP, x,
                                           kernels=kernels, causal=False)
        with self._whole(self.encoder.final_norm):
            x = rmsnorm(self.encoder.final_norm.g, x, self.cfg.norm_eps)
        return x, frame_mask

    def _encode_for(self, frames, frame_mask, *, kernels: bool,
                    check: bool = True):
        """((encoder output, frame lengths), frame mask) of an
        encoder-decoder configuration's frames; (None, None) for a
        decoder-only one.  ``check=False`` skips the prefix check of the
        mask (``att.mask_lengths``), which reads the device."""
        if not self.cfg.is_encoder_decoder:
            return None, None
        if frames is None:
            raise ValueError(f"{self.cfg.name} is an encoder-decoder: give "
                             "frames=")
        # the encoder runs in the model's dtype, as the reference's does
        # on frames of it (given float32 frames, its bf16 encoder scan
        # raises on the carry's dtype: ROADMAP C)
        frames = torch.as_tensor(frames, device=self.device).to(
            self.param_dtype)
        if frame_mask is not None:
            frame_mask = torch.as_tensor(frame_mask, device=self.device)
        enc_out, mask = self.encode(frames, frame_mask, kernels=kernels)
        return (enc_out, att.mask_lengths(mask, check=check)), mask

    def _layer_full(self, p: Block, g: LayerGroup, x, kernels: bool,
                    window, enc):
        """One layer with its weights whole: ``_block_full``'s result."""
        with self._whole(p):
            return self._block_full(p, g, x, kernels=kernels, window=window,
                                    enc=enc)

    def _run_full(self, x, *, kernels: bool, window=None, enc=None,
                  with_cache: bool, into=None):
        """Every group over the full sequence; returns (x, caches or None,
        MoE aux total).  With ``remat`` and autograd on, each layer of a
        group but the shared block is checkpointed.  ``into`` (a decode
        state's caches) takes each layer's cache as it is made, in place
        of the stacked caches returned.  The checkpoint keeps no RNG
        state: no layer draws random numbers, and a CUDA graph may then
        capture the step."""
        w = window if window is not None else self.cfg.sliding_window
        caches: List[Dict[str, torch.Tensor]] = []
        aux_total = torch.zeros((), device=x.device)
        for gi, g in enumerate(self.cfg.layer_plan):
            remat = (self.remat and torch.is_grad_enabled()
                     and g.mixer != "shared_attn")
            entries = []
            for li, p in enumerate(self._layers(gi, g)):
                if remat:
                    x, cache, aux = torch.utils.checkpoint.checkpoint(
                        self._layer_full, p, g, x, kernels, w, enc,
                        use_reentrant=False, preserve_rng_state=False,
                        context_fn=shard_ctx.recompute_context)
                else:
                    x, cache, aux = self._layer_full(p, g, x, kernels, w,
                                                     enc)
                if into is not None:
                    _write_layer(into[gi], li, cache)
                elif with_cache:
                    entries.append(cache)
                if aux is not None:
                    aux_total = aux_total + aux
            if with_cache and into is None:
                caches.append(_stack(entries))
        return x, (caches if with_cache else None), aux_total

    # ------------------------------------------------------------ train --
    def train_logits(self, tokens, *, frames=None, frame_mask=None):
        """Full causal forward for training: tokens (B,S) -> {"logits"
        (B,S,V), "aux_loss"[, "mtp_logits" (B,S,V)]}; an encoder-decoder
        configuration also takes ``frames`` (B,T,D) and ``frame_mask``.

        No decode state is kept.  Attention and the recurrent mixers take
        their training paths (the reference's jnp attention and ``"xla"``
        chunked scans); no kernel runs.  zamba2's shared block is one set
        of parameters called by every shared group, so its gradient is
        the sum over the calls, as the reference's.  ``aux_loss`` is the
        sum of the MoE layers' load-balance losses (0 without MoE)."""
        enc, _ = self._encode_for(frames, frame_mask, kernels=False)
        x, _, aux_total = self._run_full(self._embed(tokens), kernels=False,
                                         enc=enc, with_cache=False)
        out = {"logits": self._logits(x), "aux_loss": aux_total}
        if self.cfg.mtp_depth:
            out["mtp_logits"] = self._mtp_logits(x, tokens)
        return out

    def _mtp_logits(self, h, tokens):
        """deepseek-v3's multi-token prediction: the extra block predicts
        token t+2 from [norm(h_t) ; emb(token_t+1)] (its MoE aux loss is
        not counted, as in the reference)."""
        cfg, mtp = self.cfg, self.mtp
        emb_next = self._embed(torch.roll(tokens, -1, dims=1))
        with self._whole(mtp):
            z = mtp.proj(torch.cat([rmsnorm(mtp.norm.g, h, cfg.norm_eps),
                                    emb_next], dim=-1))
            z, _, _ = self._block_full(mtp.block, cfg.layer_plan[-1], z,
                                       kernels=False)
        return self._logits(z)

    # ---------------------------------------------------------- prefill --
    @torch.no_grad()
    def prefill(self, tokens, *, frames=None, frame_mask=None,
                window: Optional[int] = None, max_len: Optional[int] = None,
                lengths=None, check: bool = True, into: Optional[Dict] = None):
        """tokens (B,S) -> (last logits (B,V), decode state).

        ``max_len`` pads the KV caches to the decode capacity (slot ==
        position); the cross caches stay at the T frames given.
        ``lengths`` (B,) marks true prompt lengths in a right-padded batch;
        exact only for position-masked mixers, so a plan with a recurrent
        mixer refuses ragged lengths.  ``frames`` / ``frame_mask`` feed an
        encoder-decoder's encoder (the mask must be a key prefix in each
        row); ``window`` overrides the configuration's sliding window.

        The two refusals read the device; ``check=False`` skips them, for
        a caller that made them on the host (a session, whose prefill a
        CUDA graph captures).  ``into`` (a decode state of the shapes this
        call returns) receives the state in place, and is returned: its
        sequence caches hold the prompt's slots and zeros after them, as
        a returned state's do.
        """
        cfg = self.cfg
        b, s = tokens.shape
        if lengths is not None:
            lengths = torch.as_tensor(lengths, device=self.device).to(
                torch.int32)
            if check and any(g.mixer in _RECURRENT
                             for g in cfg.layer_plan) and \
                    bool((lengths != s).any()):
                raise ValueError("ragged prompt lengths need position-masked "
                                 "mixers; recurrent states fold pad steps in")
        enc, enc_mask = self._encode_for(frames, frame_mask, kernels=True,
                                         check=check)
        x, caches, _ = self._run_full(
            self._embed(tokens), kernels=True, window=window, enc=enc,
            with_cache=True,
            into=None if into is None else into["caches"])
        if into is not None:
            pos0 = into["pos"]
            if lengths is None:
                pos0.fill_(s)
                last = x[:, -1, :]
            else:
                pos0.copy_(lengths)
                last = x[torch.arange(b, device=self.device),
                         lengths.long() - 1, :]
            if enc_mask is not None:
                into["enc_mask"].copy_(enc_mask)
            return self._logits(last), into
        if max_len is not None and max_len > s:
            for c in caches:
                for name in ("k", "v", "ckv", "kpe"):
                    if name in c:
                        t = c[name]
                        padded = t.new_zeros(t.shape[:2] + (max_len,)
                                             + t.shape[3:])
                        padded[:, :, :s] = t
                        c[name] = padded
        if lengths is None:
            pos0 = torch.full((b,), s, dtype=torch.int32, device=self.device)
            last = x[:, -1, :]
        else:
            pos0 = lengths.clone()
            last = x[torch.arange(b, device=self.device), pos0.long() - 1, :]
        state = {"caches": caches, "pos": pos0}
        if enc_mask is not None:
            state["enc_mask"] = enc_mask.float()
        return self._logits(last), state

    # ------------------------------------------------------ decode state --
    def init_decode_state(self, batch: int, max_len: int, dtype=None, *,
                          ring: bool = True) -> Dict:
        """Fresh (empty) decode state with capacity ``max_len``, its
        tensors in ``dtype`` (default the model's ``param_dtype``; ``pos``
        int32, ``enc_mask`` float32, as the reference's); an
        attention cache under a sliding window holds ``min(max_len,
        window)`` slots (a ring when that is the window).  ``ring=False``
        keeps ``max_len`` slots, the shapes ``prefill(max_len=)`` returns:
        past the window such a cache decodes linear under the window."""
        cfg, dev = self.cfg, self.device
        dtype = dtype or self.param_dtype
        caches: List[Dict[str, torch.Tensor]] = []
        zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
        for g in cfg.layer_plan:
            if g.mixer in _ATTENTION:
                w = cfg.sliding_window
                s_alloc = min(max_len, w) if w and ring else max_len
                kv = (g.count, batch, s_alloc, cfg.num_kv_heads, cfg.head_dim)
                c = {"k": zeros(*kv), "v": zeros(*kv)}
                if g.cross_attn:
                    xkv = (g.count, batch, cfg.encoder.max_frames,
                           cfg.num_kv_heads, cfg.head_dim)
                    c.update(xk=zeros(*xkv), xv=zeros(*xkv))
                caches.append(c)
            elif g.mixer == "mla":
                m = cfg.mla
                caches.append({
                    "ckv": torch.zeros((g.count, batch, max_len,
                                        m.kv_lora_rank), dtype=dtype,
                                       device=dev),
                    "kpe": torch.zeros((g.count, batch, max_len,
                                        m.qk_rope_head_dim), dtype=dtype,
                                       device=dev)})
            else:
                init = (mb.init_mamba_state if g.mixer == "mamba2"
                        else rk.init_rwkv_state)
                st = init(cfg, batch, dtype, dev)._asdict()
                caches.append({k: v[None].repeat((g.count,) + (1,) * v.dim())
                               for k, v in st.items()})
        state = {"caches": caches,
                 "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}
        if cfg.is_encoder_decoder:
            state["enc_mask"] = torch.ones((batch, cfg.encoder.max_frames),
                                           dtype=torch.float32, device=dev)
        return state

    def copy_rows(self, dst: Dict, src: Dict, slots, src_rows=None) -> None:
        """Copy the first ``len(slots)`` rows of the decode state ``src``
        (an admission prefill's) into rows ``slots`` of ``dst`` (a slot
        table's resident state): every cache tensor at axis 1, after the
        layer axis, and ``pos`` at axis 0.  ``src_rows`` (a long tensor
        as long as ``slots``, itself then a long tensor on the device)
        names the row of ``src`` each slot takes instead: a CUDA graph's
        static indices, where two entries may name one slot if they name
        one row."""
        if src_rows is None:
            k = len(slots)
            rows = torch.as_tensor(slots, dtype=torch.long,
                                   device=self.device)
            pick = lambda t, axis: t.narrow(axis, 0, k)
        else:
            rows = slots
            pick = lambda t, axis: t.index_select(axis, src_rows)
        for resident, fresh in zip(dst["caches"], src["caches"]):
            for name, t in resident.items():
                t.index_copy_(1, rows, pick(fresh[name], 1))
        dst["pos"].index_copy_(0, rows, pick(src["pos"], 0))

    # ----------------------------------------------------------- decode --
    @torch.no_grad()
    def decode_step(self, state: Dict, tokens):
        """ONE new token per sequence.  tokens (B,1) -> (logits (B,V),
        state), the state's caches and ``pos`` updated in place.  The
        frame lengths of cross-attention come from the state's
        ``enc_mask`` (a prefix, as prefill checked)."""
        pos = state["pos"]
        enc_mask = state.get("enc_mask")
        enc_len = (None if enc_mask is None
                   else att.mask_lengths(enc_mask, check=False))
        x = self._embed(tokens)
        for gi, g in enumerate(self.cfg.layer_plan):
            cache = state["caches"][gi]
            for li, p in enumerate(self._layers(gi, g)):
                with self._whole(p):
                    x = self._block_decode(p, g, x, cache, li, pos, enc_len)
        logits = self._logits(x[:, 0, :])
        pos.add_(1)
        return logits, state
