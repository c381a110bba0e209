"""The composable LM: layer groups assembled into prefill and decode paths.

Port of ``repro/models/model.py`` for the groups the port carries:
``rwkv6/rwkv_cm`` (rwkv6-3b), ``mamba2/none`` and ``shared_attn/dense``
(zamba2-1.2b), ``attn/dense`` with or without qk-norm (qwen3-8b,
qwen3-32b, deepseek-67b, chameleon-34b), ``attn/moe``
(qwen3-moe-30b-a3b, and moonshot-v1-16b-a3b after its dense first
layer) and ``mla/dense`` + ``mla/moe`` (deepseek-v3-671b), with
deepseek-v3's multi-token-prediction block (``mtp``) and tied
embeddings.  Sliding-window, cross-attention and encoder configurations
raise ``NotImplementedError``.

Structure follows the reference's parameter tree, so the converter maps
it name for name: ``groups[gi][li]`` is layer ``li`` of group ``gi`` (one
module per layer, where the reference stacks a group's layers along a
leading ``count`` axis), and the zamba-style ``shared_attn`` block is
held once and called by every shared group, each call with a KV cache of
its own.  Weights are drawn at construction from a ``torch.Generator``
seeded with ``seed`` on the target device (on the ``meta`` device
nothing is drawn or allocated: shapes only, to size a configuration).

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

The decode state mirrors the reference's: ``{"caches": [one dict per
group, every tensor with a leading count axis], "pos": (B,) int32}``; an
MLA group caches the compressed latent ``{"ckv", "kpe"}``.  MoE layers
dispatch within one group per batch row in prefill and training and one
group for the whole batch in decode (the reference's rule), so with a
capacity factor that drops assignments a row's output depends on the
other rows of its batch.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
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

NEG_LOGIT = -1e30        # logit of a vocab padding column
_RECURRENT = ("mamba2", "rwkv6")


class Block(nn.Module):
    """One layer of group ``g``: mixer + FFN + their norms."""

    def __init__(self, cfg: ModelConfig, g: LayerGroup, *, device,
                 generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        d = cfg.d_model
        self.ln1 = RMSNorm(d, device=device)
        if g.mixer in ("attn", "shared_attn"):
            att.check_supported(cfg, cross=g.cross_attn)
            self.mixer = att.GQA(cfg, **kw)
        elif g.mixer == "mamba2":
            self.mixer = mb.Mamba2Mixer(cfg, **kw)
        elif g.mixer == "rwkv6":
            self.mixer = rk.TimeMix(cfg, **kw)
        elif g.mixer == "mla":
            self.mixer = att.MLA(cfg, **kw)
        else:
            raise ValueError(g.mixer)
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


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg.validate()
        if cfg.is_encoder_decoder or cfg.encoder is not None:
            raise NotImplementedError("encoder-decoder LMs are not ported yet")
        dev = resolve_device(device)
        gen = (None if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(seed))
        kw = dict(device=dev, generator=gen)
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

    def _block_full(self, p: Block, g: LayerGroup, x, *, kernels: bool):
        """One layer over the full sequence, its mixer through the kernels
        or (``kernels=False``) the training path.  Returns (x, cache
        entry, MoE aux or None)."""
        cfg = self.cfg
        h = rmsnorm(p.ln1.g, x, cfg.norm_eps)
        rstate = None
        if g.mixer in ("attn", "shared_attn"):
            y, (k, v) = att.attn_full(p.mixer, cfg, h, kernels=kernels)
            cache = {"k": k, "v": v}
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

    def _block_decode(self, p: Block, g: LayerGroup, x, cache, li: int, pos):
        """One layer, one token; writes layer ``li``'s slice of the group's
        cache in place."""
        cfg = self.cfg
        h = rmsnorm(p.ln1.g, x, cfg.norm_eps)
        rstate = None
        if g.mixer in ("attn", "shared_attn"):
            y = att.attn_decode(p.mixer, cfg, h, cache["k"][li],
                                cache["v"][li], pos)
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
        x = rmsnorm(self.final_norm.g, x, cfg.norm_eps)
        logits = (x @ self.embed.w.to(x.dtype).T if cfg.tie_embeddings
                  else self.lm_head(x))
        if cfg.padded_vocab != cfg.vocab_size:
            logits[..., cfg.vocab_size:] = NEG_LOGIT
        return logits

    # ------------------------------------------------------------ train --
    def train_logits(self, tokens):
        """Full causal forward for training: tokens (B,S) -> {"logits"
        (B,S,V), "aux_loss"[, "mtp_logits" (B,S,V)]}.

        No decode state is kept.  Attention and the recurrent mixers take
        their training paths (the reference's jnp attention and ``"xla"``
        chunked scans); no kernel runs.  zamba2's shared block is one set
        of parameters called by every shared group, so its gradient is
        the sum over the calls, as the reference's.  ``aux_loss`` is the
        sum of the MoE layers' load-balance losses (0 without MoE)."""
        x = self.embed(tokens)
        aux_total = torch.zeros((), device=x.device)
        for gi, g in enumerate(self.cfg.layer_plan):
            for p in self._layers(gi, g):
                x, _, aux = self._block_full(p, g, x, kernels=False)
                if aux is not None:
                    aux_total = aux_total + aux
        out = {"logits": self._logits(x), "aux_loss": aux_total}
        if self.cfg.mtp_depth:
            out["mtp_logits"] = self._mtp_logits(x, tokens)
        return out

    def _mtp_logits(self, h, tokens):
        """deepseek-v3's multi-token prediction: the extra block predicts
        token t+2 from [norm(h_t) ; emb(token_t+1)] (its MoE aux loss is
        not counted, as in the reference)."""
        cfg, mtp = self.cfg, self.mtp
        emb_next = self.embed(torch.roll(tokens, -1, dims=1))
        z = mtp.proj(torch.cat([rmsnorm(mtp.norm.g, h, cfg.norm_eps),
                                emb_next], dim=-1))
        z, _, _ = self._block_full(mtp.block, cfg.layer_plan[-1], z,
                                   kernels=False)
        return self._logits(z)

    # ---------------------------------------------------------- prefill --
    @torch.no_grad()
    def prefill(self, tokens, *, max_len: Optional[int] = None,
                lengths=None):
        """tokens (B,S) -> (last logits (B,V), decode state).

        ``max_len`` pads the KV caches to the decode capacity (slot ==
        position).  ``lengths`` (B,) marks true prompt lengths in a
        right-padded batch; exact only for position-masked mixers, so a
        plan with a recurrent mixer refuses ragged lengths.
        """
        cfg = self.cfg
        b, s = tokens.shape
        if lengths is not None:
            lengths = torch.as_tensor(lengths, device=self.device).to(
                torch.int32)
            if any(g.mixer in _RECURRENT for g in cfg.layer_plan) and \
                    bool((lengths != s).any()):
                raise ValueError("ragged prompt lengths need position-masked "
                                 "mixers; recurrent states fold pad steps in")
        x = self.embed(tokens)
        caches: List[Dict[str, torch.Tensor]] = []
        for gi, g in enumerate(cfg.layer_plan):
            entries = []
            for p in self._layers(gi, g):
                x, cache, _ = self._block_full(p, g, x, kernels=True)
                entries.append(cache)
            caches.append(_stack(entries))
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
        return self._logits(last), {"caches": caches, "pos": pos0}

    # ------------------------------------------------------ decode state --
    def init_decode_state(self, batch: int, max_len: int,
                          dtype=torch.float32) -> Dict:
        """Fresh (empty) decode state with capacity ``max_len``."""
        cfg, dev = self.cfg, self.device
        caches: List[Dict[str, torch.Tensor]] = []
        for g in cfg.layer_plan:
            if g.mixer in ("attn", "shared_attn"):
                shape = (g.count, batch, max_len, cfg.num_kv_heads,
                         cfg.head_dim)
                caches.append({"k": torch.zeros(shape, dtype=dtype,
                                                device=dev),
                               "v": torch.zeros(shape, dtype=dtype,
                                                device=dev)})
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
        return {"caches": caches,
                "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}

    # ----------------------------------------------------------- decode --
    @torch.no_grad()
    def decode_step(self, state: Dict, tokens):
        """ONE new token per sequence.  tokens (B,1) -> (logits (B,V),
        state), the state's caches and ``pos`` updated in place."""
        pos = state["pos"]
        x = self.embed(tokens)
        for gi, g in enumerate(self.cfg.layer_plan):
            cache = state["caches"][gi]
            for li, p in enumerate(self._layers(gi, g)):
                x = self._block_decode(p, g, x, cache, li, pos)
        logits = self._logits(x[:, 0, :])
        pos.add_(1)
        return logits, state
