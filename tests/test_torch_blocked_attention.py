"""The port's memory-bounded attention (``blocked_sdpa``) on the CPU.

* Against the JAX package's ``repro.models.layers.attention.blocked_sdpa``
  on the same numpy-seeded inputs (float32): the output within 1e-5 and
  the gradients of q, k and v (``jax.grad`` against autograd, the same
  cotangent) within 1e-4.  Cases: causal; causal with a sliding window;
  causal with fewer queries than keys (the queries sit at the last S
  keys); non-causal with key-prefix lengths, a row of length 0 included
  (against the reference's equivalent ``kv_mask``); S not a multiple of
  the block and S below it; MLA's v head dim != q/k head dim with an
  explicit scale; blocks of 8 over S = 40.
* Memory: under autograd, ``blocked_sdpa`` saves fewer elements than one
  block's scores (each block is checkpointed); with the port's block
  size patched to 8, no tensor that
  autograd saves during a smoke LM's ``train_logits`` forward (qwen3-8b,
  deepseek-v3-671b's MLA) holds B*H*S*T elements; the materialised
  float32 attention (the kernel's plain twin) saves such tensors under
  the same hooks.
* Several blocks against one (smoke qwen3-8b, deepseek-v3-671b and
  whisper-large-v3 with ``LM(remat=True)``): the loss and every gradient
  within 1e-6 of the one-block run's (relative to each tensor's largest
  value), and two compiled train steps through the stubbed graphs
  (``tests/test_torch_graphs.py``'s ``stub_graphs``; the capture, then
  a replay) at learning rate 0, so that both see the same weights: each
  step's loss and grad norm within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import attention as j_att
from repro_torch.configs import smoke_config
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models.layers import attention as att
from repro_torch.models.model import LM
from repro_torch.training.losses import lm_loss
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import (
    compile_train_step,
    init_train_state,
    make_train_step,
)
from _torch_threads import cap_threads
from test_torch_graphs import stub_graphs  # noqa: F401

cap_threads()

FWD_TOL, GRAD_TOL = 1e-5, 1e-4     # against the reference, float32
BLOCK_REL = 1e-6                    # several blocks against one

# name -> (B, S, T, H, Hkv, Dh, Dv, keyword arguments of both functions,
# key-prefix lengths or None)
CASES = {
    "causal": (2, 24, 24, 4, 2, 16, 16, dict(q_block=8), None),
    "causal_window": (2, 24, 24, 4, 2, 16, 16, dict(q_block=8, window=5),
                      None),
    "causal_queries_at_the_last_keys": (2, 8, 24, 4, 2, 16, 16,
                                        dict(q_block=8), None),
    "lengths": (2, 10, 24, 4, 4, 16, 16, dict(causal=False, q_block=4),
                (24, 7)),
    "lengths_with_an_empty_row": (2, 10, 24, 4, 2, 16, 16,
                                  dict(causal=False, q_block=4), (13, 0)),
    "ragged_last_block": (2, 20, 20, 4, 2, 16, 16, dict(q_block=8), None),
    "one_short_block": (2, 12, 12, 4, 2, 16, 16, dict(), None),
    "mla_dv_scale": (2, 16, 16, 4, 4, 24, 16, dict(q_block=8, scale=0.3),
                     None),
    "blocks_of_8": (1, 40, 40, 4, 1, 16, 16, dict(q_block=8), None),
}


def _inputs(b, s, t, h, hkv, dh, dv, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in
                 ((b, s, h, dh), (b, t, hkv, dh), (b, t, hkv, dv),
                  (b, s, h, dv)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_blocked_sdpa_matches_the_reference(case):
    b, s, t, h, hkv, dh, dv, kw, lengths = CASES[case]
    q, k, v, cot = _inputs(b, s, t, h, hkv, dh, dv)
    j_kw = dict(kw)
    if lengths is not None:
        j_kw["kv_mask"] = jnp.asarray(
            np.arange(t)[None, :] < np.array(lengths)[:, None], jnp.float32)

    def j_loss(q, k, v):
        out = j_att.blocked_sdpa(q, k, v, **j_kw)
        return jnp.sum(out * cot), out

    (_, want), j_grads = jax.value_and_grad(j_loss, argnums=(0, 1, 2),
                                            has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    t_len = (None if lengths is None
             else torch.tensor(lengths, dtype=torch.int32))
    got = att.blocked_sdpa(tq, tk, tv, lengths=t_len, **kw)
    assert got.shape == (b, s, h, dv)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=FWD_TOL, atol=FWD_TOL)
    (got * torch.from_numpy(cot)).sum().backward()
    for name, g, jg in zip("qkv", (tq.grad, tk.grad, tv.grad), j_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


def test_blocked_sdpa_without_grad_equals_the_checkpointed_blocks():
    q, k, v, _ = _inputs(2, 20, 20, 4, 2, 16, 16, seed=3)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    with torch.no_grad():
        plain = att.blocked_sdpa(tq, tk, tv, q_block=8)
    assert torch.equal(att.blocked_sdpa(tq, tk, tv, q_block=8).detach(),
                       plain)
    with pytest.raises(ValueError, match="causal"):
        att.blocked_sdpa(tq, tk, tv, causal=False, window=4)


# ------------------------------------------------------------- memory ------
def _saved(fn):
    """The tensors autograd saves while ``fn()`` runs."""
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return saved


def test_blocked_sdpa_saves_less_than_one_block_of_scores():
    """The checkpointed blocks save their inputs (views of q, k and v) and
    nothing new."""
    b, s, h, l = 2, 64, 4, 8
    q, k, v, _ = _inputs(b, s, s, h, 2, 16, 16, seed=4)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    inputs = {t.untyped_storage().data_ptr() for t in (tq, tk, tv)}
    new = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
           for t in _saved(lambda: att.blocked_sdpa(tq, tk, tv, q_block=l))
           if t.untyped_storage().data_ptr() not in inputs}
    assert sum(new.values()) < 4 * b * h * l * s, new


@pytest.mark.parametrize("arch,b,s", [("qwen3-8b", 2, 192),
                                      ("deepseek-v3-671b", 1, 512)])
def test_training_saves_no_full_score_tensor(monkeypatch, arch, b, s):
    monkeypatch.setattr(att, "DEFAULT_Q_BLOCK", 8)
    cfg = smoke_config(arch)
    model = LM(cfg, device="cpu", seed=0)
    init_train_state(model)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (b, s)), dtype=torch.int32)
    shapes = [t.shape for t in _saved(lambda: model.train_logits(toks))]
    full = b * cfg.num_heads * s * s
    biggest = max(shapes, key=lambda sh: sh.numel())
    assert len(shapes) > 10 and biggest.numel() < full, biggest

    # the hooks see a materialised attention's (B, Hkv, rep, S, T) scores
    q = torch.randn((b, s, cfg.num_heads, 16), requires_grad=True)
    k = torch.randn((b, s, 1, 16))
    twin = _saved(lambda: flash_attention_plain(q, k, k))
    assert max(t.numel() for t in twin) >= full


# ---------------------------------------------------- several blocks ------
def _batch(cfg, seed=2, b=2, s=40):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, 1)}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder.max_frames, cfg.d_model)).astype(np.float32)
    return batch


def _run(arch, block, monkeypatch):
    """The loss and gradients of one remat model, then the loss and grad
    norm of two compiled train steps at learning rate 0 (a capture and a
    replay), at ``block`` queries per block."""
    monkeypatch.setattr(att, "DEFAULT_Q_BLOCK", block)
    cfg = smoke_config(arch)
    batch = _batch(cfg)
    model = LM(cfg, device="cpu", seed=0, remat=True)
    params = list(init_train_state(model).params.values())
    loss = lm_loss(model, {k: torch.as_tensor(v)
                           for k, v in batch.items()})[0]
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    step = compile_train_step(
        make_train_step(model, opt_cfg=AdamWConfig(lr=0.0)), model)
    state, mets = init_train_state(model), []
    for _ in range(2):
        state, m = step(state, batch)
        mets += [m["loss"].clone(), m["grad_norm"].clone()]
    assert step.graphs.captures == 1 and step.graphs.replays == 1
    return [loss.detach()] + [g for g in grads if g is not None], mets


def _assert_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= BLOCK_REL * scale


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v3-671b",
                                  "whisper-large-v3"])
def test_several_blocks_equal_one_block(stub_graphs, monkeypatch, arch):
    many = _run(arch, 8, monkeypatch)
    one = _run(arch, 4096, monkeypatch)
    for got, want in zip(many, one):
        _assert_close(got, want)
