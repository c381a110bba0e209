"""The port's whisper-large-v3 (encoder-decoder) on the CPU against the
JAX package.

The smoke whisper (2 encoder + 2 decoder layers, d_model 256, 4 MHA heads
of 64, 16 frames) is built by JAX once per module, its weights carried
across by ``lm_params_from_jax`` and held against the port on inputs
made from a numpy seed: the encoder, cross-attention with a prefix frame
mask and a row with no valid frame, the refusal of a mask that is not a
prefix, prefill logits and decode state with frames, decode steps,
decode against the teacher-forced forward, ``GenerationSession.generate
(frames=)``, the converters both ways, ``lm_loss`` and its gradient with
frames, and the continuous session's refusal.

Tolerances (float32; the two packages reduce in different orders, so
nothing is held bitwise): 1e-5 for the encoder and one cross-attention
call, 1e-4 for logits and caches, the gradient within 1e-4 of each
leaf's largest entry; decode against the port's own teacher-forced
forward within 1e-4 (the reference's own test allows 2e-3).  Tokens are
compared up to the first one behind a top-2 logit margin under 1e-4
(``greedy_margins``); the test asserts that its inputs have none.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.models.layers import attention as j_att
from repro.models.model import LM as JLM
from repro.runtime.serving import GenerationSession as JSession
from repro.training.losses import lm_loss as j_lm_loss
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax
from repro_torch.models.layers import attention as att
from repro_torch.models.model import LM
from repro_torch.models.registry import resolve
from repro_torch.runtime.serving import (
    ContinuousGenerationSession,
    GenerationSession,
    greedy_margins,
)
from repro_torch.training.losses import lm_loss
from _torch_threads import cap_threads

cap_threads()

ARCH = "whisper-large-v3"
TOL = 1e-4
MARGIN = 1e-4
B, T, S = 2, 16, 6


@pytest.fixture(scope="module")
def whisper():
    """(JAX model, JAX params, numpy params, port model), smoke size."""
    jm = JLM(j_smoke_config(ARCH))
    params = jm.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)
    model = LM(smoke_config(ARCH), device="cpu")
    model.load_state_dict(lm_params_from_jax(np_params, model.cfg),
                          strict=True)
    return jm, params, np_params, model


def _inputs(seed=0):
    """Frames (B,T,D), a prefix frame mask (row 1 keeps 10 of 16 frames)
    and prompt tokens (B,S), from a numpy seed."""
    cfg = smoke_config(ARCH)
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, 10:] = 0.0
    toks = rng.integers(4, cfg.vocab_size, (B, S)).astype(np.int32)
    return frames, mask, toks


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def test_config_matches_the_reference():
    for mine, ref in ((get_config(ARCH), j_get_config(ARCH)),
                      (smoke_config(ARCH), j_smoke_config(ARCH))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.padded_vocab == ref.padded_vocab
    cfg = get_config(ARCH)
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.encoder.num_layers, cfg.encoder.max_frames,
            cfg.vocab_size, cfg.padded_vocab) == \
        (1280, 20, 20, 64, 5120, 32, 1500, 51866, 51968)
    # the reference's own sanity band (tests/test_arch_smoke.py)
    n = sum(p.numel() for p in LM(cfg, device="meta").parameters())
    assert 1.2e9 < n < 2.2e9
    for name in (ARCH, "whisper_large_v3"):
        r = resolve(name, device="cpu")
        assert (r.name, r.family, r.cfg) == (ARCH, "lm", smoke_config(ARCH))


def test_encoder_matches_jax(whisper):
    """The encoder ignores the frame mask (so padded frames are attended
    to) and applies RoPE over frame positions, as the reference's."""
    jm, params, _, model = whisper
    frames, mask, _ = _inputs()
    want, jmask = jm.encode(params, jnp.asarray(frames), jnp.asarray(mask))
    got, tmask = model.encode(torch.as_tensor(frames), torch.as_tensor(mask))
    _close(got, want, 1e-5)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    unmasked, _ = model.encode(torch.as_tensor(frames))
    assert torch.equal(unmasked, got)


def _layer0(np_params, model):
    """Layer 0's cross-attention leaves on both sides."""
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      np_params["groups"][0]["mixer"])
    return jp, model.groups[0][0].mixer


@pytest.mark.parametrize("lengths", [(16, 10), (7, 0)])
def test_cross_attention_matches_jax(whisper, lengths):
    """Prefill (S tokens against T frames) and decode cross-attention with
    a prefix mask; a row with no valid frame averages over all T frames in
    both (the reference's finite mask value)."""
    _, _, np_params, model = whisper
    cfg = model.cfg
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.float32)
    jp, p = _layer0(np_params, model)
    jk, jv = j_att.encode_cross_kv(jp, cfg, jnp.asarray(enc))
    k, v = att.encode_cross_kv(p, cfg, torch.as_tensor(enc))
    _close(k, jk, 1e-5)
    lens = att.mask_lengths(torch.as_tensor(mask))
    assert lens.tolist() == list(lengths)
    want = j_att.cross_attn(jp, cfg, jnp.asarray(x), jk, jv,
                            jnp.asarray(mask))
    _close(att.cross_attn(p, cfg, torch.as_tensor(x), k, v, lens), want,
           1e-5)
    want1 = j_att.cross_attn(jp, cfg, jnp.asarray(x[:, :1]), jk, jv,
                             jnp.asarray(mask))
    _close(att.cross_decode(p, cfg, torch.as_tensor(x[:, :1]), k, v, lens),
           want1, 1e-5)


def test_a_mask_that_is_not_a_prefix_raises(whisper):
    *_, model = whisper
    frames, mask, toks = _inputs()
    mask[0, 3] = 0.0                      # a hole before valid frames
    with pytest.raises(ValueError, match="prefix"):
        att.mask_lengths(torch.as_tensor(mask))
    with pytest.raises(ValueError, match="prefix"):
        model.prefill(torch.as_tensor(toks), frames=torch.as_tensor(frames),
                      frame_mask=torch.as_tensor(mask))
    with pytest.raises(ValueError, match="frames"):
        model.prefill(torch.as_tensor(toks))


def test_prefill_and_decode_match_jax(whisper):
    """Prefill logits and state (self caches padded to max_len, cross
    caches at T frames, the frame mask, pos), then four decode steps."""
    jm, params, _, model = whisper
    frames, mask, toks = _inputs()
    jl, js = jm.prefill(params, jnp.asarray(toks), frames=jnp.asarray(frames),
                        frame_mask=jnp.asarray(mask), max_len=12)
    tl, ts = model.prefill(torch.as_tensor(toks),
                           frames=torch.as_tensor(frames),
                           frame_mask=torch.as_tensor(mask), max_len=12)
    _close(tl, jl)
    assert set(ts) == set(js) == {"caches", "pos", "enc_mask"}
    np.testing.assert_array_equal(ts["pos"].numpy(), np.asarray(js["pos"]))
    np.testing.assert_array_equal(ts["enc_mask"].numpy(),
                                  np.asarray(js["enc_mask"]))
    for name in ("k", "v", "xk", "xv"):
        assert ts["caches"][0][name].shape == js["caches"][0][name].shape
        _close(ts["caches"][0][name], js["caches"][0][name])
    for step in range(4):
        tok = np.full((B, 1), 5 + 7 * step, np.int32)
        jl, js = jm.decode_step(params, js, jnp.asarray(tok))
        tl, ts = model.decode_step(ts, torch.as_tensor(tok))
        _close(tl, jl)
    # vocab padding columns are masked
    assert (tl[:, model.cfg.vocab_size:] == -1e30).all()


def test_decode_state_shapes_match_jax(whisper):
    jm, params, _, model = whisper
    js = jm.init_decode_state(params, 3, 10)
    ts = model.init_decode_state(3, 10)
    got = jax.tree.map(lambda t: tuple(t.shape), ts)
    want = jax.tree.map(lambda a: tuple(a.shape), js)
    assert got == want
    assert ts["enc_mask"].sum() == 3 * model.cfg.encoder.max_frames


def test_decode_matches_train_forward(whisper):
    """The reference's test_decode_matches_train_forward with whisper:
    prefill + four decode steps against the teacher-forced forward on the
    same frames and tokens, and that forward against JAX's."""
    jm, params, _, model = whisper
    frames, mask, _ = _inputs()
    toks = np.random.default_rng(2).integers(
        1, model.cfg.vocab_size, (B, 12)).astype(np.int32)
    with torch.no_grad():
        full = model.train_logits(torch.as_tensor(toks),
                                  frames=torch.as_tensor(frames),
                                  frame_mask=torch.as_tensor(mask))["logits"]
    jfull = jm.train_logits(params, jnp.asarray(toks),
                            frames=jnp.asarray(frames),
                            frame_mask=jnp.asarray(mask))["logits"]
    _close(full, jfull)
    _, state = model.prefill(torch.as_tensor(toks[:, :8]),
                             frames=torch.as_tensor(frames),
                             frame_mask=torch.as_tensor(mask), max_len=12)
    for t in range(8, 12):
        logits, state = model.decode_step(state,
                                          torch.as_tensor(toks[:, t:t + 1]))
        _close(logits, full[:, t])


def test_generate_with_frames_matches_jax(whisper):
    """GenerationSession.generate(frames=) against the reference's on the
    same weights: equal tokens up to the first behind a margin < 1e-4."""
    jm, params, _, model = whisper
    frames, _, toks = _inputs(3)
    got = GenerationSession(model, max_len=16).generate(toks, max_new=8,
                                                        frames=frames)
    want = np.asarray(JSession(jm, params, max_len=16).generate(
        toks, max_new=8, frames=frames))
    assert got.shape[0] == B and got.shape[1] >= 1
    for i in range(B):
        margins = greedy_margins(model, toks[i], got[i], frames=frames[i])
        n = len(got[i])
        assert margins.min() >= MARGIN, margins      # the inputs have none
        np.testing.assert_array_equal(got[i, :n], want[i, :n])


def test_converters_round_trip_the_encoder(whisper):
    """lm_params_to_jax(lm_params_from_jax(p)) == p, the encoder's stacked
    layers, its final norm and the cross leaves included."""
    _, _, np_params, model = whisper
    sd = lm_params_from_jax(np_params, model.cfg)
    assert {"encoder.final_norm.g", "encoder.layers.1.mixer.q.w",
            "groups.0.1.mixer.xq.w", "groups.0.0.ln_x.g"} <= set(sd)
    assert not any(n.startswith("encoder.layers") and ".mixer.x" in n
                   for n in sd)
    tree, paths = lm_params_to_jax(sd, model.cfg)
    assert jax.tree.structure(tree) == jax.tree.structure(np_params)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(np_params)):
        np.testing.assert_array_equal(a, b)
    assert paths["encoder.layers.1.ln1.g"] == \
        "['encoder']['layers']['ln1']['g']"


def test_lm_loss_and_gradient_with_frames(whisper):
    """lm_loss with batch["frames"] within 1e-5; each gradient leaf within
    1e-4 of its largest entry, the encoder's included."""
    jm, params, np_params, _ = whisper
    frames, _, _ = _inputs(4)
    toks = np.random.default_rng(5).integers(
        1, 512, (B, 10)).astype(np.int32)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, 1),
             "frames": frames}
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_lm_loss(jm, p, b), has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = LM(smoke_config(ARCH), device="cpu")
    model.load_state_dict(lm_params_from_jax(np_params, model.cfg))
    model.requires_grad_(True)
    loss, _ = lm_loss(model, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert loss.item() == pytest.approx(float(j_loss), rel=1e-5)
    tree, _ = lm_params_to_jax(dict(zip(
        [n for n, _ in model.named_parameters()], grads)), model.cfg)
    for (key, got), want in zip(
            jax.tree_util.tree_flatten_with_path(tree)[0],
            jax.tree.leaves(j_grads)):
        want = np.asarray(want)
        err = float(np.abs(got - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()), (key, err)


def test_continuous_session_refuses_whisper(whisper):
    *_, model = whisper
    with pytest.raises(ValueError, match="decoder-only"):
        ContinuousGenerationSession(model, max_slots=2, max_len=16)
