"""The port's qwen3-8b (dense, qk-norm GQA) on the CPU against the JAX
package.

The smoke qwen3-8b (2 layers, d_model 256, 4 query heads over 2 KV heads
of 64) is built by JAX once per module, its weights carried across by
``lm_params_from_jax`` and held against the port: ``head_rmsnorm`` and
the qk-norm projections, prefill and decode logits and caches, ragged
prefill and ``generate_with_lengths``, the converter's new leaves, the
decode step at a position past the cache, and the training CLI.  The
full configuration, the registry, the serving CLI's default and the
refusal to train the full width on one card are checked without
building the full model.

Tolerances: 1e-6 for a norm, 1e-5 for the projections, 1e-4 for logits
and caches (float32; the two packages reduce in different orders, so
nothing is held bitwise).  Tokens are compared only behind a top-2
logit margin of at least 1e-4 (``greedy_margins``); the test asserts
that its inputs have one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import qwen3_8b as j_qwen3_8b
from repro.configs import smoke_config as j_smoke_config
from repro.models.layers import attention as j_att
from repro.models.layers.basic import head_rmsnorm as j_head_rmsnorm
from repro.models.model import LM as JLM
from repro.runtime.serving import GenerationSession as JSession
from repro_torch.configs import get_config, qwen3_8b, smoke_config
from repro_torch.convert import lm_params_from_jax, reference_leaves
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models.layers import attention as att
from repro_torch.models.layers.basic import head_rmsnorm
from repro_torch.models.model import LM
from repro_torch.models.registry import available, resolve
from repro_torch.runtime.serving import GenerationSession, greedy_margins
from repro_torch.training.train_loop import leaf_ndims
from _torch_threads import cap_threads

cap_threads()

ARCH = "qwen3-8b"
TOL = 1e-4
MARGIN = 1e-4


@pytest.fixture(scope="module")
def qwen():
    """(JAX model, JAX params, port model) of the smoke qwen3-8b."""
    jm = JLM(j_smoke_config(ARCH))
    params = jm.init(jax.random.PRNGKey(0))
    model = LM(smoke_config(ARCH), device="cpu")
    model.load_state_dict(
        lm_params_from_jax(jax.tree.map(np.asarray, params), model.cfg),
        strict=True)
    return jm, params, model


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------- config --
def test_config_and_long_decode_variant_match_the_reference():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(j_get_config(ARCH))
    assert dataclasses.asdict(qwen3_8b.long_decode_variant()) == \
        dataclasses.asdict(j_qwen3_8b.long_decode_variant())
    assert get_config(ARCH, shape="long_500k") == \
        qwen3_8b.long_decode_variant().validate()
    cfg = get_config(ARCH)
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.qk_norm) == \
        (32, 8, 128, True)
    # the reference's own sanity band (tests/test_arch_smoke.py)
    n = sum(p.numel() for p in LM(cfg, device="meta").parameters())
    assert 6e9 < n < 10e9


def test_registry_resolves_qwen3_8b():
    for name in ("qwen3-8b", "qwen3_8b"):
        r = resolve(name, device="cpu", seed=1)
        assert (r.name, r.family, r.pair) == (ARCH, "lm", None)
        assert r.cfg == smoke_config(ARCH)
        assert isinstance(r.model, LM) and r.model.device.type == "cpu"
    assert ARCH in available()
    for name in ("whisper-large-v3", "whisper_large_v3"):
        assert resolve(name, device="meta").name == "whisper-large-v3"
    full = resolve(ARCH, size="full", shape="long_500k", device="meta")
    assert full.cfg.sliding_window == 4096


# ---------------------------------------------------------------- layers --
def test_head_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 64)).astype(np.float32) * 3
    g = rng.standard_normal(64).astype(np.float32)
    want = j_head_rmsnorm(jnp.asarray(g), jnp.asarray(x), 1e-6)
    got = head_rmsnorm(torch.from_numpy(g), torch.from_numpy(x), 1e-6)
    _close(got, want, 1e-6)


def test_qk_norm_projections_match_jax():
    """``_qkv`` with qk-norm: q and k normed over the head dim (with a
    non-trivial scale) before RoPE, as the reference's."""
    cfg, jcfg = smoke_config(ARCH), j_smoke_config(ARCH)
    jp = jax.tree.map(np.asarray, j_att.gqa_params(jax.random.PRNGKey(3),
                                                   jcfg))
    rng = np.random.default_rng(1)
    for name in ("q_norm", "k_norm"):
        jp[name]["g"] = rng.uniform(0.5, 1.5, cfg.head_dim).astype(
            np.float32)
    p = att.GQA(cfg, device="cpu", generator=torch.Generator())
    sd = {f"{k}.w": torch.tensor(jp[k]["w"]) for k in "qkvo"}
    sd.update({f"{k}.g": torch.tensor(jp[k]["g"])
               for k in ("q_norm", "k_norm")})
    p.load_state_dict(sd, strict=True)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(3, 10), (2, 1))
    want = j_att._qkv(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = att._qkv(p, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    for g_, w_ in zip(got, want):
        _close(g_, w_, 1e-5)


# ----------------------------------------------------------------- model --
def test_prefill_and_decode_match_jax(qwen):
    jm, params, model = qwen
    toks = np.random.default_rng(2).integers(
        3, model.cfg.vocab_size, (2, 13)).astype(np.int32)
    max_len = 20
    jl, jst = jax.jit(lambda p, t: jm.prefill(p, t, max_len=max_len))(
        params, jnp.asarray(toks))
    tl, tst = model.prefill(torch.as_tensor(toks), max_len=max_len)
    _close(tl, jl)
    for jc, tc in zip(jax.tree.map(np.asarray, jst["caches"]),
                      tst["caches"]):
        assert set(jc) == set(tc) == {"k", "v"}
        for name in tc:
            assert tuple(tc[name].shape) == jc[name].shape
            _close(tc[name], jc[name])
    step = jax.jit(jm.decode_step)
    for tok in (5, 17, 42, 99):
        t = np.full((2, 1), tok, np.int32)
        jl, jst = step(params, jst, jnp.asarray(t))
        tl, tst = model.decode_step(tst, torch.as_tensor(t))
        _close(tl, jl)
    np.testing.assert_array_equal(tst["pos"].numpy(), np.asarray(jst["pos"]))


def test_ragged_prefill_and_generation_match_jax(qwen):
    """Right-padded prompts with their true lengths: prefill logits and
    one decode step, then ``generate_with_lengths`` (bucketed, ragged)
    against the reference session, tokens compared behind a clear
    margin."""
    jm, params, model = qwen
    rng = np.random.default_rng(4)
    lens = np.array([11, 4, 8], np.int32)
    toks = rng.integers(3, model.cfg.vocab_size, (3, 11)).astype(np.int32)
    for i, n in enumerate(lens):
        toks[i, n:] = 0
    jl, jst = jm.prefill(params, jnp.asarray(toks), max_len=24,
                         lengths=jnp.asarray(lens))
    tl, tst = model.prefill(torch.as_tensor(toks), max_len=24,
                            lengths=torch.as_tensor(lens))
    _close(tl, jl)
    t = np.full((3, 1), 9, np.int32)
    _close(model.decode_step(tst, torch.as_tensor(t))[0],
           jm.decode_step(params, jst, jnp.asarray(t))[0])

    max_new = 6
    j_lens, j_out = (np.asarray(a) for a in JSession(
        jm, params, max_len=32).generate_with_lengths(
            toks, max_new=max_new, lengths=lens))
    t_lens, t_out = GenerationSession(model, max_len=32).generate_with_lengths(
        toks, max_new=max_new, lengths=lens)
    for i, n in enumerate(lens):
        margins = greedy_margins(model, toks[i, :n], t_out[i])
        assert margins.min() >= MARGIN, (i, margins)
    np.testing.assert_array_equal(t_lens, j_lens)
    np.testing.assert_array_equal(t_out, j_out)


def test_decode_past_the_cache_drops_the_write(qwen):
    """``pos == max_len``: the reference's one-hot write is all zeros, so
    the cache stays as it was and the step attends to every slot.  The
    port returns the reference's logits and leaves its cache unchanged."""
    jm, params, model = qwen
    toks = np.random.default_rng(5).integers(
        3, model.cfg.vocab_size, (2, 8)).astype(np.int32)
    jl, jst = jm.prefill(params, jnp.asarray(toks), max_len=8)
    tl, tst = model.prefill(torch.as_tensor(toks), max_len=8)
    assert tst["pos"].tolist() == [8, 8]
    before = [{k: v.clone() for k, v in c.items()} for c in tst["caches"]]
    t = np.full((2, 1), 11, np.int32)
    for _ in range(2):                     # pos 8 then 9, both past 8
        jl, jst = jm.decode_step(params, jst, jnp.asarray(t))
        tl, tst = model.decode_step(tst, torch.as_tensor(t))
        _close(tl, jl)
        assert torch.isfinite(tl).all()
    for b, c in zip(before, tst["caches"]):
        for name in c:
            assert torch.equal(b[name], c[name]), name
    np.testing.assert_array_equal(tst["pos"].numpy(), np.asarray(jst["pos"]))
    assert tst["pos"].tolist() == [10, 10]


def test_converter_carries_the_qk_norm_leaves(qwen):
    """``mixer.q_norm.g`` / ``mixer.k_norm.g`` of each layer come from the
    reference's stacked (count, head_dim) leaves, whose rank 2 makes
    AdamW decay them as the reference's ``_is_matrix`` does."""
    jm, params, model = qwen
    leaves = reference_leaves(model)
    ndims = leaf_ndims(model)
    for name in ("q_norm", "k_norm"):
        jleaf = np.asarray(params["groups"][0]["mixer"][name]["g"])
        assert jleaf.shape == (2, model.cfg.head_dim)
        for li in range(2):
            key = f"groups.0.{li}.mixer.{name}.g"
            assert leaves[key].keystr == \
                f"['groups'][0]['mixer']['{name}']['g']"
            assert ndims[key] == 2
            np.testing.assert_array_equal(
                model.state_dict()[key].numpy(), jleaf[li])


# ------------------------------------------------------------- launchers --
def test_train_cli_trains_the_smoke_qwen3_on_the_cpu():
    losses = train_cli.main(["--arch", "qwen3_8b", "--smoke", "--device",
                             "cpu", "--steps", "6", "--batch", "2",
                             "--seq", "16"])
    assert len(losses) == 6 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_full_width_qwen3_training_is_refused_on_one_card():
    """float32 parameters, gradients and two moments: 16 bytes for each
    of 8.19 B parameters, ≈131 GB, more than an 80 GB card; the two
    recurrent LMs fit."""
    with pytest.raises(ValueError, match="131.1 GB"):
        train_cli.check_fits(ARCH, 80 * 10**9)
    for arch in ("rwkv6-3b", "zamba2-1.2b"):
        train_cli.check_fits(arch, 80 * 10**9)


def test_serve_cli_defaults_to_qwen3_8b(capsys, monkeypatch):
    asked = []
    monkeypatch.setattr(serve_cli, "resolve",
                        lambda name, **kw: asked.append(name) or
                        resolve(name, **kw))
    engine = serve_cli.main(["--smoke", "--device", "cpu", "--tiered",
                             "--requests", "4", "--max-new", "3"])
    assert len(engine.results) == 4
    assert not any(r.shed for r in engine.results)
    assert asked == [ARCH]
    assert "[serve] 4 reqs" in capsys.readouterr().out
