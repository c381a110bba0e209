"""The port's MoE and MLA LMs, and the three dense giants, on the CPU
against the JAX package.

The smoke qwen3-moe-30b-a3b (qk-norm GQA + MoE), moonshot-v1-16b-a3b (a
dense first layer, then MoE with two shared experts) and
deepseek-v3-671b (MLA, dense then MoE, one shared expert, MTP) are built
by JAX once per module, their weights carried across by
``lm_params_from_jax``, and held against the port: prefill and decode
logits and caches, ``train_logits`` (logits, the summed MoE aux loss,
MTP logits), ``lm_loss`` and its gradients, decode against the
teacher-forced forward, and the converter both ways (tied embeddings
included); generation, the slot table and the train step are in
``tests/test_torch_moe_serving.py``.  qwen3-32b,
deepseek-67b and chameleon-34b (dense qk-norm / plain GQA, no new layer)
get smoke prefill and decode against JAX; every new name is refused for
training at full width on one card.

The smoke MoE configs are drop-free (``capacity_factor = E / top_k``,
the reference's smoke rule), so a row's output does not depend on the
other rows of its batch, and decode equals the teacher-forced forward.

Tolerances: 1e-4 for logits, caches and the aux / MTP terms, gradients
within 1e-4 of each leaf's largest entry (float32; the two packages
reduce in different orders).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models.model import LM as JLM
from repro.training.losses import lm_loss as j_lm_loss
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import (
    lm_params_from_jax,
    lm_params_to_jax,
    params_from_jax,
    params_to_jax,
    reference_leaves,
)
from repro_torch.launch import train as train_cli
from repro_torch.models.model import LM
from repro_torch.models.registry import available, resolve
from repro_torch.training.losses import lm_loss
from _torch_threads import cap_threads

cap_threads()

ARCHS = ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "deepseek-v3-671b")
DENSE = ("qwen3-32b", "deepseek-67b", "chameleon-34b")
TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _pair(arch, tie=False):
    """(JAX model, JAX params, port model) of the smoke ``arch`` (with
    tied embeddings if ``tie``), the weights drawn once by JAX."""
    jcfg, cfg = j_smoke_config(arch), smoke_config(arch)
    if tie:
        jcfg = dataclasses.replace(jcfg, tie_embeddings=True)
        cfg = dataclasses.replace(cfg, tie_embeddings=True)
    jm = JLM(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    model = LM(cfg, device="cpu")
    model.load_state_dict(
        lm_params_from_jax(jax.tree.map(np.asarray, params), cfg),
        strict=True)
    return jm, params, model


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _batch(arch, seed=0, b=2, s=16):
    vocab = smoke_config(arch).vocab_size
    toks = np.random.default_rng(seed).integers(1, vocab, (b, s)).astype(
        np.int32)
    return {"tokens": toks, "targets": np.roll(toks, -1, 1)}


# ------------------------------------------------------- prefill/decode --
@pytest.mark.parametrize("arch", ARCHS + DENSE)
def test_prefill_and_decode_match_jax(arch):
    jm, params, model = _pair(arch)
    toks = np.random.default_rng(2).integers(
        3, model.cfg.vocab_size, (2, 13)).astype(np.int32)
    max_len = 20
    jl, jst = jax.jit(lambda p, t: jm.prefill(p, t, max_len=max_len))(
        params, jnp.asarray(toks))
    tl, tst = model.prefill(torch.as_tensor(toks), max_len=max_len)
    _close(tl, jl)
    for jc, tc in zip(jax.tree.map(np.asarray, jst["caches"]),
                      tst["caches"]):
        assert set(jc) == set(tc)
        for name in tc:
            assert tuple(tc[name].shape) == jc[name].shape, name
            _close(tc[name], jc[name])
    step = jax.jit(jm.decode_step)
    for tok in (5, 17, 42, 99):
        t = np.full((2, 1), tok, np.int32)
        jl, jst = step(params, jst, jnp.asarray(t))
        tl, tst = model.decode_step(tst, torch.as_tensor(t))
        _close(tl, jl)
    for jc, tc in zip(jax.tree.map(np.asarray, jst["caches"]),
                      tst["caches"]):
        for name in tc:
            _close(tc[name], jc[name])
    np.testing.assert_array_equal(tst["pos"].numpy(), np.asarray(jst["pos"]))


def test_mla_decode_state_has_the_reference_layout():
    """An MLA group caches the compressed latent: {"ckv": (count, B,
    S_max, kv_lora_rank), "kpe": (count, B, S_max, rope_dim)}."""
    jm, _, model = _pair("deepseek-v3-671b")
    want = jax.tree.map(np.asarray, jm.init_decode_state(None, 3, 10))
    got = model.init_decode_state(3, 10)
    m = model.cfg.mla
    for jc, tc in zip(want["caches"], got["caches"]):
        assert {k: v.shape for k, v in jc.items()} == \
            {k: tuple(v.shape) for k, v in tc.items()}
        assert tuple(tc["ckv"].shape[1:]) == (3, 10, m.kv_lora_rank)
        assert tuple(tc["kpe"].shape[1:]) == (3, 10, m.qk_rope_head_dim)


# -------------------------------------------------------------- training --
@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_match_jax(arch):
    """logits, the MoE aux loss summed over the layers and, for
    deepseek-v3, the MTP logits (token t+2 from [h_t ; emb(t+1)])."""
    jm, params, model = _pair(arch)
    toks = _batch(arch, seed=3)["tokens"]
    want = jm.train_logits(params, jnp.asarray(toks))
    with torch.no_grad():
        got = model.train_logits(torch.as_tensor(toks))
    assert set(got) == set(want)
    assert ("mtp_logits" in got) == (arch == "deepseek-v3-671b")
    for name in got:
        _close(got[name], want[name])
    assert float(got["aux_loss"]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradients_match_jax(arch):
    """Loss and each metric (ce, aux, mtp_ce) within 1e-5 relative, each
    gradient leaf within 1e-4 of its largest entry."""
    jm, params, _ = _pair(arch)
    batch = _batch(arch)
    (j_loss, j_met), j_grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_lm_loss(jm, p, b), has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = _pair(arch)[2]
    model.requires_grad_(True)
    try:
        loss, metrics = lm_loss(model, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
        grads = torch.autograd.grad(loss, list(model.parameters()))
    finally:
        model.requires_grad_(False)
    assert set(metrics) == set(j_met) | {"loss"}
    for name in j_met:
        assert float(metrics[name].detach()) == pytest.approx(
            float(j_met[name]), rel=1e-5), name
    assert loss.item() == pytest.approx(float(j_loss), rel=1e-5)
    tree = params_to_jax(model, dict(zip(
        [n for n, _ in model.named_parameters()], grads)))[0]
    for (key, got), (key2, want) in zip(_leaves(tree), _leaves(j_grads)):
        assert key == key2
        err = float(np.abs(got - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()), (key, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_the_teacher_forced_forward(arch):
    """prefill + decode logits == train_logits at the same positions (the
    reference's ``test_decode_matches_train_forward``): drop-free, the
    decode group of B tokens routes as the per-row groups do."""
    _, _, model = _pair(arch)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        1, model.cfg.vocab_size, (2, 32)), dtype=torch.int32)
    with torch.no_grad():
        full = model.train_logits(toks)["logits"]
    k = 4
    _, state = model.prefill(toks[:, :-k], max_len=32)
    for t in range(32 - k, 32):
        logits, state = model.decode_step(state, toks[:, t:t + 1])
        torch.testing.assert_close(logits, full[:, t], rtol=TOL, atol=TOL)


# ------------------------------------------------------------ converter --
@pytest.mark.parametrize("arch,tie", [(a, False) for a in ARCHS]
                         + [("qwen3-moe-30b-a3b", True)])
def test_converter_round_trips_every_leaf(arch, tie):
    """to_jax(from_jax(tree)) is the reference's tree bitwise (router,
    experts, shared experts, the eight MLA leaves, ``mtp.*``; no
    ``lm_head`` with tied embeddings), and from_jax(to_jax(sd)) == sd."""
    jm, params, model = _pair(arch, tie)
    jtree = jax.tree.map(np.asarray, params)
    sd = params_from_jax(model, jtree)
    tree, paths = lm_params_to_jax(sd, model.cfg)
    assert jax.tree.structure(tree) == jax.tree.structure(jtree)
    for (k1, a), (k2, b) in zip(_leaves(tree), _leaves(jtree)):
        assert k1 == k2
        np.testing.assert_array_equal(a, b, err_msg=k1)
    assert set(paths.values()) == {k for k, _ in _leaves(jtree)}
    back = params_from_jax(model, tree)
    assert all(torch.equal(back[n], t) for n, t in sd.items())
    names = set(reference_leaves(model))
    assert ("lm_head.w" in names) == (not tie)
    if arch == "deepseek-v3-671b":
        assert {"mtp.proj.w", "mtp.norm.g", "mtp.block.ffn.router.w",
                "mtp.block.mixer.kv_down.w"} <= names
        assert reference_leaves(model)["mtp.block.ffn.router.w"].layer is None
    if arch == "moonshot-v1-16b-a3b":
        assert "groups.1.0.ffn.shared.down.w" in names


def test_tied_embeddings_match_jax():
    """``tie_embeddings``: the logits are the final hidden state against
    the embedding table; no ``lm_head`` is built."""
    jm, params, model = _pair("qwen3-moe-30b-a3b", tie=True)
    assert not hasattr(model, "lm_head")
    toks = np.random.default_rng(4).integers(3, 512, (2, 9)).astype(np.int32)
    jl, _ = jm.prefill(params, jnp.asarray(toks))
    tl, _ = model.prefill(torch.as_tensor(toks))
    _close(tl, jl)


# -------------------------------------------------------- registry, CLI --
@pytest.mark.parametrize("arch", ARCHS + DENSE)
def test_registry_resolves_the_new_names(arch):
    r = resolve(arch.replace("-", "_"), device="cpu", seed=1)
    assert (r.name, r.family) == (arch, "lm")
    assert r.cfg == smoke_config(arch)
    assert arch in available()
    # the full width on the meta device (shapes only): within 2% of the
    # reference's count, which leaves out the norm scales and the MTP
    # block (one more MoE layer, 1.7% of deepseek-v3-671b)
    n = sum(p.numel() for p in LM(get_config(arch), device="meta")
            .parameters())
    total = get_config(arch).param_counts()["total"]
    assert total <= n < 1.02 * total


@pytest.mark.parametrize("arch", ARCHS + DENSE)
def test_full_width_training_is_refused_on_one_card(arch):
    """16 bytes a float32 parameter (the parameter, its gradient, two
    AdamW moments): every new name exceeds an 80 GB card."""
    with pytest.raises(ValueError, match="use --smoke"):
        train_cli.check_fits(arch, 80 * 10**9)
