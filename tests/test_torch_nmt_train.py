"""Training the port's three NMT models against the JAX reference, same
weights and batches.

Weights come only through ``repro_torch.convert``'s ``*_from_jax``
converters; batches are drawn with numpy and handed to both packages.
Tolerances: the loss within 1e-5 relative; every gradient leaf, carried
back to the reference's layout by ``params_to_jax``, within 1e-4 of that
leaf's largest JAX gradient (the two sides reduce in different orders);
Marian's kernel and training teacher paths within 2e-4, the tolerance
of ``tests/test_nmt_models.py``'s cache-vs-teacher check.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch  # noqa: F401
from repro.nmt import BiLSTMSeq2Seq as JBiLSTM
from repro.nmt import GRUSeq2Seq as JGRU
from repro.nmt import MarianTransformer as JMarian
from repro.nmt import RNNConfig as JRNNConfig
from repro.nmt import TransformerConfig as JTConfig
from repro.nmt.common import cross_entropy as j_cross_entropy
from repro.training.checkpoint import load_checkpoint as j_load
from repro.training.checkpoint import save_checkpoint as j_save
from repro.training.optimizer import adamw_init as j_adamw_init
from repro.training.optimizer import adamw_update as j_adamw_update
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.launch import train_nmt
from repro_torch.nmt import BiLSTMSeq2Seq, GRUSeq2Seq, MarianTransformer
from repro_torch.nmt import RNNConfig, TransformerConfig
from repro_torch.nmt.common import cross_entropy
from repro_torch.training.checkpoint import (
    checkpoint_step,
    load_checkpoint,
    save_checkpoint,
    state_from_jax,
    state_to_jax,
)
from repro_torch.training.train_loop import init_train_state
from _torch_threads import cap_threads

cap_threads()

V = 64
# the configurations of tests/test_nmt_models.py
MARIAN = dict(vocab_src=V, vocab_tgt=V, d_model=32, heads=4, d_ff=64,
              enc_layers=2, dec_layers=2, max_decode_len=24, max_src_len=64)
GRU = dict(vocab_src=V, vocab_tgt=V, embed=32, hidden=32, layers=1,
           max_decode_len=24)
BILSTM = dict(GRU, layers=2)
FAMILIES = {
    "marian": (JMarian, JTConfig, MarianTransformer, TransformerConfig,
               MARIAN),
    "gru": (JGRU, JRNNConfig, GRUSeq2Seq, RNNConfig, GRU),
    "bilstm": (JBiLSTM, JRNNConfig, BiLSTMSeq2Seq, RNNConfig, BILSTM),
}


@functools.lru_cache(maxsize=None)
def jax_model(family, key=0):
    jcls, jcfg, _, _, size = FAMILIES[family]
    jm = jcls(jcfg(**size))
    return jm, jm.init(jax.random.PRNGKey(key))


def port_model(family, key=0):
    """A fresh port model on the CPU carrying the reference's weights."""
    _, _, tcls, tcfg, size = FAMILIES[family]
    model = tcls(tcfg(**size), device="cpu")
    model.load_state_dict(params_from_jax(
        model, jax.tree.map(np.asarray, jax_model(family, key)[1])),
        strict=True)
    return model


def ragged_batch(seed, src_lens=(9, 5, 3, 7), tgt_lens=(7, 4, 6, 2)):
    """A padded_batches-shaped batch: prefix-padded source and target
    rows with their float32 masks."""
    rng = np.random.default_rng(seed)
    b, n, m = len(src_lens), max(src_lens), max(tgt_lens)
    src_mask = (np.arange(n)[None] < np.asarray(src_lens)[:, None]
                ).astype(np.float32)
    tgt_mask = (np.arange(m)[None] < np.asarray(tgt_lens)[:, None]
                ).astype(np.float32)
    src = (rng.integers(4, V, (b, n)) * src_mask).astype(np.int32)
    return {"src": src, "src_mask": src_mask,
            "tgt_in": (rng.integers(4, V, (b, m)) * tgt_mask).astype(np.int32),
            "tgt_out": (rng.integers(4, V, (b, m)) * tgt_mask
                        ).astype(np.int32),
            "tgt_mask": tgt_mask}


def as_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def leaves_with_paths(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def assert_grads_match(port_tree, jax_grads):
    """Each leaf within 1e-4 of its largest JAX gradient.  A leaf whose
    JAX gradient is rounding noise (under 1e-6 of the whole gradient's
    largest entry: a key projection's bias shifts every score of a query
    by the same amount, which the softmax ignores, so its exact gradient
    is 0) must be rounding noise in the port too."""
    mine, ref = leaves_with_paths(port_tree), leaves_with_paths(jax_grads)
    assert [k for k, _ in mine] == [k for k, _ in ref]
    top = max(float(np.abs(g).max()) for _, g in ref)
    for (key, got), (_, want) in zip(mine, ref):
        scale = float(np.abs(want).max())
        if scale < 1e-6 * top:
            assert float(np.abs(got).max()) < 1e-6 * top, key
        else:
            err = float(np.abs(got - want).max())
            assert err <= 1e-4 * scale, (key, err, scale)


# ---------------------------------------------------------------- losses --
def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 5, V)).astype(np.float32)
    targets = rng.integers(0, V, (3, 5)).astype(np.int32)
    for mask in (rng.integers(0, 2, (3, 5)).astype(np.float32),
                 np.zeros((3, 5), np.float32)):       # divisor max(sum, 1)
        want = float(j_cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                     jnp.asarray(mask)))
        got = float(cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(targets),
                                  torch.from_numpy(mask)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_gradients_match_reference(family):
    jm, params = jax_model(family)
    batch = ragged_batch(1)
    j_loss, j_grads = jax.jit(jax.value_and_grad(jm.loss))(params,
                                                          as_jax(batch))
    model = port_model(family)
    model.requires_grad_(True)
    loss = model.loss(as_torch(batch))
    loss.backward()
    assert loss.item() == pytest.approx(float(j_loss), rel=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert_grads_match(params_to_jax(model, grads)[0], j_grads)


def test_marian_teacher_paths_match_reference_pallas_and_each_other():
    """The kernel path (plain flash_attention on the CPU) against the
    reference's attn_impl="pallas" path (interpret mode) and the port's
    own training path, on a ragged batch."""
    _, params = jax_model("marian")
    batch = ragged_batch(2)
    jp = JMarian(JTConfig(**MARIAN), attn_impl="pallas")
    want = np.asarray(jp.forward_teacher(params, jnp.asarray(batch["src"]),
                                         jnp.asarray(batch["src_mask"]),
                                         jnp.asarray(batch["tgt_in"])))
    model = port_model("marian")
    b = as_torch(batch)
    with torch.no_grad():
        kern = model.forward_teacher(b["src"], b["src_mask"], b["tgt_in"],
                                     kernels=True)
        train = model.forward_teacher(b["src"], b["src_mask"], b["tgt_in"])
    np.testing.assert_allclose(kern.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(kern.numpy(), train.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_decreases_with_sgd(family):
    """A few SGD steps on a fixed batch reduce the loss (trainability),
    as tests/test_nmt_models.py checks the reference."""
    model = port_model(family, key=2)
    model.requires_grad_(True)
    rng = np.random.default_rng(1)
    B, N, M = 4, 6, 6
    batch = {
        "src": torch.from_numpy(rng.integers(4, V, (B, N)).astype(np.int32)),
        "src_mask": torch.ones((B, N)),
        "tgt_in": torch.from_numpy(rng.integers(4, V, (B, M)).astype(
            np.int32)),
        "tgt_out": torch.from_numpy(rng.integers(4, V, (B, M)).astype(
            np.int32)),
        "tgt_mask": torch.ones((B, M)),
    }
    l0 = model.loss(batch).item()
    for _ in range(15):
        grads = torch.autograd.grad(model.loss(batch),
                                    list(model.parameters()))
        with torch.no_grad():
            for p, g in zip(model.parameters(), grads):
                p.sub_(0.5 * g)
    assert model.loss(batch).item() < l0 - 0.1


def test_marian_cache_decode_matches_teacher_forward():
    """Incremental KV-cache decode == the parallel causally-masked
    forward, on both teacher paths."""
    cfg = dict(MARIAN, max_decode_len=16, max_src_len=32)
    jm = JMarian(JTConfig(**cfg))
    model = MarianTransformer(TransformerConfig(**cfg), device="cpu")
    model.load_state_dict(params_from_jax(model, jax.tree.map(
        np.asarray, jm.init(jax.random.PRNGKey(3)))))
    rng = np.random.default_rng(2)
    src = torch.from_numpy(rng.integers(4, V, (9,)).astype(np.int32))
    tgt = torch.from_numpy(rng.integers(4, V, (6,)).astype(np.int32))
    with torch.no_grad():
        enc, mask = model.encode(src)
        state = model.init_cache(enc, mask)
        inc = []
        for t in tgt:
            state, lg = model.decode_step(state, t)
            inc.append(lg)
        inc = torch.stack(inc).numpy()
        for kernels in (False, True):
            par = model.forward_teacher(src[None], torch.ones((1, 9)),
                                        tgt[None], kernels=kernels)[0]
            np.testing.assert_allclose(par.numpy(), inc, rtol=2e-4,
                                       atol=2e-4)


@pytest.mark.parametrize("family", ["gru", "bilstm"])
def test_rnn_teacher_encoder_runs_over_padding_as_the_reference(family):
    """The reference's teacher path scans every source position, pads
    included, so padding changes the RNNs' loss; the port's must change
    it the same way (the loss is held to the reference above), while
    the serving encoder freezes on pads."""
    model = port_model(family)
    batch = as_torch(ragged_batch(3))
    trimmed = {k: v[2:3] for k, v in batch.items()}       # source length 3
    trimmed["src"], trimmed["src_mask"] = (trimmed["src"][:, :3],
                                           trimmed["src_mask"][:, :3])
    with torch.no_grad():
        padded_loss = float(model.loss({k: v[2:3] for k, v in
                                        batch.items()}))
        assert padded_loss != float(model.loss(trimmed))
        enc = model.encode(batch["src"][2:3], batch["src_mask"][2:3])
        enc_trim = model.encode(trimmed["src"], trimmed["src_mask"])
    for a, b in zip(jax.tree.leaves(enc), jax.tree.leaves(enc_trim)):
        if a.shape == b.shape:
            torch.testing.assert_close(a, b)


# ------------------------------------------------------------ checkpoints --
def test_train_nmt_checkpoints_cross_both_ways(tmp_path):
    """examples/train_nmt.py's {"params", "opt"} checkpoint: written by
    the reference, it loads into the port bitwise; written by the port,
    it loads into the reference bitwise; the two hold the same keys."""
    jm, params = jax_model("marian")
    batch = as_jax(ragged_batch(4))
    j_opt = j_adamw_init(params)
    grads = jax.jit(jax.grad(jm.loss))(params, batch)
    j_params, j_opt = j_adamw_update(params, grads, j_opt, lr=1e-3)
    j_path = str(tmp_path / "jax.npz")
    j_save(j_path, {"params": j_params, "opt": j_opt}, step=1)

    model = port_model("marian")
    state = init_train_state(model)
    like = dict(zip(("params", "opt"),
                    state_to_jax(model, state.params, state.opt)))
    loaded = load_checkpoint(j_path, like)
    sd, opt = state_from_jax(model, loaded["params"], loaded["opt"])
    ref_sd = params_from_jax(model, jax.tree.map(np.asarray, j_params))
    for name, t in sd.items():
        assert torch.equal(t, ref_sd[name]), name
    for mine, ref in ((opt.mu, j_opt.mu), (opt.nu, j_opt.nu)):
        ref = params_from_jax(model, jax.tree.map(np.asarray, ref))
        for name, t in mine.items():
            assert torch.equal(t, ref[name]), name
    assert int(opt.step) == 1 and checkpoint_step(j_path) == 1

    model.load_state_dict(sd)
    t_path = str(tmp_path / "port.npz")
    p_tree, o_tree = state_to_jax(model, dict(model.named_parameters()), opt)
    save_checkpoint(t_path, {"params": p_tree, "opt": o_tree}, step=1)
    back = j_load(t_path, {"params": params, "opt": j_adamw_init(params)})
    for (k1, a), (k2, b) in zip(
            leaves_with_paths(back),
            leaves_with_paths({"params": j_params, "opt": j_opt})):
        assert k1 == k2 and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=k1)
    with np.load(j_path) as zj, np.load(t_path) as zt:
        assert set(zj.files) == set(zt.files)
        assert "['opt'].mu['dec'][0]['self']['q']['w']" in zt.files


# ------------------------------------------------------------------- CLI --
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_nmt_runs_on_the_cpu(family, tmp_path):
    path = str(tmp_path / "ckpt.npz")
    losses = train_nmt.main(["--device", "cpu", "--model", family,
                             "--steps", "24", "--batch", "8",
                             "--ckpt", path])
    assert len(losses) == 24 and np.all(np.isfinite(losses))
    assert train_nmt.loss_dropped(losses)
    assert checkpoint_step(path) == 24
    with np.load(path) as z:
        assert "['opt'].step" in z.files
