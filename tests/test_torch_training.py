"""The port's training substrate against the JAX reference: AdamW, the
schedule and clipping, the LM loss and train step for rwkv6-3b and
zamba2-1.2b at smoke size, the weight converters both ways, and
checkpoints that both packages read.

Weights come only through ``repro_torch.convert``'s ``*_from_jax``
converters; inputs are drawn with numpy and handed to both packages.
Tolerances: one AdamW update within 1e-6 relative; the LM loss within
1e-5 relative; every gradient leaf within 1e-4 of that leaf's largest
JAX gradient; parameters after one train step within 1e-5 (see
``test_train_step_matches_reference`` for the entries whose gradient is
rounding noise); converters and checkpoints bitwise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch  # noqa: F401
from repro.configs import smoke_config as j_smoke_config
from repro.models.model import LM as JLM
from repro.nmt import BiLSTMSeq2Seq as JBiLSTM
from repro.nmt import GRUSeq2Seq as JGRU
from repro.nmt import MarianTransformer as JMarian
from repro.nmt import RNNConfig as JRNNConfig
from repro.nmt import TransformerConfig as JTConfig
from repro.training.checkpoint import load_checkpoint as j_load
from repro.training.checkpoint import save_checkpoint as j_save
from repro.training.losses import lm_loss as j_lm_loss
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro.training.optimizer import adamw_init as j_adamw_init
from repro.training.optimizer import adamw_update as j_adamw_update
from repro.training.optimizer import clip_by_global_norm as j_clip
from repro.training.optimizer import cosine_schedule as j_cosine
from repro.training.train_loop import TrainState as JTrainState
from repro.training.train_loop import make_train_step as j_make_train_step
from repro_torch import training
from repro_torch.configs import smoke_config
from repro_torch.convert import (
    bilstm_params_to_jax,
    gru_params_to_jax,
    lm_params_to_jax,
    marian_params_to_jax,
    params_from_jax,
    params_to_jax,
    reference_leaves,
)
from repro_torch.kernels import ops
from repro_torch.launch import train as train_cli
from repro_torch.models.model import LM
from repro_torch.nmt import BiLSTMSeq2Seq, GRUSeq2Seq, MarianTransformer
from repro_torch.nmt import RNNConfig, TransformerConfig
from repro_torch.training.checkpoint import (
    checkpoint_step,
    load_checkpoint,
    save_checkpoint,
    state_from_jax,
    state_to_jax,
)
from repro_torch.training.losses import lm_loss
from repro_torch.training.optimizer import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
)
from repro_torch.training.train_loop import (
    TrainState,
    init_train_state,
    leaf_ndims,
    make_train_step,
)
from _torch_threads import cap_threads

cap_threads()

ARCHS = ("rwkv6-3b", "zamba2-1.2b", "qwen3-8b")
V = 64
MARIAN = dict(vocab_src=V, vocab_tgt=V, d_model=32, heads=4, d_ff=64,
              enc_layers=2, dec_layers=2, max_decode_len=24, max_src_len=64)
RNN = dict(vocab_src=V, vocab_tgt=V, embed=32, hidden=32, max_decode_len=24)


@functools.lru_cache(maxsize=None)
def jax_lm(arch):
    jm = JLM(j_smoke_config(arch))
    return jm, jm.init(jax.random.PRNGKey(0))


def port_lm(arch):
    """A fresh smoke LM on the CPU carrying the reference's weights."""
    model = LM(smoke_config(arch), device="cpu")
    model.load_state_dict(lm_params_from_jax_tree(model, jax_lm(arch)[1]),
                          strict=True)
    return model


def lm_params_from_jax_tree(model, params):
    return params_from_jax(model, jax.tree.map(np.asarray, params))


def lm_batch(arch, seed=0, b=2, s=16):
    vocab = smoke_config(arch).vocab_size
    toks = np.random.default_rng(seed).integers(1, vocab, (b, s)).astype(
        np.int32)
    return {"tokens": toks, "targets": np.roll(toks, -1, 1)}


def leaves_with_paths(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


# --------------------------------------------------------------- optimizer
def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0]), "b": torch.tensor(2.0)}
    opt = adamw_init(params)
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)

    def loss(p):
        return torch.sum(p["w"] ** 2) + p["b"] ** 2

    for _ in range(200):
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            g = dict(zip(leaves, torch.autograd.grad(loss(leaves),
                                                     list(leaves.values()))))
        params, opt = adamw_update(params, g, opt, lr=0.1, cfg=cfg)
    assert float(loss(params)) < 1e-3
    assert int(opt.step) == 200


def test_weight_decay_only_on_matrices_of_the_reference():
    """Decay follows the reference leaf's rank: a port vector that is one
    layer of a stacked (count, d) leaf is decayed."""
    params = {"w": torch.ones((2, 2)), "g": torch.ones((2,)),
              "stacked": torch.ones((2,))}
    zero_g = {k: torch.zeros_like(v) for k, v in params.items()}
    cfg = AdamWConfig(lr=0.1, weight_decay=0.5)
    p2, _ = adamw_update(params, zero_g, adamw_init(params), lr=0.1, cfg=cfg,
                         leaf_ndim={"w": 2, "g": 1, "stacked": 2})
    assert float((p2["w"] - 1.0).abs().max()) > 1e-3     # decayed
    assert float((p2["g"] - 1.0).abs().max()) < 1e-6     # exempt
    assert float((p2["stacked"] - 1.0).abs().max()) > 1e-3


def test_lm_leaf_ranks_follow_the_stacked_reference_leaves():
    model = LM(smoke_config("zamba2-1.2b"), device="cpu")
    ndims = leaf_ndims(model)
    jtree = jax.tree.map(np.asarray, jax_lm("zamba2-1.2b")[1])
    ref = dict(leaves_with_paths(jtree))
    for name, leaf in reference_leaves(model).items():
        assert ndims[name] == ref[leaf.keystr].ndim, name
    assert ndims["groups.0.0.ln1.g"] == 2       # stacked: decayed
    assert ndims["shared_attn.ln1.g"] == 1      # held once: exempt


def test_clip_by_global_norm():
    g = {"a": torch.full((10,), 10.0)}
    clipped, gn = clip_by_global_norm(g, 1.0)
    assert float(gn) == pytest.approx(np.sqrt(1000.0), rel=1e-5)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(
        1.0, rel=1e-4)


def test_cosine_schedule_shape_and_reference_values():
    sched = cosine_schedule(1e-3, warmup_steps=10, total_steps=100)
    ref = j_cosine(1e-3, warmup_steps=10, total_steps=100)
    assert float(sched(torch.tensor(0))) == 0.0
    assert float(sched(torch.tensor(10))) == pytest.approx(1e-3, rel=1e-5)
    assert float(sched(torch.tensor(100))) == pytest.approx(1e-4, rel=1e-3)
    assert float(sched(torch.tensor(55))) < 1e-3
    for s in (0, 3, 10, 11, 55, 99, 100, 150):
        assert float(sched(torch.tensor(s, dtype=torch.int32))) == \
            pytest.approx(float(ref(jnp.asarray(s, jnp.int32))), rel=1e-6)


def test_adamw_update_matches_reference_on_marian_params():
    """Two clipped AdamW steps on converted Marian parameters, the same
    numpy gradients fed to both packages: parameters and moments within
    1e-6 relative of the reference's."""
    jparams = JMarian(JTConfig(**MARIAN)).init(jax.random.PRNGKey(0))
    model = MarianTransformer(TransformerConfig(**MARIAN), device="cpu")
    params = params_from_jax(model, jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(0)
    jcfg, cfg = JAdamWConfig(weight_decay=0.1), AdamWConfig(weight_decay=0.1)
    jopt, opt = j_adamw_init(jparams), adamw_init(params)
    ndims = leaf_ndims(model)
    for step in range(2):
        jgrads = jax.tree.map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(
                np.float32) * 0.3), jparams)
        grads = params_from_jax(model, jax.tree.map(np.asarray, jgrads))
        jgrads, jgn = j_clip(jgrads, 1.0)
        grads, gn = clip_by_global_norm(grads, 1.0)
        assert float(gn) == pytest.approx(float(jgn), rel=1e-6)
        jparams, jopt = j_adamw_update(jparams, jgrads, jopt, lr=3e-4,
                                       cfg=jcfg)
        params, opt = adamw_update(params, grads, opt, lr=3e-4, cfg=cfg,
                                   leaf_ndim=ndims)
    assert int(opt.step) == int(jopt.step) == 2
    for mine, ref in ((params, jparams), (opt.mu, jopt.mu),
                      (opt.nu, jopt.nu)):
        ref = params_from_jax(model, jax.tree.map(np.asarray, ref))
        for name, t in mine.items():
            np.testing.assert_allclose(t.numpy(), ref[name].numpy(),
                                       rtol=1e-6, atol=1e-6 * float(
                                           ref[name].abs().max()), err_msg=name)


# ------------------------------------------------------------- converters
def _nmt_pairs():
    return [
        ("marian", JMarian(JTConfig(**MARIAN)),
         MarianTransformer(TransformerConfig(**MARIAN), device="cpu"),
         marian_params_to_jax),
        ("gru", JGRU(JRNNConfig(layers=1, **RNN)),
         GRUSeq2Seq(RNNConfig(layers=1, **RNN), device="cpu"),
         gru_params_to_jax),
        ("bilstm", JBiLSTM(JRNNConfig(layers=2, **RNN)),
         BiLSTMSeq2Seq(RNNConfig(layers=2, **RNN), device="cpu"),
         bilstm_params_to_jax),
    ]


@pytest.mark.parametrize("kind", ["marian", "gru", "bilstm", *ARCHS])
def test_converters_round_trip_bitwise(kind):
    """to_jax(from_jax(tree)) has the reference's structure, keys, shapes
    and values; from_jax(to_jax(sd)) == sd; the keystr paths are the
    reference's."""
    if kind in ARCHS:
        jm, params = jax_lm(kind)
        model = LM(smoke_config(kind), device="cpu")
        to_jax = lambda sd: lm_params_to_jax(sd, model.cfg)
    else:
        _, jm, model, to_jax = next(p for p in _nmt_pairs() if p[0] == kind)
        params = jm.init(jax.random.PRNGKey(0))
    jtree = jax.tree.map(np.asarray, params)
    sd = params_from_jax(model, jtree)
    model.load_state_dict(sd, strict=True)
    tree, paths = to_jax(sd)
    assert jax.tree.structure(tree) == jax.tree.structure(jtree)
    for (k1, a), (k2, b) in zip(leaves_with_paths(tree),
                                leaves_with_paths(jtree)):
        assert k1 == k2 and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=k1)
    assert set(paths) == set(sd)
    assert set(paths.values()) == {k for k, _ in leaves_with_paths(jtree)}
    assert params_to_jax(model)[1] == paths
    back = params_from_jax(model, tree)
    assert set(back) == set(sd)
    for name, t in sd.items():
        assert torch.equal(back[name], t), name


# ---------------------------------------------------------------- LM loss
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradients_match_reference(arch):
    """Loss within 1e-5, each gradient leaf within 1e-4 of its largest
    entry.  The smoke rwkv6's
    gradient is ill-conditioned on other batches: see
    ``test_rwkv6_reference_gradient_moves_under_a_1e7_perturbation``."""
    jm, params = jax_lm(arch)
    batch = lm_batch(arch)
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_lm_loss(jm, p, b), has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = port_lm(arch)
    model.requires_grad_(True)
    loss, metrics = lm_loss(model, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    assert float(metrics["aux"]) == 0.0
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert loss.item() == pytest.approx(float(j_loss), rel=1e-5)
    tree = params_to_jax(model, dict(zip(
        [n for n, _ in model.named_parameters()], grads)))[0]
    for (key, got), (_, want) in zip(leaves_with_paths(tree),
                                     leaves_with_paths(j_grads)):
        err = float(np.abs(got - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()), (key, err)


def _reference_grads(arch, batch, embed_scale=None):
    jm, params = jax_lm(arch)
    if embed_scale is not None:
        params = dict(params, embed={"w": params["embed"]["w"] * embed_scale})
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.jit(jax.grad(lambda p: j_lm_loss(jm, p, jb)[0]))(params)


def _worst_leaf_error(a, b):
    """Largest |a - b| of any leaf over that leaf's largest |b|."""
    return max(float(np.abs(x - y).max()) / float(np.abs(y).max())
               for (_, x), (_, y) in zip(leaves_with_paths(a),
                                         leaves_with_paths(b)))


def test_rwkv6_reference_gradient_moves_under_a_1e7_perturbation():
    """Why the rwkv6 gradient test uses seed 0: on ``lm_batch(seed=1)``
    scaling the embeddings by 1 + 1e-7 N(0, 1) moves the reference's own
    gradient by more than 1e-4 of a leaf's largest entry (1.14e-4: the
    backward amplifies a change of one part in 10^7 about 10^3 times),
    so float32 rounding differences show at that size.  There the port
    is within 1e-3 of the reference (3.5e-4), the tolerance the train
    step test gives the gradient norm."""
    arch = "rwkv6-3b"
    batch = lm_batch(arch, seed=1)
    want = _reference_grads(arch, batch)
    noise = np.random.default_rng(5).standard_normal(
        np.shape(jax_lm(arch)[1]["embed"]["w"])).astype(np.float32)
    floor = _worst_leaf_error(_reference_grads(arch, batch,
                                               1 + 1e-7 * noise), want)
    model = port_lm(arch)
    model.requires_grad_(True)
    loss, _ = lm_loss(model, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(model.parameters()))
    got = params_to_jax(model, dict(zip(
        [n for n, _ in model.named_parameters()], grads)))[0]
    err = _worst_leaf_error(got, want)
    assert floor > 1e-4
    assert err <= 1e-3, (err, floor)


@pytest.mark.parametrize("which", ["rwkv6_wkv", "ssd_scan"])
def test_training_scans_differentiate_like_a_float64_recurrence(which):
    """The LM's training path differentiates the scans' plain versions:
    their float32 gradients equal those of the step-by-step recurrence
    in float64 within 1e-5 of each input's largest entry."""
    from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv_plain
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    rng = np.random.default_rng(3)
    b, s, h, p, n = 2, 32, 3, 16, 8
    draw = lambda *shape: torch.from_numpy(rng.standard_normal(shape))
    if which == "rwkv6_wkv":
        ins = [draw(b, s, h, p), draw(b, s, h, p), draw(b, s, h, p),
               -torch.from_numpy(rng.uniform(1e-4, 2.5, (b, s, h, p))),
               draw(h, p)]

        def plain(r, k, v, lw, u):
            return rwkv6_wkv_plain(r, k, v, lw, u, chunk=16)[0]

        def recurrence(r, k, v, lw, u):
            state, ys = torch.zeros(b, h, p, p, dtype=r.dtype), []
            for t in range(s):
                kv = torch.einsum("bhp,bhq->bhpq", k[:, t], v[:, t])
                ys.append(torch.einsum("bhp,bhpq->bhq", r[:, t],
                                       state + u[None, :, :, None] * kv))
                state = state * torch.exp(lw[:, t])[..., None] + kv
            return torch.stack(ys, 1)
    else:
        ins = [draw(b, s, h, p),
               torch.from_numpy(rng.uniform(0.01, 0.5, (b, s, h))),
               torch.from_numpy(rng.uniform(-1.0, 1.0, h)),
               draw(b, s, h, n), draw(b, s, h, n)]

        def plain(x, dt, a_log, bb, cc):
            return ssd_scan_plain(x, dt, a_log, bb, cc, chunk=16)[0]

        def recurrence(x, dt, a_log, bb, cc):
            state, ys = torch.zeros(b, h, p, n, dtype=x.dtype), []
            for t in range(s):
                decay = torch.exp(dt[:, t] * -torch.exp(a_log))
                state = state * decay[..., None, None] + torch.einsum(
                    "bh,bhp,bhn->bhpn", dt[:, t], x[:, t], bb[:, t])
                ys.append(torch.einsum("bhpn,bhn->bhp", state, cc[:, t]))
            return torch.stack(ys, 1)
    weight = draw(b, s, h, p)
    grads = []
    for dtype, fn in ((torch.float32, plain), (torch.float64, recurrence)):
        xs = [t.to(dtype).requires_grad_(True) for t in ins]
        out = (fn(*xs) * weight.to(dtype)).sum()
        grads.append(torch.autograd.grad(out, xs))
    for got, want in zip(*grads):
        err = float((got.double() - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), err


@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_launch_no_kernel_and_match_prefill(arch):
    """``train_logits`` is the full causal forward of the training path:
    its last position equals ``prefill``'s logits, and it counts no
    kernel launch."""
    model = port_lm(arch)
    toks = torch.from_numpy(lm_batch(arch)["tokens"])
    ops.reset_launch_counts()
    with torch.no_grad():
        out = model.train_logits(toks)
    assert all(n == 0 for n in ops.launch_counts().values())
    last, _ = model.prefill(toks)
    torch.testing.assert_close(out["logits"][:, -1], last, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_reduces_loss(arch):
    model = port_lm(arch)
    state = init_train_state(model)
    step = make_train_step(model)
    batch = lm_batch(arch)
    losses = []
    for _ in range(8):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One full step (loss, grads, clip, AdamW) against the reference's
    ``make_train_step`` on the same batch.  Every parameter entry whose
    reference gradient is above its leaf's gradient rounding noise
    (1e-4 of the leaf's largest, the gradient test's tolerance) is
    within 1e-5.  Adam's first update is g / |g| per entry, so an entry
    whose gradient is rounding noise may take either sign: those may
    differ by up to 2 lr (1 + weight decay), the most one step moves."""
    jm, params = jax_lm(arch)
    batch = lm_batch(arch, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate, jmet = jax.jit(j_make_train_step(jm))(
        JTrainState(params, j_adamw_init(params)), jb)
    jgrads = jax.jit(jax.grad(lambda p: j_lm_loss(jm, p, jb)[0]))(params)
    model = port_lm(arch)
    step = make_train_step(model)
    state, met = step(init_train_state(model), batch)
    assert float(met["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-5)
    # rwkv6's gradient moves by 1.1e-4 of a leaf's largest entry under a
    # 1e-7 perturbation of the embeddings on this batch (see
    # test_rwkv6_reference_gradient_moves_under_a_1e7_perturbation)
    assert float(met["grad_norm"]) == pytest.approx(
        float(jmet["grad_norm"]), rel=1e-3)
    cfg = AdamWConfig()
    tree = params_to_jax(model)[0]
    for (key, got), (_, want), (_, g) in zip(
            leaves_with_paths(tree), leaves_with_paths(jstate.params),
            leaves_with_paths(jgrads)):
        err = np.abs(got - want)
        determined = np.abs(g) > 1e-4 * np.abs(g).max()
        assert float(err[determined].max(initial=0)) <= 1e-5, key
        bound = 2 * cfg.lr * (1 + cfg.weight_decay * np.abs(want).max())
        assert float(err.max()) <= bound, key


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_train_step_equals_the_plain_step(arch):
    batch = lm_batch(arch, seed=2)
    results = []
    for remat in (False, True):
        model = port_lm(arch)
        state, met = make_train_step(model, remat=remat)(
            init_train_state(model), batch)
        results.append((float(met["loss"]), [
            p.detach().clone() for p in state.params.values()]))
    assert results[0][0] == results[1][0]
    for a, b in zip(results[0][1], results[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


# ------------------------------------------------------------ checkpoints
def test_training_exports_the_reference_names():
    from repro import training as j_training
    assert training.__all__ == j_training.__all__


def test_checkpoint_roundtrip(tmp_path):
    model = LM(smoke_config("zamba2-1.2b"), device="cpu")
    state = init_train_state(model)
    tree = TrainState(*state_to_jax(model, state.params, state.opt))
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, tree, step=7)
    other = LM(smoke_config("zamba2-1.2b"), device="cpu", seed=1)
    st1 = init_train_state(other)
    like = TrainState(*state_to_jax(other, st1.params, st1.opt))
    restored = load_checkpoint(path, like)
    for (k1, a), (k2, b) in zip(leaves_with_paths(tree),
                                leaves_with_paths(restored)):
        assert k1 == k2
        np.testing.assert_array_equal(a, b)
    sd, opt = state_from_jax(other, restored.params, restored.opt)
    for name, p in state.params.items():
        assert torch.equal(sd[name], p.detach()), name
    assert checkpoint_step(path) == 7


def test_checkpoint_shape_mismatch_and_missing_leaf_raise(tmp_path):
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, {"w": torch.ones((2, 2))})
    with pytest.raises(ValueError):
        load_checkpoint(path, {"w": np.ones((3, 3))})
    with pytest.raises(KeyError):
        load_checkpoint(path, {"w": np.ones((2, 2)), "b": np.ones(2)})


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_train_state_checkpoints_cross_both_ways(arch, tmp_path):
    """``repro.launch.train``'s TrainState checkpoint: the reference's
    loads into the port bitwise, the port's into the reference bitwise,
    with the same keys."""
    jm, params = jax_lm(arch)
    jb = {k: jnp.asarray(v) for k, v in lm_batch(arch).items()}
    jstate, _ = jax.jit(j_make_train_step(jm))(
        JTrainState(params, j_adamw_init(params)), jb)
    j_path = str(tmp_path / "jax.npz")
    j_save(j_path, jstate, step=1)

    model = port_lm(arch)
    state = init_train_state(model)
    loaded = load_checkpoint(j_path, TrainState(
        *state_to_jax(model, state.params, state.opt)))
    sd, opt = state_from_jax(model, loaded.params, loaded.opt)
    for mine, ref in ((sd, jstate.params), (opt.mu, jstate.opt.mu),
                      (opt.nu, jstate.opt.nu)):
        ref = params_from_jax(model, jax.tree.map(np.asarray, ref))
        for name, t in mine.items():
            assert torch.equal(t, ref[name]), name

    model.load_state_dict(sd)
    t_path = str(tmp_path / "port.npz")
    save_checkpoint(t_path, TrainState(*state_to_jax(
        model, dict(model.named_parameters()), opt)), step=1)
    back = j_load(t_path, JTrainState(params, j_adamw_init(params)))
    for (k1, a), (k2, b) in zip(leaves_with_paths(back),
                                leaves_with_paths(jstate)):
        assert k1 == k2 and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=k1)
    with np.load(j_path) as zj, np.load(t_path) as zt:
        assert set(zj.files) == set(zt.files)


# ---------------------------------------------------------- kernel guard
def test_kernel_guard_refuses_autograd_and_allows_no_grad():
    """The wrappers' guard (reached on CUDA tensors only): under grad mode
    with an operand that requires grad it raises; under no_grad, or with
    no operand requiring grad, it lets the launch through."""
    w = torch.ones(2, requires_grad=True)
    x = torch.ones(2)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops._refuse_autograd("flash_attention", x, w * 2)
    with pytest.raises(RuntimeError, match="LM.train_logits"):
        ops._refuse_autograd("ssd_scan", x, None, w)
    ops._refuse_autograd("rwkv6_wkv", x, None)
    with torch.no_grad():
        ops._refuse_autograd("flash_decode", x, w * 2)


def test_plain_kernels_differentiate_on_the_cpu():
    """On the CPU the wrappers run the plain versions, which autograd
    differentiates: nothing changes there."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 5, 2, 16)).astype(
        np.float32)).requires_grad_(True)
    out = ops.flash_attention(q, q, q, causal=True)
    (g,) = torch.autograd.grad(out.square().sum(), [q])
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0


# ------------------------------------------------------------------- CLI
def test_train_cli_runs_on_the_cpu(tmp_path):
    path = str(tmp_path / "lm.npz")
    losses = train_cli.main(["--arch", "zamba2-1.2b", "--smoke", "--device",
                             "cpu", "--steps", "4", "--batch", "2",
                             "--seq", "16", "--ckpt", path])
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    assert checkpoint_step(path) == 4
    with np.load(path) as z:
        assert ".opt.step" in z.files


def test_train_cli_refuses_unported_architectures():
    with pytest.raises(ValueError, match="encoder-decoder"):
        train_cli.main(["--arch", "whisper-large-v3", "--smoke", "--device",
                        "cpu"])
