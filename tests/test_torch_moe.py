"""The port's MoE FFN on the CPU against the JAX package's.

The same expert weights (drawn by ``repro.models.layers.moe.moe_params``
and carried across) and the same numpy-seeded activations go through
``repro.models.layers.moe`` and ``repro_torch.models.layers.moe``:

* routing exactly: each token's top-k experts, and each assignment's
  ``keep`` and buffer slot (the reference's metadata is in its stable
  sort's order; the port's in the assignments' own order, so the test
  maps one onto the other);
* ``moe_ffn``'s output and load-balance loss within 1e-5, drop-free (the
  smoke rule, ``capacity_factor = E / top_k``) and at the assigned 1.25
  on a config whose capacity drops assignments (the test asserts that it
  does), for prefill (one group per row) and decode (S == 1: the whole
  batch is one group, so the rows are coupled);
* the shared experts (moonshot-v1-16b-a3b's two);
* the combine gives the same bits on a second call.

``lax.top_k`` puts the lower index first on ties and ``torch.topk``
promises nothing, so every case asserts that its router probabilities
have no exact tie among each token's top k+1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models.layers import moe as j_moe
from repro_torch.configs import smoke_config
from repro_torch.models.layers import moe
from _torch_threads import cap_threads

cap_threads()

TOL = 1e-5


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: torch.from_numpy(np.array(tree, dtype=np.float32))}


def _layer(arch, **moe_kw):
    """(JAX config, JAX params, port config, port MoE) of ``arch``'s smoke
    MoE, its MoEConfig fields replaced by ``moe_kw``."""
    jcfg, cfg = j_smoke_config(arch), smoke_config(arch)
    if moe_kw:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, **moe_kw))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **moe_kw))
    jp = j_moe.moe_params(jax.random.PRNGKey(0), jcfg)
    p = moe.MoE(cfg, device="cpu", generator=torch.Generator())
    p.load_state_dict(_flat(jax.tree.map(np.asarray, jp)), strict=True)
    return jcfg, jp, cfg, p


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _assert_no_ties(p, mo, x):
    probs = torch.softmax(torch.from_numpy(x).reshape(-1, x.shape[-1])
                          @ p.router.w, -1)
    top = torch.topk(probs, mo.top_k + 1, dim=-1).values.numpy()
    assert (np.diff(top, axis=-1) < 0).all()


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _routing_matches(jp, jcfg, p, cfg, groups):
    """Per group: top_i equal, and keep / slot of every assignment equal
    to the reference's once its sorted metadata is put back in the
    assignments' order.  Returns the number of dropped assignments."""
    mo = cfg.moe
    t, k = groups.shape[1], mo.top_k
    cap = moe.capacity(mo, t)
    assert cap == max(1, int(t * k * mo.capacity_factor / mo.num_experts
                             + 0.999))
    _, meta = moe.build_dispatch(p, mo, torch.from_numpy(groups), cap)
    dropped = 0
    for g in range(groups.shape[0]):
        _, jmeta = j_moe._build_dispatch(jp, jcfg.moe, jnp.asarray(groups[g]),
                                         cap)
        top_i = np.asarray(jmeta["top_i"])
        np.testing.assert_array_equal(meta["top_i"][g].numpy(), top_i)
        order = np.argsort(top_i.reshape(-1), kind="stable")
        np.testing.assert_array_equal(np.asarray(jmeta["tok_of"]),
                                      order // k)
        for name in ("keep", "slot"):
            want = np.empty(t * k, np.asarray(jmeta[name]).dtype)
            want[order] = np.asarray(jmeta[name])
            np.testing.assert_array_equal(
                meta[name][g].numpy().astype(want.dtype), want, err_msg=name)
        dropped += int((np.asarray(jmeta["keep"]) == 0).sum())
    return dropped


@pytest.mark.parametrize("capacity_factor,b,s", [
    (None, 2, 24),            # the smoke rule, E / top_k: drop-free prefill
    (None, 8, 1),             # drop-free decode: one group of 8
    (1.25, 2, 32),            # the assigned factor, 8 experts: drops
    (1.25, 8, 1),
])
def test_moe_ffn_and_routing_match_jax(capacity_factor, b, s):
    kw = {} if capacity_factor is None else dict(
        num_experts=8, top_k=2, capacity_factor=capacity_factor)
    jcfg, jp, cfg, p = _layer("qwen3-moe-30b-a3b", **kw)
    x = _x(b * 100 + s, (b, s, cfg.d_model))
    _assert_no_ties(p, cfg.moe, x)
    groups = x.reshape(1, b, -1) if s == 1 else x
    dropped = _routing_matches(jp, jcfg, p, cfg, groups)
    if capacity_factor is None:
        assert dropped == 0
    else:
        assert dropped > 0
        assert moe.dropped_share(p, cfg, torch.from_numpy(x)) == \
            pytest.approx(dropped / (b * s * cfg.moe.top_k))
    jy, jaux = j_moe.moe_ffn(jp, jcfg, jnp.asarray(x))
    y, aux = moe.moe_ffn(p, cfg, torch.from_numpy(x))
    assert y.shape == (b, s, cfg.d_model) and aux.dtype == torch.float32
    _close(y, jy)
    _close(aux, jaux)


def test_decode_rows_are_coupled_by_capacity():
    """With dropping, a row's decode output depends on the other rows of
    its batch (one group): some rows of a batch of 8 differ from the same
    row decoded alone, the same rows as in the reference."""
    jcfg, jp, cfg, p = _layer("qwen3-moe-30b-a3b", num_experts=8, top_k=2,
                              capacity_factor=1.25)
    x = _x(801, (8, 1, cfg.d_model))
    y8, _ = moe.moe_ffn(p, cfg, torch.from_numpy(x))
    jy8, _ = j_moe.moe_ffn(jp, jcfg, jnp.asarray(x))
    _close(y8, jy8)
    moved, j_moved = [], []
    for i in range(8):
        y1, _ = moe.moe_ffn(p, cfg, torch.from_numpy(x[i:i + 1]))
        jy1, _ = j_moe.moe_ffn(jp, jcfg, jnp.asarray(x[i:i + 1]))
        _close(y1, jy1)
        moved.append(float((y8[i] - y1[0]).abs().max()) > 1e-3)
        j_moved.append(float(np.abs(np.asarray(jy8[i])
                                    - np.asarray(jy1[0])).max()) > 1e-3)
    assert any(moved) and moved == j_moved


def test_shared_experts_match_jax():
    """moonshot-v1-16b-a3b: two shared experts as one SwiGLU of twice the
    expert width, added to the routed output."""
    jcfg, jp, cfg, p = _layer("moonshot-v1-16b-a3b")
    assert cfg.moe.num_shared_experts == 2
    assert p.shared.gate.w.shape == (cfg.d_model, 2 * cfg.moe.d_ff_expert)
    x = _x(5, (2, 9, cfg.d_model))
    _assert_no_ties(p, cfg.moe, x)
    jy, jaux = j_moe.moe_ffn(jp, jcfg, jnp.asarray(x))
    y, aux = moe.moe_ffn(p, cfg, torch.from_numpy(x))
    _close(y, jy)
    _close(aux, jaux)
    shared = p.shared(torch.from_numpy(x))
    assert float(shared.abs().max()) > 1e-2      # the shared part counts


def test_load_balance_loss_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((40, 8)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    top_i = np.argsort(-probs, axis=-1)[:, :2]
    want = j_moe.load_balance_loss(jnp.asarray(probs), jnp.asarray(top_i), 8)
    got = moe.load_balance_loss(torch.from_numpy(probs),
                                torch.from_numpy(top_i), 8)
    _close(got, want, 1e-6)


def test_combine_is_bitwise_repeatable():
    _, _, cfg, p = _layer("qwen3-moe-30b-a3b", num_experts=8, top_k=2,
                          capacity_factor=1.25)
    x = torch.from_numpy(_x(9, (3, 16, cfg.d_model)))
    first, _ = moe.moe_ffn(p, cfg, x)
    again, _ = moe.moe_ffn(p, cfg, x)
    assert torch.equal(first, again)


def test_moe_gradients_match_jax():
    """The gradient of a scalar of ``moe_ffn``'s output through the
    dispatch's scatter, the gates and the combine's gather, with
    dropping."""
    jcfg, jp, cfg, p = _layer("qwen3-moe-30b-a3b", num_experts=8, top_k=2,
                              capacity_factor=1.25)
    x = _x(11, (2, 16, cfg.d_model))
    w = _x(12, (2, 16, cfg.d_model))

    def j_obj(params, xx):
        y, aux = j_moe.moe_ffn(params, jcfg, xx)
        return jnp.sum(y * w) + aux

    jgx = jax.grad(j_obj, argnums=(0, 1))(jp, jnp.asarray(x))
    p.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_ffn(p, cfg, xt)
    (torch.sum(y * torch.from_numpy(w)) + aux).backward()
    _close(xt.grad, jgx[1], 1e-4)
    jflat = _flat(jax.tree.map(np.asarray, jgx[0]))
    for name, prm in p.named_parameters():
        want = jflat[name].numpy()
        err = float(np.abs(prm.grad.numpy() - want).max())
        assert err <= 1e-4 * max(float(np.abs(want).max()), 1e-6), name
