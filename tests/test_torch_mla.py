"""The port's multi-head latent attention (MLA) on the CPU against the
JAX package's.

The same weights (``repro.models.layers.attention.mla_params``, carried
across) and numpy-seeded activations go through both packages'
``mla_full`` (the expanded prefill form) and ``mla_decode`` (the
absorbed form against the compressed latent cache).  Also: absorbed
decode equals the expanded form token by token (the mirror of
``tests/test_layers.py``'s ``test_mla_decode_absorbed_matches_full``),
and a decode step at ``pos >= S_max`` drops its cache write, as the
reference's one-hot does.

Tolerance: 1e-5 for the layer's outputs and caches (float32; the two
packages reduce in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models.config import LayerGroup as JLayerGroup
from repro.models.config import MLAConfig as JMLAConfig
from repro.models.config import ModelConfig as JModelConfig
from repro.models.layers import attention as j_att
from repro_torch.configs import smoke_config
from repro_torch.models.config import LayerGroup, MLAConfig, ModelConfig
from repro_torch.models.layers import attention as att
from _torch_threads import cap_threads

cap_threads()

TOL = 1e-5


def _small(mc, lg, mla):
    """``tests/test_layers.py``'s MLA configuration (d_model 64)."""
    return mc(name="t", arch_type="moe", d_model=64, vocab_size=128,
              num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
              layer_plan=(lg(mixer="mla", ffn="dense", count=1),),
              mla=mla(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16)).validate()


def _layer(which="smoke"):
    if which == "smoke":
        jcfg = j_smoke_config("deepseek-v3-671b")
        cfg = smoke_config("deepseek-v3-671b")
    else:
        jcfg = _small(JModelConfig, JLayerGroup, JMLAConfig)
        cfg = _small(ModelConfig, LayerGroup, MLAConfig)
    jp = j_att.mla_params(jax.random.PRNGKey(0), jcfg)
    # the reference draws its norm scales as ones: give them values
    rng = np.random.default_rng(7)
    jp = jax.tree.map(np.asarray, jp)
    for name in ("q_norm", "kv_norm"):
        jp[name]["g"] = rng.uniform(0.5, 1.5, jp[name]["g"].shape).astype(
            np.float32)
    p = att.MLA(cfg, device="cpu", generator=torch.Generator())
    p.load_state_dict({f"{k}.{leaf}": torch.from_numpy(np.array(v[leaf]))
                       for k, v in jp.items() for leaf in v}, strict=True)
    return jcfg, jp, cfg, p


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def test_mla_leaves_have_the_reference_shapes():
    jcfg, jp, cfg, p = _layer()
    got = {n: tuple(t.shape) for n, t in p.named_parameters()}
    want = {f"{k}.{leaf}": v[leaf].shape for k, v in jp.items() for leaf in v}
    assert got == want
    assert set(k for k in jp) == {"q_down", "q_norm", "q_up", "kv_down",
                                  "kv_norm", "k_up", "v_up", "o"}


@pytest.mark.parametrize("s", [1, 7, 16])
def test_mla_full_matches_jax(s):
    jcfg, jp, cfg, p = _layer()
    x = _x(s, (2, s, cfg.d_model))
    jy, (jckv, jkpe) = j_att.mla_full(jp, jcfg, jnp.asarray(x))
    y, (ckv, kpe) = att.mla_full(p, cfg, torch.from_numpy(x))
    assert ckv.shape == (2, s, cfg.mla.kv_lora_rank)
    assert kpe.shape == (2, s, cfg.mla.qk_rope_head_dim)
    for got, want in ((y, jy), (ckv, jckv), (kpe, jkpe)):
        _close(got, want)


def test_mla_decode_matches_jax():
    """Steps at ragged positions against a cache of 12 slots, the cache
    written in place as the reference's is rebuilt."""
    jcfg, jp, cfg, p = _layer()
    m, b, s_max = cfg.mla, 3, 12
    ckv = _x(1, (b, s_max, m.kv_lora_rank))
    kpe = _x(2, (b, s_max, m.qk_rope_head_dim))
    jckv, jkpe = jnp.asarray(ckv), jnp.asarray(kpe)
    tckv, tkpe = torch.from_numpy(ckv.copy()), torch.from_numpy(kpe.copy())
    pos = np.array([0, 5, 11], np.int32)
    for step in range(3):
        x = _x(10 + step, (b, 1, cfg.d_model))
        p_ = pos + np.minimum(step, [2, 2, 0])       # the last row stays
        jy, jckv, jkpe = j_att.mla_decode(jp, jcfg, jnp.asarray(x), jckv,
                                          jkpe, jnp.asarray(p_))
        y = att.mla_decode(p, cfg, torch.from_numpy(x), tckv, tkpe,
                           torch.from_numpy(p_))
        _close(y, jy)
        _close(tckv, jckv)
        _close(tkpe, jkpe)


def test_absorbed_decode_matches_the_expanded_form():
    """Token-by-token absorbed decode == the expanded full form, and the
    cache holds the compressed latent (the reference's own check, on the
    port)."""
    _, _, cfg, p = _layer("small")
    s = 9
    x = torch.from_numpy(_x(1, (2, s, cfg.d_model)))
    y_full, (ckv, kpe) = att.mla_full(p, cfg, x)
    c_ckv = torch.zeros((2, s, cfg.mla.kv_lora_rank))
    c_kpe = torch.zeros((2, s, cfg.mla.qk_rope_head_dim))
    ys = [att.mla_decode(p, cfg, x[:, t:t + 1], c_ckv, c_kpe,
                         torch.full((2,), t, dtype=torch.int32))
          for t in range(s)]
    torch.testing.assert_close(torch.cat(ys, dim=1), y_full, rtol=5e-5,
                               atol=5e-5)
    torch.testing.assert_close(c_ckv, ckv, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(c_kpe, kpe, rtol=1e-6, atol=1e-6)


def test_decode_past_the_cache_drops_the_write():
    """``pos >= S_max``: the reference's one-hot is all zeros, so its
    cache stays and every slot is attended; the port leaves its cache
    unchanged and returns the reference's output."""
    jcfg, jp, cfg, p = _layer()
    m, b, s_max = cfg.mla, 2, 6
    ckv = _x(3, (b, s_max, m.kv_lora_rank))
    kpe = _x(4, (b, s_max, m.qk_rope_head_dim))
    tckv, tkpe = torch.from_numpy(ckv.copy()), torch.from_numpy(kpe.copy())
    pos = np.array([s_max, s_max + 3], np.int32)
    x = _x(5, (b, 1, cfg.d_model))
    jy, jckv, jkpe = j_att.mla_decode(jp, jcfg, jnp.asarray(x),
                                      jnp.asarray(ckv), jnp.asarray(kpe),
                                      jnp.asarray(pos))
    y = att.mla_decode(p, cfg, torch.from_numpy(x), tckv, tkpe,
                       torch.from_numpy(pos))
    _close(y, jy)
    np.testing.assert_array_equal(np.asarray(jckv), ckv)
    assert torch.equal(tckv, torch.from_numpy(ckv))
    assert torch.equal(tkpe, torch.from_numpy(kpe))
    assert torch.isfinite(y).all()
