"""Sliding-window attention and the ring KV cache (the long_500k
variants) on the CPU against the JAX package.

* the kernels' plain versions with ``window``: ``flash_attention_plain``
  against the reference's ``blocked_sdpa(window=)``, ``flash_decode_plain``
  against its linear-cache window mask (``attn_decode``'s);
* one attention layer's decode on the same converted weights: the linear
  cache with a window and the ring cache against JAX's
  ``attn_decode(window=)`` / ``attn_decode(ring=True)`` through a wrap,
  and the ring against the linear window (the reference's
  ``tests/test_layers.py:88-107``);
* ``get_config(shape="long_500k")`` and ``init_decode_state`` shapes equal
  to JAX's.

Tolerance: 1e-5 for one attention call or layer (float32; the two
packages reduce in different orders).  The models under a window are
``tests/test_torch_swa_models.py``'s, the slot table under a window
``tests/test_torch_swa_serving.py``'s.
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
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels.decode_attention import flash_decode_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models.layers import attention as att
from repro_torch.models.model import LM
from _torch_threads import cap_threads

cap_threads()

WINDOW = 8           # smoke_config's cap on the 4096 window


def _swa_smoke(name, jax_side=False):
    """The smoke configuration of ``name`` with its long-decode window,
    capped at 8 as ``smoke_config`` caps a configured window."""
    get, smoke = (j_get_config, j_smoke_config) if jax_side else \
        (get_config, smoke_config)
    window = min(get(name, shape="long_500k").sliding_window, WINDOW)
    return dataclasses.replace(smoke(name), sliding_window=window,
                               name=smoke(name).name + "-swa")


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------- configs --
@pytest.mark.parametrize("name", ["qwen3-8b", "zamba2-1.2b"])
def test_long_500k_variants_match_the_reference(name):
    mine, ref = get_config(name, "long_500k"), j_get_config(name, "long_500k")
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert (mine.sliding_window, mine.name) == (4096, name + "-swa")
    # no long-decode variant: the assigned configuration comes back
    assert get_config("rwkv6-3b", "long_500k") == get_config("rwkv6-3b")


@pytest.mark.parametrize("name", ["qwen3-8b", "zamba2-1.2b"])
@pytest.mark.parametrize("max_len", [5, WINDOW, 20])
def test_init_decode_state_shapes_match_jax(name, max_len):
    """Attention caches of min(max_len, window) slots: a ring at the
    window; the meta device allocates nothing."""
    cfg = _swa_smoke(name)
    jm = JLM(_swa_smoke(name, jax_side=True))
    want = jax.eval_shape(lambda: jm.init_decode_state(None, 2, max_len))
    got = LM(cfg, device="meta").init_decode_state(2, max_len)
    assert jax.tree.map(lambda a: tuple(a.shape), want) == \
        jax.tree.map(lambda t: tuple(t.shape), got)


def test_ring_cache_bytes_at_500k():
    """qwen3-8b's float32 KV cache at 524288 positions against its ring."""
    cfg = get_config("qwen3-8b", "long_500k")
    per_slot = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * 4
    assert per_slot * 524288 == 154_618_822_656          # 154.6 GB linear
    assert per_slot * cfg.sliding_window == 1_207_959_552  # 1.21 GB ring
    state = LM(cfg, device="meta").init_decode_state(1, 524288)
    assert sum(t.numel() * 4 for t in state["caches"][0].values()) == \
        per_slot * cfg.sliding_window


# ---------------------------------------------------------- plain kernels --
@pytest.mark.parametrize("window", [1, 3, 8, 40])
def test_flash_attention_plain_window_matches_blocked_sdpa(window):
    rng = np.random.default_rng(window)
    q = rng.standard_normal((2, 24, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
            for _ in range(2))
    want = j_att.blocked_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, window=window, q_block=8)
    got = flash_attention_plain(torch.as_tensor(q), torch.as_tensor(k),
                                torch.as_tensor(v), causal=True,
                                window=window)
    _close(got, want, 1e-5)
    with pytest.raises(ValueError, match="causal"):
        flash_attention_plain(torch.as_tensor(q), torch.as_tensor(k),
                              torch.as_tensor(v), causal=False,
                              window=window)


@pytest.mark.parametrize("window", [1, 4, 16, 100])
def test_flash_decode_plain_window_matches_the_window_mask(window):
    """lengths = pos + 1, some past the cache (every slot attended, the
    window still bounding them): the reference's mask idx <= pos and
    idx > pos - window."""
    rng = np.random.default_rng(window)
    b, s_max, h, hkv, d = 5, 32, 4, 2, 16
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kc, vc = (rng.standard_normal((b, s_max, hkv, d)).astype(np.float32)
              for _ in range(2))
    pos = np.array([0, 5, 31, 35, 60], np.int32)
    idx = np.arange(s_max)[None, :]
    mask = (idx <= pos[:, None]) & (idx > pos[:, None] - window)
    want = j_att.sdpa(jnp.asarray(q)[:, None], jnp.asarray(kc),
                      jnp.asarray(vc), jnp.asarray(mask)[:, None, :])[:, 0]
    got = flash_decode_plain(torch.as_tensor(q), torch.as_tensor(kc),
                             torch.as_tensor(vc), torch.as_tensor(pos + 1),
                             window=window)
    _close(got, want, 1e-5)


# ------------------------------------------------------------ one layer --
@pytest.fixture(scope="module")
def layer():
    """One smoke qwen3-8b-swa attention layer on both sides."""
    cfg = _swa_smoke("qwen3-8b")
    jp = j_att.gqa_params(jax.random.PRNGKey(2),
                          _swa_smoke("qwen3-8b", jax_side=True))
    p = att.GQA(cfg, device="cpu", generator=torch.Generator())
    p.load_state_dict({f"{name}.{leaf}": torch.from_numpy(np.array(a))
                       for name, sub in jp.items()
                       for leaf, a in sub.items()}, strict=True)
    return cfg, jp, p


def test_ring_matches_linear_window_and_jax_through_a_wrap(layer):
    """12 steps into a ring of 8 slots (it wraps at 8) against a linear
    cache of 12 slots with the window mask, and against JAX's ring."""
    cfg, jp, p = layer
    rng = np.random.default_rng(3)
    steps, b = 12, 2
    x = rng.standard_normal((b, steps, cfg.d_model)).astype(np.float32)
    kv = lambda n: torch.zeros((b, n, cfg.num_kv_heads, cfg.head_dim))
    lin_k, lin_v, ring_k, ring_v = kv(steps), kv(steps), kv(WINDOW), \
        kv(WINDOW)
    jk = jnp.zeros((b, WINDOW, cfg.num_kv_heads, cfg.head_dim))
    jv = jnp.zeros_like(jk)
    jlk = jnp.zeros((b, steps, cfg.num_kv_heads, cfg.head_dim))
    jlv = jnp.zeros_like(jlk)
    for t in range(steps):
        pos = torch.full((b,), t, dtype=torch.int32)
        xt = torch.as_tensor(x[:, t:t + 1])
        y_lin = att.attn_decode(p, cfg, xt, lin_k, lin_v, pos, window=WINDOW)
        y_ring = att.attn_decode(p, cfg, xt, ring_k, ring_v, pos, ring=True)
        jy, jk, jv = j_att.attn_decode(jp, cfg, jnp.asarray(x[:, t:t + 1]),
                                       jk, jv, jnp.asarray(pos.numpy()),
                                       ring=True)
        jly, jlk, jlv = j_att.attn_decode(jp, cfg, jnp.asarray(x[:, t:t + 1]),
                                          jlk, jlv, jnp.asarray(pos.numpy()),
                                          window=WINDOW)
        _close(y_ring, y_lin, 1e-5)
        _close(y_ring, jy, 1e-5)
        _close(y_lin, jly, 1e-5)
    _close(ring_k, jk, 1e-5)
    _close(lin_v, jlv, 1e-5)


def test_windowed_prefill_matches_decode(layer):
    """attn_full(window=) over 12 tokens equals 12 windowed decode steps
    (the reference's test_attn_sliding_window_full_vs_decode)."""
    cfg, jp, p = layer
    x = np.random.default_rng(4).standard_normal(
        (1, 12, cfg.d_model)).astype(np.float32)
    y_full, _ = att.attn_full(p, cfg, torch.as_tensor(x), window=WINDOW)
    jy, _ = j_att.attn_full(jp, cfg, jnp.asarray(x), window=WINDOW)
    _close(y_full, jy, 1e-5)
    ck = torch.zeros((1, 12, cfg.num_kv_heads, cfg.head_dim))
    cv = torch.zeros_like(ck)
    ys = [att.attn_decode(p, cfg, torch.as_tensor(x[:, t:t + 1]), ck, cv,
                          torch.full((1,), t, dtype=torch.int32),
                          window=WINDOW) for t in range(12)]
    _close(torch.cat(ys, 1), y_full, 1e-5)

