"""The port's big-LM serving path on the CPU against the JAX package.

The smoke rwkv6-3b and zamba2-1.2b LMs (and, for the configuration,
generation and engine cases, the seven other ported names; qwen3-8b's
own file is ``tests/test_torch_qwen3.py``, the MoE / MLA families' and
the dense giants' ``tests/test_torch_moe_lm.py``) are built by JAX
(``LM(cfg, mixer_impl="pallas")``, the kernel route, its Pallas kernels
in interpret mode), carried across by ``lm_params_from_jax`` and held
against the port: prefill logits and decode state, four decode-step
logits, prime prompt lengths (a chunk of 1), generation through
``GenerationSession``, the executors and the registry, and one smoke
run of the engine with the LM as its real edge tier.

Tolerance: 1e-4 in float32 for logits and states.  The two sides reduce
in different orders (and the reference's own ``pallas`` and ``xla``
routes differ by up to 2.6e-6 in prefill logits), so nothing is held
bitwise.  Generated tokens are compared only where the port's own logits
show a clear argmax margin.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch  # noqa: F401
from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.models.config import LayerGroup as JLayerGroup
from repro.models.model import LM as JLM
from repro.runtime.serving import GenerationSession as JSession
from repro_torch.configs import ARCH_NAMES, get_config, smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch.serve import serve_tiered
from repro_torch.models.config import LayerGroup
from repro_torch.models.model import LM
from repro_torch.models.registry import available, resolve
from repro_torch.runtime.serving import (
    GenerationSession,
    TierFaultError,
    build_executor,
)
from _torch_threads import cap_threads

cap_threads()

TOL = 1e-4
ARCHS = ("rwkv6-3b", "zamba2-1.2b", "qwen3-8b", "qwen3-32b", "deepseek-67b",
         "chameleon-34b", "qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b",
         "deepseek-v3-671b")
_MODELS = {}


def _pair(arch, plan=None, vocab=None):
    """(JAX model, JAX params, port model) for the smoke ``arch`` (with
    its layer plan and vocabulary replaced if given), its weights drawn
    once by JAX and carried across."""
    key = (arch, plan, vocab)
    if key not in _MODELS:
        jcfg, cfg = j_smoke_config(arch), smoke_config(arch)
        if plan is not None:
            jcfg = dataclasses.replace(jcfg, layer_plan=plan,
                                       vocab_size=vocab)
            cfg = dataclasses.replace(cfg, vocab_size=vocab, layer_plan=tuple(
                LayerGroup(**dataclasses.asdict(g)) for g in plan))
        jm = JLM(jcfg, mixer_impl="pallas")
        params = jm.init(jax.random.PRNGKey(0))
        model = LM(cfg, device="cpu")
        model.load_state_dict(
            lm_params_from_jax(jax.tree.map(np.asarray, params), cfg),
            strict=True)
        _MODELS[key] = (jm, params, model)
    return _MODELS[key]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _cache_leaves(jcache):
    return jcache._asdict() if hasattr(jcache, "_asdict") else jcache


# ---------------------------------------------------------------- configs --
@pytest.mark.parametrize("arch", ARCHS + ("whisper-large-v3",))
def test_configs_match_the_reference(arch):
    for mine, ref in ((get_config(arch), j_get_config(arch)),
                      (smoke_config(arch), j_smoke_config(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.padded_vocab == ref.padded_vocab


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_every_assigned_architecture_resolves(arch):
    """All ten names build (on the meta device: shapes only), at the
    assigned width and at smoke size."""
    for size in ("smoke", "full"):
        r = resolve(arch, size=size, device="meta")
        assert (r.name, r.family) == (arch, "lm")
        assert sum(p.numel() for p in r.model.parameters()) > 0


# ------------------------------------------------------------- the model --
@pytest.mark.parametrize("arch,s", [
    ("rwkv6-3b", 16),        # wkv chunk 16
    ("rwkv6-3b", 37),        # prime length: wkv chunk 1
    ("zamba2-1.2b", 16),     # ssd chunk 8, two chunks
    ("zamba2-1.2b", 11),     # prime length: ssd chunk 1
])
def test_lm_prefill_and_decode_match_jax(arch, s):
    jm, params, model = _pair(arch)
    toks = np.random.default_rng(s).integers(
        3, model.cfg.vocab_size, (2, s)).astype(np.int32)
    max_len = s + 6
    jl, jst = jax.jit(lambda p, t: jm.prefill(p, t, max_len=max_len))(
        params, jnp.asarray(toks))
    tl, tst = model.prefill(torch.as_tensor(toks), max_len=max_len)
    assert tl.shape == (2, model.cfg.padded_vocab)
    _close(tl, jl)
    for jc, tc in zip(jax.tree.map(np.asarray, jst["caches"]),
                      tst["caches"]):
        jd = _cache_leaves(jc)
        assert set(jd) == set(tc)
        for name in tc:
            assert tc[name].shape == jd[name].shape, name
            _close(tc[name], jd[name])
    np.testing.assert_array_equal(tst["pos"].numpy(), np.asarray(jst["pos"]))
    step = jax.jit(jm.decode_step)
    for tok in (5, 17, 42, 99):           # fixed tokens: no argmax chain
        t = np.full((2, 1), tok, np.int32)
        jl, jst = step(params, jst, jnp.asarray(t))
        tl, tst = model.decode_step(tst, torch.as_tensor(t))
        _close(tl, jl)
    np.testing.assert_array_equal(tst["pos"].numpy(), np.asarray(jst["pos"]))


def test_attention_plan_ragged_prefill_matches_jax():
    """An attn/dense plan (position-masked) takes right-padded prompts
    with true lengths, as the reference's ragged prefill does; a vocab of
    500 pads the logits to 512 columns, the last 12 masked."""
    plan = (JLayerGroup(mixer="attn", ffn="dense", count=2),)
    jm, params, model = _pair("zamba2-1.2b", plan, vocab=500)
    assert model.cfg.padded_vocab == 512
    toks = np.random.default_rng(9).integers(3, 500, (3, 12)).astype(np.int32)
    lens = np.array([12, 5, 9], np.int32)
    jl, jst = jm.prefill(params, jnp.asarray(toks), max_len=20,
                         lengths=jnp.asarray(lens))
    tl, tst = model.prefill(torch.as_tensor(toks), max_len=20,
                            lengths=torch.as_tensor(lens))
    _close(tl, jl)
    assert bool((tl[:, 500:] == -1e30).all())
    t = np.full((3, 1), 7, np.int32)
    jl, _ = jm.decode_step(params, jst, jnp.asarray(t))
    tl, _ = model.decode_step(tst, torch.as_tensor(t))
    _close(tl, jl)


def test_recurrent_plans_refuse_ragged_and_too_short_prompts():
    _, _, rwkv = _pair("rwkv6-3b")
    _, _, zamba = _pair("zamba2-1.2b")
    toks = torch.arange(3, 11, dtype=torch.int32).view(2, 4)
    with pytest.raises(ValueError, match="ragged"):
        rwkv.prefill(toks, lengths=torch.tensor([4, 2]))
    with pytest.raises(ValueError, match="conv_width"):
        zamba.prefill(toks[:, :2])        # the conv buffer needs 3 tokens


def test_init_decode_state_matches_the_reference_layout():
    jm, _, model = _pair("zamba2-1.2b")
    want = jax.tree.map(np.asarray, jm.init_decode_state(None, 2, 10))
    got = model.init_decode_state(2, 10)
    for jc, tc in zip(want["caches"], got["caches"]):
        jd = _cache_leaves(jc)
        assert {k: v.shape for k, v in jd.items()} == \
            {k: tuple(v.shape) for k, v in tc.items()}
        assert all(not v.any() for v in tc.values())


# ----------------------------------------------------------- generation --
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_with_lengths_matches_jax(arch):
    jm, params, model = _pair(arch)
    toks = np.random.default_rng(3).integers(
        3, model.cfg.vocab_size, (3, 9)).astype(np.int32)
    max_new = 6
    j_lens, j_out = (np.array(a) for a in JSession(
        jm, params, max_len=32).generate_with_lengths(toks, max_new=max_new))
    t_lens, t_out = GenerationSession(model, max_len=32).generate_with_lengths(
        toks, max_new=max_new)
    h_lens, h_out = GenerationSession(
        model, max_len=32, host_loop=True).generate_with_lengths(
            toks, max_new=max_new)
    np.testing.assert_array_equal(t_lens, j_lens)
    np.testing.assert_array_equal(h_lens, t_lens)
    np.testing.assert_array_equal(h_out, t_out)
    # replay JAX's tokens through the port: wherever the port's top-2
    # margin is clear, its argmax must be JAX's token
    with torch.inference_mode():
        logits, state = model.prefill(torch.as_tensor(toks), max_len=32)
        compared = 0
        for i in range(max_new):
            top2 = torch.topk(logits, 2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1] > 1e-3).numpy()
            argmax = torch.argmax(logits, dim=-1).numpy()
            ok = clear & (j_out[:, i] != 0)
            np.testing.assert_array_equal(argmax[ok], j_out[ok, i])
            compared += int(ok.sum())
            logits, state = model.decode_step(
                state, torch.as_tensor(j_out[:, i:i + 1]))
    assert compared >= 3 * max_new - 2
    np.testing.assert_array_equal(t_out[t_out != 0], j_out[t_out != 0])


def test_session_pads_recurrent_batches_only_and_checks_capacity():
    _, _, model = _pair("rwkv6-3b")
    sess = GenerationSession(model, max_len=16)
    toks = np.arange(3, 18, dtype=np.int32).reshape(3, 5)
    padded, lens = sess._bucket_pad(toks, None, 4)
    assert padded.shape == (4, 5) and lens is None
    with pytest.raises(ValueError, match="capacity"):
        sess.generate_with_lengths(toks, max_new=12)
    with pytest.raises(ValueError, match="ragged"):
        sess.generate_with_lengths(toks, max_new=4, lengths=[5, 3, 5])


# ------------------------------------------------------------ executors --
def test_executors_solo_batched_raw_and_faults():
    _, _, model = _pair("zamba2-1.2b")
    sess = GenerationSession(model, max_len=32)
    solo = build_executor(sess, kind="solo", max_new=4, vocab_clip=512)
    batched = build_executor(sess, kind="batched", max_new=4, vocab_clip=512)
    rng = np.random.default_rng(4)
    reqs = [rng.integers(3, 600, n).astype(np.int32) for n in (5, 7, 5)]
    block = np.zeros((3, 7), np.int32)
    for i, r in enumerate(reqs):
        block[i, :len(r)] = r
    got = batched(block)
    assert len(got) == 3
    for r, (m, out) in zip(reqs, got):
        m_solo, out_solo = solo(r)
        assert (m, out.tolist()) == (m_solo, out_solo.tolist())
        assert 0 <= m <= 4 and len(out) == max(m, 1)
    faulty = build_executor(solo, kind="raw", faults=[1])
    faulty(reqs[0])
    with pytest.raises(TierFaultError):
        faulty(reqs[0])
    assert faulty.calls == {"n": 2, "faults": 1}
    assert build_executor(solo, kind="raw") is solo
    with pytest.raises(ValueError, match="make_encode_states"):
        build_executor(sess, kind="split")
    with pytest.raises(ValueError):
        build_executor(42, kind="raw")
    with pytest.raises(ValueError):
        build_executor(sess, kind="bogus")


def test_registry_resolves_the_recurrent_lms():
    for name, canon in (("rwkv6_3b", "rwkv6-3b"),
                        ("zamba2-1.2b", "zamba2-1.2b")):
        r = resolve(name, device="cpu", seed=1)
        assert (r.name, r.family, r.pair) == (canon, "lm", None)
        assert r.cfg == smoke_config(canon)
        assert isinstance(r.model, LM) and r.model.device.type == "cpu"
    assert {"rwkv6-3b", "zamba2-1.2b"} <= set(available())
    with pytest.raises(ValueError):
        resolve("rwkv6-3b", size="medium", device="cpu")
    a = resolve("zamba2-1.2b", device="cpu", seed=1).model
    b = resolve("zamba2-1.2b", device="cpu", seed=1).model
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                b.parameters()))


# --------------------------------------------------------------- engine --
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_serves_the_lm_as_its_edge_tier(arch):
    _, _, model = _pair(arch)
    engine = serve_tiered(GenerationSession(model, max_len=64),
                          model.cfg.vocab_size, requests=8, max_new=4)
    results = engine.results
    assert len(results) == 8 and not any(r.shed for r in results)
    assert any(r.tier_name == "edge" for r in results)
    for r in results:
        assert np.isfinite(r.latency_s) and r.latency_s > 0
        if r.tier_name == "edge":
            assert 0 <= r.m_out <= 4
