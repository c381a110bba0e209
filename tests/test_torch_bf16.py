"""The port's ``LM(param_dtype=torch.bfloat16)`` on the CPU against the
reference's ``LM(param_dtype=jnp.bfloat16)``: the dtype rule, the
converter, the seeded init, and the logits, states and generation of
seven families: qwen3-8b, zamba2-1.2b, rwkv6-3b, qwen3-moe-30b-a3b
(drop-free smoke), moonshot-v1-16b-a3b, deepseek-v3-671b (MLA, MTP)
and whisper-large-v3 (bf16 frames).

The weights are the port's, drawn at bf16 from a seed and carried to
JAX by ``lm_params_to_jax`` (bit for bit; JAX's eager init is slow).
The reference runs twice on them: at bf16, and at float32 on the same
values (each bf16 weight upcast, exactly).  The reference's own gap,
max |bf16 - f32| over the prefill logits and four decode steps' logits,
is the yardstick: the port's max |port bf16 - reference bf16| over the
same logits is held to ``CEILING`` (2.0) times it.  ``TARGET`` (1.0x)
is where the casts line up as well as the two frameworks allow; the
families above it are named in ROADMAP C with where they round
otherwise (attention: the port's kernels compute in float32 and round
their output once, the reference's jnp attention rounds its scores and
weights to bf16; XLA on the CPU rounds every elementwise step of a
bf16 silu).  Each case prints its ratio.

The recurrent families run the reference's kernel route
(``mixer_impl="pallas"``, interpret mode), as the port's prefill does:
its operands cast to float32 before the scan and back after it.
Generated tokens are compared up to the first one whose top-2 logit
margin (the port's, ``greedy_margins``) is below ``MARGIN``: 0.125, eight
bf16 ulps at the logits' magnitude (1e-4 is below one ulp).

A MoE layer's top-k is a discrete choice.  Where two experts' router
logits lie closer than bf16 rounding moves them, the choice is not
decided at bf16: any two bf16 runs may part there, the reference's own
included (qwen3-moe-30b-a3b at prompt seed 0 routes a token one way at
bf16 and the other at float32, a 0.26 logit gap, and deepseek-v3-671b
at seed 1 likewise, 0.47).  So the MoE cases run the first prompt seed
(from 0) whose every top-k choice on the port's path clears
``ROUTE_MARGIN`` (0.01 in router logits; the choices that parted sat at
0.0003-0.0014): that rule reads the port's router only, never the
reference's outputs, and the test fails if none of ``SEEDS`` clears it.
Generation makes more choices than any seed clears (a batch of prompts,
a margin run per row), so the MoE families' tokens are not compared
here: their logits are, and their float32 generation in
``tests/test_torch_moe_lm.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import smoke_config as j_smoke_config
from repro.models.model import LM as JLM
from repro.runtime.serving import GenerationSession as JSession
from repro_torch.configs import ARCH_NAMES, smoke_config
from repro_torch.convert import (
    lm_params_from_jax,
    lm_params_to_jax,
    reference_leaves,
)
from repro_torch.core.latency_model import DeviceProfile, LinearLatencyModel
from repro_torch.core.length_regressor import LinearN2M
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import serve_tiered
from repro_torch.models.layers import moe as moe_lib
from repro_torch.models.model import LM
from repro_torch.models.registry import resolve
from repro_torch.runtime.engine import CollaborativeEngine, Tier
from repro_torch.runtime.serving import (
    ContinuousGenerationSession,
    GenerationSession,
    greedy_margins,
)
from repro_torch.runtime.sharded import ShardedLM
from repro_torch.sharding.policy import make_policy
from repro_torch.training.train_loop import make_train_step
from _torch_threads import cap_threads

cap_threads()

BF16 = torch.bfloat16
TARGET, CEILING = 1.0, 2.0
MARGIN = 0.125
B, S, STEPS = 2, 16, 4
RECURRENT = ("zamba2-1.2b", "rwkv6-3b")
MOE = ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "deepseek-v3-671b")
ROUTE_MARGIN = 0.01
SEEDS = 32


@functools.lru_cache(maxsize=None)
def bf16_case(arch):
    """(port bf16 model, reference bf16 (model, params), reference f32
    (model, params)) on the port's seed-0 weights."""
    cfg = smoke_config(arch)
    model = LM(cfg, device="cpu", seed=0, param_dtype=BF16)
    tree, _ = lm_params_to_jax(dict(model.named_parameters()), cfg)
    impl = "pallas" if arch in RECURRENT else "xla"
    jb = JLM(j_smoke_config(arch), param_dtype=jnp.bfloat16,
             mixer_impl=impl)
    jf = JLM(j_smoke_config(arch), param_dtype=jnp.float32, mixer_impl=impl)
    pb = jax.tree.map(jnp.asarray, tree)
    pf = jax.tree.map(lambda a: a.astype(jnp.float32), pb)
    return model, (jb, pb), (jf, pf)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.array(jnp.asarray(a, jnp.float32))


def _dtypes(tree, path=()):
    """{path: dtype name} of a decode state (a named tuple by its field
    names, as the reference's rwkv6 state)."""
    if hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _dtypes(tree[k],
                                                       path + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, t in enumerate(tree)
                for p, v in _dtypes(t, path + (i,)).items()}
    return {path: str(tree.dtype).replace("torch.", "")}


def frames_for(cfg, rng, b=B):
    """Random bf16 frames (b, T, D) for an encoder-decoder, else None."""
    if not cfg.is_encoder_decoder:
        return None
    return jnp.asarray(rng.standard_normal(
        (b, cfg.encoder.max_frames, cfg.d_model)), jnp.bfloat16)


def _prompts(cfg, seed, rows, width):
    """``rows`` prompts of ``width`` tokens and (an encoder-decoder's)
    bf16 frames, from ``seed``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (rows, width)).astype(np.int32)
    return toks, frames_for(cfg, rng, rows)


def port_path(model, toks, fr):
    """The port's prefill and four greedy decode steps (its own argmax
    fed back): [(logits, tokens fed next)], the final state."""
    tkw = {} if fr is None else {"frames": torch.as_tensor(
        _f32(fr)).to(BF16)}
    lt, st = model.prefill(torch.as_tensor(toks), max_len=S + STEPS + 1,
                           **tkw)
    out = []
    for _ in range(STEPS + 1):
        nxt = torch.argmax(lt, -1).to(torch.int32)[:, None]
        out.append((lt, nxt.numpy()))
        if len(out) <= STEPS:
            lt, st = model.decode_step(st, nxt)
    return out, st


def run_paths(arch, seed=0):
    """The port's prefill and four greedy decode steps at bf16 and the
    reference's at bf16 and f32 on the same prompts, each fed the
    port's tokens.  Returns ([(port, ref bf16, ref f32) logits per
    call], port state, reference bf16 state)."""
    model, (jb, pb), (jf, pf) = bf16_case(arch)
    toks, fr = _prompts(model.cfg, seed, B, S)
    path, st = port_path(model, toks, fr)
    jkw = {} if fr is None else {"frames": fr}
    fkw = {} if fr is None else {"frames": fr.astype(jnp.float32)}
    prefill = jax.jit(lambda m, p, t, kw: m.prefill(
        p, t, max_len=S + STEPS + 1, **kw), static_argnums=0)
    step = jax.jit(lambda m, p, st, t: m.decode_step(p, st, t),
                   static_argnums=0)
    lb, sb = prefill(jb, pb, jnp.asarray(toks), jkw)
    lf, sf = prefill(jf, pf, jnp.asarray(toks), fkw)
    calls = []
    for i, (lt, nxt) in enumerate(path):
        calls.append((lt, lb, lf))
        if i < STEPS:
            lb, sb = step(jb, pb, sb, jnp.asarray(nxt))
            lf, sf = step(jf, pf, sf, jnp.asarray(nxt))
    return calls, st, sb


def check_against_reference(arch, seed=0):
    """The logits' and state leaves' dtypes are the reference's, and the
    port's max |bf16 - reference bf16| is within ``CEILING`` times the
    reference's max |bf16 - f32|.  Returns the ratio."""
    calls, st, sb = run_paths(arch, seed)
    for lt, lb, _ in calls:
        assert str(lt.dtype).replace("torch.", "") == str(lb.dtype)
    state = {k: v for k, v in st.items() if k != "specs"}
    assert _dtypes(state) == {k: str(v) for k, v in _dtypes(sb).items()}
    err = max(float(np.abs(_f32(lt) - _f32(lb)).max())
              for lt, lb, _ in calls)
    gap = max(float(np.abs(_f32(lb) - _f32(lf)).max())
              for _, lb, lf in calls)
    ratio = err / gap
    print(f"{arch}: port bf16 - reference bf16 {err:.5f}, reference "
          f"bf16 - f32 {gap:.5f}: {ratio:.2f}x (target {TARGET}x, "
          f"ceiling {CEILING}x)")
    assert gap > 0
    assert ratio <= CEILING, (arch, err, gap)
    return ratio


def check_generation(arch, seed=1, rows=8, max_new=8):
    """``GenerationSession`` at bf16 against the reference's session on
    the same weights, ``rows`` prompts of 8 tokens: each row's tokens
    equal up to the first one behind a top-2 margin below ``MARGIN``,
    and at least ``rows`` tokens in all are compared (random weights'
    margins are often small)."""
    model, (jb, pb), _ = bf16_case(arch)
    toks, fr = _prompts(model.cfg, seed, rows, 8)
    t_fr = None if fr is None else torch.as_tensor(_f32(fr)).to(BF16)
    _, t_out = GenerationSession(model, max_len=32).generate_with_lengths(
        toks, max_new=max_new, frames=t_fr)
    clear = []
    for i in range(rows):
        low = greedy_margins(model, toks[i], t_out[i], frames=None
                             if t_fr is None else t_fr[i]) < MARGIN
        clear.append(int(np.argmax(low)) if low.any() else max_new)
    j_out = np.asarray(JSession(jb, pb, max_len=32).generate_with_lengths(
        toks, max_new=max_new, frames=fr)[1])
    for i, n in enumerate(clear):
        np.testing.assert_array_equal(t_out[i, :n], j_out[i, :n])
    assert sum(clear) >= rows, (arch, clear)


def _clear_seed(arch, port_run, monkeypatch):
    """The first seed below ``SEEDS`` whose routing on the port's own
    run (``port_run(seed)``, no reference) has every top-k margin at
    least ``ROUTE_MARGIN``."""
    margins = []
    route = moe_lib.route

    def recording(p, mo, tokens):
        top = torch.topk(tokens.float() @ p.router.w, mo.top_k + 1,
                         dim=-1).values
        margins.append(float((top[..., -2] - top[..., -1]).min()))
        return route(p, mo, tokens)

    monkeypatch.setattr(moe_lib, "route", recording)
    for seed in range(SEEDS):
        margins.clear()
        port_run(seed)
        if min(margins) >= ROUTE_MARGIN:
            monkeypatch.undo()
            return seed
    pytest.fail(f"{arch}: no prompt seed below {SEEDS} routes clear of "
                f"{ROUTE_MARGIN}")


# ------------------------------------------------------------ the rule --
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_parameter_dtypes_equal_the_references(arch):
    """Every parameter of ``LM(param_dtype=bf16)`` has the dtype of its
    leaf in the reference's ``params_spec(jnp.bfloat16)`` (matrices bf16;
    norms, biases, decays, the router and rwkv6's ``mix`` float32)."""
    cfg = smoke_config(arch)
    model = LM(cfg, device="meta", param_dtype=BF16)
    spec = JLM(j_smoke_config(arch)).params_spec(jnp.bfloat16)
    want = {jax.tree_util.keystr(p): str(leaf.dtype) for p, leaf in
            jax.tree_util.tree_flatten_with_path(spec)[0]}
    leaves = reference_leaves(model)
    got = {}
    for name, p in model.named_parameters():
        got[leaves[name].keystr] = str(p.dtype).replace("torch.", "")
    assert got == want


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_converter_round_trip_is_bitwise_at_bf16(arch):
    """A reference bf16 pytree -> the port -> the reference again: every
    leaf's dtype and bits unchanged (bf16 through its 16-bit pattern)."""
    cfg = smoke_config(arch)
    model = LM(cfg, device="cpu", seed=2, param_dtype=BF16)
    tree, _ = lm_params_to_jax(dict(model.named_parameters()), cfg)
    sd = lm_params_from_jax(tree, cfg)
    for name, p in model.named_parameters():
        assert sd[name].dtype == p.dtype, name
        assert torch.equal(sd[name].view(torch.int16) if p.dtype == BF16
                           else sd[name], p.view(torch.int16)
                           if p.dtype == BF16 else p), name
    back, _ = lm_params_to_jax(sd, cfg)
    flat = jax.tree_util.tree_flatten_with_path
    for (pa, a), (pb, b) in zip(flat(tree)[0], flat(back)[0]):
        assert pa == pb and a.dtype == b.dtype
        assert a.tobytes() == b.tobytes(), jax.tree_util.keystr(pa)
    reloaded = LM(cfg, device="cpu", seed=9, param_dtype=BF16)
    reloaded.load_state_dict(sd, strict=True)
    assert all(torch.equal(a, b) for a, b in zip(reloaded.parameters(),
                                                 model.parameters()))


@pytest.mark.parametrize("arch", ("qwen3-8b", "zamba2-1.2b", "rwkv6-3b",
                                  "qwen3-moe-30b-a3b", "deepseek-v3-671b",
                                  "whisper-large-v3"))
def test_seeded_bf16_model_is_the_float32_model_cast(arch):
    """``LM(seed=s, param_dtype=bf16)`` equals ``LM(seed=s)`` with each
    tensor cast by the rule, bit for bit (weights drawn in float32 from
    one generator, each cast as it is drawn)."""
    cfg = smoke_config(arch)
    half = dict(LM(cfg, device="cpu", seed=5,
                   param_dtype=BF16).named_parameters())
    full = dict(LM(cfg, device="cpu", seed=5).named_parameters())
    assert half.keys() == full.keys()
    assert any(p.dtype == BF16 for p in half.values())
    for name, p in half.items():
        assert torch.equal(p, full[name].to(p.dtype)), name


# ------------------------------------------------- against the reference --
@pytest.mark.parametrize("arch", ("qwen3-8b", "zamba2-1.2b", "rwkv6-3b")
                         + MOE + ("whisper-large-v3",))
def test_bf16_logits_and_state_match_the_reference(arch, monkeypatch):
    """Prefill and four decode steps at B=2 S=16 (whisper on bf16 frames,
    the only ones the reference's bf16 encoder takes; the MoE families on
    the first clearly routed prompt seed): the logits and every state
    leaf (caches, recurrent states, MLA's latent, the cross caches) in
    the reference's dtypes (bf16, ``pos`` int32, ``enc_mask`` float32),
    the logits within ``CEILING`` x the reference's own bf16-vs-f32
    gap."""
    seed = 0
    with torch.no_grad():
        if arch in MOE:
            model = bf16_case(arch)[0]
            seed = _clear_seed(arch, lambda s: port_path(
                model, *_prompts(model.cfg, s, B, S)), monkeypatch)
        check_against_reference(arch, seed)


@pytest.mark.parametrize("arch", ("qwen3-8b", "zamba2-1.2b", "rwkv6-3b",
                                  "whisper-large-v3"))
def test_bf16_generation_matches_the_reference(arch):
    check_generation(arch)


def test_bf16_lm_serves_through_the_engine():
    """A bf16 LM behind the usual entry points, unchanged: ``resolve(...,
    param_dtype=)``, ``build_executor`` (``launch/serve.py``'s tiered
    engine, the LM as its real edge tier) and a
    ``ContinuousGenerationSession`` through ``serve_continuous`` (its
    resident state in bf16)."""
    model = resolve("qwen3-8b", device="cpu", param_dtype=BF16).model
    vocab = model.cfg.vocab_size
    engine = serve_tiered(GenerationSession(model, max_len=64), vocab,
                          requests=8, max_new=4)
    edge = [r for r in engine.results if r.tier_name == "edge"]
    assert len(engine.results) == 8 and edge
    assert all(0 <= r.m_out <= 4 for r in edge)
    sess = ContinuousGenerationSession(model, max_slots=4, max_len=32)
    assert all(t.dtype == BF16 for c in sess._state["caches"]
               for t in c.values())
    rng = np.random.default_rng(2)
    prompts = [rng.integers(4, vocab, int(n)).astype(np.int32)
               for n in (3, 9, 17, 5, 12, 7)]
    results = CollaborativeEngine(
        n2m=LinearN2M(1.0, 0.0), tiers=[Tier(
            DeviceProfile("card", LinearLatencyModel(0.0, 0.0, 0.01), 0.0),
            name="card", batch_size=4, continuous_session=sess)],
        seed=0).serve_continuous(prompts, arrival_s=np.arange(6) * 0.01,
                                 max_new=4)
    assert len(results) == 6 and not any(r.shed for r in results)
    assert all(0 <= r.m_out <= 4 for r in results)


@pytest.mark.parametrize("dtype", [torch.float32, BF16, torch.float16])
def test_sharding_and_training_take_float32_and_bf16_only(dtype, tmp_path):
    """``make_train_step`` and ``ShardedLM`` (on a one-rank gloo mesh)
    take a float32 or bf16 LM; an LM whose ``param_dtype`` is neither
    (set past the constructor, which refuses it itself) gets a clear
    ``ValueError`` from both, before any process group is needed."""
    model = LM(smoke_config("qwen3-8b"), device="cpu",
               param_dtype=BF16 if dtype == BF16 else torch.float32)
    if dtype == torch.float16:
        model.param_dtype = dtype
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            ShardedLM(model, None, None)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            make_train_step(model)
        return
    assert callable(make_train_step(model))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh((1, 1), ("data", "model"), "cpu")
        lm = ShardedLM(model, mesh, make_policy(mesh, batch_size=2,
                                                layout="tp"))
        assert lm.param_dtype == dtype
        assert {p.dtype for _, p in lm.named_parameters()} >= {dtype}
    finally:
        dist.destroy_process_group()


def test_init_decode_state_defaults_to_the_param_dtype():
    """``init_decode_state`` without a dtype is in the model's
    ``param_dtype`` (``pos`` int32), as the reference's; a float32 model's
    stays float32."""
    cfg = smoke_config("zamba2-1.2b")
    half = LM(cfg, device="cpu", param_dtype=BF16).init_decode_state(2, 8)
    full = LM(cfg, device="cpu").init_decode_state(2, 8)
    for cache_h, cache_f in zip(half["caches"], full["caches"]):
        assert all(t.dtype == BF16 for t in cache_h.values())
        assert all(t.dtype == torch.float32 for t in cache_f.values())
    assert half["pos"].dtype == torch.int32
    with pytest.raises(ValueError, match="param_dtype"):
        LM(cfg, device="meta", param_dtype=torch.float16)
