"""The port's bfloat16 training on the CPU against the reference's
``make_train_step`` at ``param_dtype=jnp.bfloat16``: one AdamW step of
qwen3-8b, zamba2-1.2b, rwkv6-3b and whisper-large-v3 (the MoE families
are in ``tests/test_torch_bf16_train_moe.py``), AdamW with bf16
moments, ``LM(remat=True)``, and bf16 training checkpoints.

The weights are the port's, drawn at bf16 from a seed and carried to
JAX by ``lm_params_to_jax`` (bit for bit), as in
``tests/test_torch_bf16.py``.  The reference takes the step twice on
them: at bf16 (bf16 moments, as the dry run trains its largest
models), and at float32 on the same values (each weight upcast
exactly; float32 moments).  Its own gap, |bf16 - f32|, is the
yardstick (ROADMAP C.14's rule): for the loss, the grad norm, and the
parameters and both moments after the step (the largest difference
over every leaf), each the largest over four batches from the same
start, the port's |bf16 - reference bf16| is held within ``CEILING``
(2.0) times it.  Each case prints its ratios.  (One batch's loss gap is
one draw of rounding noise and may lie near 0 by chance.  The MoE
families take the first batches whose routing is decided at bf16: the
same experts on the port's bf16 and float32 forwards, every choice
clear of ``tests/test_torch_bf16.py``'s margin on both.)  The recurrent
families' gradients come from the reference's ``"xla"`` chunked scans,
its only differentiable route; their loss from its kernel route
(``mixer_impl="pallas"``, forward only), whose rounding the port's
scans share: both scan in float32 from bf16 operands, where the
``"xla"`` route scans in bf16 (ROADMAP C.17).  whisper takes bf16-exact
frames (the reference's bf16 encoder takes bf16 frames only, C.16).
"""

import functools
import json
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models.model import LM as JLM
from repro.training.checkpoint import save_checkpoint as j_save
from repro.training.losses import lm_loss as j_lm_loss
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro.training.optimizer import AdamWState as JAdamWState
from repro.training.optimizer import adamw_init as j_adamw_init
from repro.training.optimizer import adamw_update as j_adamw_update
from repro.training.train_loop import TrainState as JTrainState
from repro.training.train_loop import make_train_step as j_make_train_step
from repro_torch.configs import smoke_config
from repro_torch.convert import BF16_BITS, lm_params_from_jax, lm_params_to_jax
from repro_torch.models.layers import moe as moe_lib
from repro_torch.models.model import LM
from repro_torch.training.checkpoint import (
    load_checkpoint,
    load_train_state,
    save_train_state,
    state_from_jax,
    state_to_jax,
)
from repro_torch.training.optimizer import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
)
from repro_torch.training.train_loop import (
    TrainState,
    init_train_state,
    leaf_ndims,
    make_train_step,
)
from _torch_threads import cap_threads

cap_threads()

BF16 = torch.bfloat16
CEILING = 2.0
B, S = 2, 16
FAMILIES = ("qwen3-8b", "zamba2-1.2b", "rwkv6-3b", "whisper-large-v3")
RECURRENT = ("zamba2-1.2b", "rwkv6-3b")
ROUTE_MARGIN = 0.01       # tests/test_torch_bf16.py's routing rule
SEEDS = 64
N_BATCHES = 4


def batch_for(cfg, seed):
    """B=2 S=16 tokens and targets from ``seed``; an encoder-decoder's
    frames rounded to bf16 (stored as float32: every run sees the same
    values)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, 1)}
    if cfg.is_encoder_decoder:
        frames = torch.as_tensor(rng.standard_normal(
            (B, cfg.encoder.max_frames, cfg.d_model)), dtype=torch.float32)
        batch["frames"] = frames.to(BF16).float().numpy()
    return batch


def port_model(arch, remat=False):
    return LM(smoke_config(arch), device="cpu", seed=0, param_dtype=BF16,
              remat=remat)


def port_step(arch, batch, remat=False):
    """The port's bf16 step (bf16 moments): (loss, grad norm, {"params",
    "mu", "nu"} by name)."""
    model = port_model(arch, remat)
    state = init_train_state(model, moments_dtype=BF16)
    state, met = make_train_step(model)(state, batch)
    return (float(met["loss"]), float(met["grad_norm"]),
            {"params": {n: p.detach().clone()
                        for n, p in state.params.items()},
             "mu": dict(state.opt.mu), "nu": dict(state.opt.nu)})


def batch_seeds(arch):
    """``N_BATCHES`` batch seeds: 0, 1, ... for a family without MoE
    layers; else the first ones whose every top-k choice is decided at
    bf16: on the port's bf16 and float32 training forwards (the port's
    router only, never the reference's), the same experts, each choice
    clear of the next by ``ROUTE_MARGIN`` in router logits on both."""
    cfg = smoke_config(arch)
    if cfg.moe is None:
        return tuple(range(N_BATCHES))
    half = port_model(arch)
    full = LM(cfg, device="cpu", seed=0)       # the same weights, float32
    seen, seeds = [], []
    route = moe_lib.route

    def recording(p, mo, tokens):
        top = torch.topk(tokens.float() @ p.router.w, mo.top_k + 1, dim=-1)
        seen.append((float((top.values[..., -2] - top.values[..., -1])
                           .min()),
                     top.indices[..., :-1].sort(-1).values))
        return route(p, mo, tokens)

    moe_lib.route = recording
    try:
        for seed in range(SEEDS):
            runs = []
            for model in (half, full):
                seen.clear()
                with torch.no_grad():
                    model.train_logits(torch.as_tensor(
                        batch_for(cfg, seed)["tokens"]))
                runs.append(list(seen))
            if all(m >= ROUTE_MARGIN for run in runs for m, _ in run) and \
                    all(torch.equal(a, b) for (_, a), (_, b) in zip(*runs)):
                seeds.append(seed)
                if len(seeds) == N_BATCHES:
                    return tuple(seeds)
    finally:
        moe_lib.route = route
    pytest.fail(f"{arch}: fewer than {N_BATCHES} batch seeds below "
                f"{SEEDS} route clear of {ROUTE_MARGIN}")


def reference_steps(arch, seeds):
    """The reference's step at bf16 (bf16 moments) and at float32 (float32
    moments) on the port's seed-0 bf16 weights, one jit each, for each
    batch seed: [(bf16, f32)], each (loss, grad norm, {"params", "mu",
    "nu"} as port state dicts)."""
    cfg = smoke_config(arch)
    tree, _ = lm_params_to_jax(dict(port_model(arch).named_parameters()),
                               cfg)
    pb = jax.tree.map(jnp.asarray, tree)
    runs = []
    for dtype, moments in ((jnp.bfloat16, jnp.bfloat16),
                           (jnp.float32, jnp.float32)):
        params = jax.tree.map(lambda a: a.astype(dtype)
                              if a.dtype == jnp.bfloat16 else a, pb)
        step = jax.jit(j_make_train_step(JLM(j_smoke_config(arch),
                                             param_dtype=dtype)))
        start = JTrainState(params, j_adamw_init(params,
                                                 moments_dtype=moments))
        runs.append([step(start, {
            k: jnp.asarray(v, dtype if k == "frames" else None)
            for k, v in batch_for(cfg, seed).items()}) for seed in seeds])
    to_port = lambda t: lm_params_from_jax(jax.tree.map(np.asarray, t), cfg)
    out = [[[float(met["loss"]), float(met["grad_norm"]),
             {"params": to_port(st.params), "mu": to_port(st.opt.mu),
              "nu": to_port(st.opt.nu)}] for st, met in pair]
           for pair in zip(*runs)]
    if arch in RECURRENT:
        # the port's forward scans in float32 from bf16 operands, as the
        # reference's kernel route does (test_torch_bf16.py); its
        # training route scans in bf16: the loss is held against the
        # kernel route's forward (no gradient runs through a Pallas call)
        for j, dtype in enumerate((jnp.bfloat16, jnp.float32)):
            params = jax.tree.map(lambda a: a.astype(dtype)
                                  if a.dtype == jnp.bfloat16 else a, pb)
            jm = JLM(j_smoke_config(arch), param_dtype=dtype,
                     mixer_impl="pallas")
            loss = jax.jit(lambda p, b: j_lm_loss(jm, p, b)[0])
            for pair, seed in zip(out, seeds):
                pair[j][0] = float(loss(params, {
                    k: jnp.asarray(v) for k, v in
                    batch_for(cfg, seed).items()}))
    return [tuple(tuple(run) for run in pair) for pair in out]


def _max_diff(a, b) -> float:
    return max(float((a[n].float() - b[n].float()).abs().max()) for n in b)


def check_step(arch):
    """The port's bf16 step against the reference's on ``N_BATCHES``
    batches from the same start: the largest error of the loss, the grad
    norm, the parameters and each moment over the batches within
    ``CEILING`` x the reference's own largest bf16-vs-f32 gap (a single
    scalar's gap is one draw of rounding noise, often near 0); the
    state's dtypes the reference's.  Returns the ratios."""
    seeds = batch_seeds(arch)
    keys = ("loss", "grad_norm", "params", "mu", "nu")
    err, gap = dict.fromkeys(keys, 0.0), dict.fromkeys(keys, 0.0)
    cfg = smoke_config(arch)
    for seed, ((lb, gb, sb), (lf, gf, sf)) in zip(
            seeds, reference_steps(arch, seeds)):
        loss, gnorm, st = port_step(arch, batch_for(cfg, seed))
        for key in ("params", "mu", "nu"):
            assert {n: t.dtype for n, t in st[key].items()} == \
                {n: t.dtype for n, t in sb[key].items()}, key
        pairs = {"loss": (abs(loss - lb), abs(lb - lf)),
                 "grad_norm": (abs(gnorm - gb), abs(gb - gf))}
        pairs.update({key: (_max_diff(st[key], sb[key]),
                            _max_diff(sf[key], sb[key]))
                      for key in ("params", "mu", "nu")})
        for key, (e, g) in pairs.items():
            err[key], gap[key] = max(err[key], e), max(gap[key], g)
    ratios = {k: err[k] / gap[k] for k in keys}
    print(f"{arch} (batch seeds {seeds}): port bf16 vs reference bf16 "
          f"over the reference's bf16-vs-f32 gap: " + ", ".join(
              f"{k} {v:.2f}x" for k, v in ratios.items()))
    assert all(v <= CEILING for v in ratios.values()), (arch, ratios)
    return ratios


@pytest.mark.parametrize("arch", FAMILIES)
def test_bf16_train_step_matches_the_reference(arch):
    check_step(arch)


# ---------------------------------------------------------------- AdamW --
def _ulp(x: torch.Tensor) -> torch.Tensor:
    """One step of ``x``'s dtype at each entry's magnitude (bf16: 8
    significand bits; float32: 24)."""
    bits = 8 if x.dtype == BF16 else 24
    mag = x.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - (bits - 1))


def test_adamw_with_bf16_moments_matches_the_reference():
    """Smoke qwen3-8b's leaves (bf16 matrices, float32 norms), bf16
    moments, three updates on the same random gradients (each in its
    parameter's dtype): every parameter and moment within one step of
    its dtype (a bf16 ulp for a bf16 leaf) of
    ``repro.training.optimizer.adamw_update``'s."""
    model = port_model("qwen3-8b")
    cfg = model.cfg
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = adamw_init(params, moments_dtype=BF16)
    tree, _ = lm_params_to_jax(params, cfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = j_adamw_init(jparams, moments_dtype=jnp.bfloat16)
    ndims = leaf_ndims(model)
    rng = np.random.default_rng(4)
    for lr in (3e-4, 1e-2, 3e-3):
        grads = {n: torch.as_tensor(rng.standard_normal(p.shape) * 0.05,
                                    dtype=torch.float32).to(p.dtype)
                 for n, p in params.items()}
        gtree = jax.tree.map(jnp.asarray, lm_params_to_jax(grads, cfg)[0])
        params, state = adamw_update(params, grads, state, lr=lr,
                                     cfg=AdamWConfig(), leaf_ndim=ndims)
        jparams, jstate = j_adamw_update(jparams, gtree, jstate, lr=lr,
                                         cfg=JAdamWConfig())
        want = {key: lm_params_from_jax(jax.tree.map(np.asarray, t), cfg)
                for key, t in (("params", jparams), ("mu", jstate.mu),
                               ("nu", jstate.nu))}
        for key, got in (("params", params), ("mu", state.mu),
                         ("nu", state.nu)):
            for n, w in want[key].items():
                assert got[n].dtype == w.dtype, (key, n)
                err = (got[n].float() - w.float()).abs()
                assert bool((err <= _ulp(w)).all()), (lr, key, n,
                                                      float(err.max()))
    assert int(state.step) == int(jstate.step) == 3
    assert any(t.dtype == BF16 for t in params.values())
    assert any(t.dtype == torch.float32 for t in params.values())


# ---------------------------------------------------------------- remat --
@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_equals_the_plain_bf16_step_bitwise(arch):
    """``LM(remat=True)`` (each layer of a group checkpointed; zamba2's
    shared block, whisper's encoder not) takes the same bf16 step as
    ``remat=False``: loss, grad norm, parameters and moments bitwise."""
    batch = batch_for(smoke_config(arch), 3)
    plain = port_step(arch, batch)
    remat = port_step(arch, batch, remat=True)
    assert remat[:2] == plain[:2]
    for key in ("params", "mu", "nu"):
        for n, t in plain[2][key].items():
            assert torch.equal(remat[2][key][n], t), (key, n)


def test_remat_checkpoints_exactly_the_references_groups(monkeypatch):
    """The layers run under ``torch.utils.checkpoint``: every layer of
    the scanned groups (the reference's ``_maybe_remat`` bodies), never
    zamba2's shared block, whisper's encoder or deepseek-v3's MTP block;
    and only under autograd."""
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def spy(fn, p, g, *args, **kw):
        calls.append((p, g.mixer))
        return real(fn, p, g, *args, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", spy)
    for arch in ("zamba2-1.2b", "whisper-large-v3", "deepseek-v3-671b"):
        model = port_model(arch, remat=True)
        cfg = model.cfg
        batch = batch_for(cfg, 0)
        kw = ({"frames": torch.as_tensor(batch["frames"])}
              if "frames" in batch else {})
        calls.clear()
        with torch.no_grad():
            model.train_logits(torch.as_tensor(batch["tokens"]), **kw)
        assert calls == []
        model.train_logits(torch.as_tensor(batch["tokens"]), **kw)
        want = [id(p) for gi, g in enumerate(cfg.layer_plan)
                if g.mixer != "shared_attn" for p in model.groups[gi]]
        assert [id(p) for p, _ in calls] == want, arch
        assert all(m != "shared_attn" for _, m in calls)


# ----------------------------------------------------------- checkpoints --
def _members(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def test_bf16_train_state_checkpoint_is_the_reference_writers(
        tmp_path, monkeypatch):
    """A bf16 ``TrainState`` after one step (bf16 matrices and moments,
    float32 norms), written by ``save_train_state`` with ``ml_dtypes``
    blocked: each ``.npy`` member and the manifest equal, byte for byte,
    those of ``repro.training.checkpoint.save_checkpoint`` on the same
    tree (bf16 leaves as ``ml_dtypes.bfloat16``: descr ``'<V2'``,
    manifest dtype ``bfloat16``); ``load_train_state``, and
    ``load_checkpoint`` (bf16 leaves as their bit patterns) through
    ``state_from_jax``, also with ``ml_dtypes`` blocked, restore every
    tensor and the step bitwise."""
    arch = "qwen3-8b"
    model = port_model(arch)
    state = init_train_state(model, moments_dtype=BF16)
    state, _ = make_train_step(model)(state, batch_for(model.cfg, 0))
    to_jax = lambda sd: lm_params_to_jax(sd, model.cfg)[0]
    j_path = str(tmp_path / "reference.npz")
    j_save(j_path, JTrainState(to_jax(state.params), JAdamWState(
        step=np.asarray(state.opt.step), mu=to_jax(state.opt.mu),
        nu=to_jax(state.opt.nu))), step=1)
    fresh = LM(model.cfg, device="cpu", seed=7, param_dtype=BF16)
    like = init_train_state(fresh, moments_dtype=BF16)

    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    with pytest.raises(ImportError):
        import ml_dtypes  # noqa: F401
    path = str(tmp_path / "port.npz")
    save_train_state(path, model, state, step=1)
    tree = load_checkpoint(path, TrainState(*state_to_jax(
        fresh, like.params, like.opt)))
    assert tree.params["embed"]["w"].dtype == BF16_BITS
    params, opt = state_from_jax(fresh, tree.params, tree.opt)
    loaded = load_train_state(path, fresh, like)
    monkeypatch.undo()

    got, want = _members(path), _members(j_path)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name] == want[name], name
    with np.load(path) as z:
        leaves = json.loads(str(z["__manifest__"]))["leaves"]
    dtypes = {v["dtype"] for v in leaves.values()}
    assert {"bfloat16", "float32", "int32"} <= dtypes
    for key, ts in (("params", state.params), ("mu", state.opt.mu),
                    ("nu", state.opt.nu)):
        for new in ({"params": loaded.params, "mu": loaded.opt.mu,
                     "nu": loaded.opt.nu}[key],
                    {"params": params, "mu": opt.mu, "nu": opt.nu}[key]):
            for n, t in ts.items():
                assert new[n].dtype == t.dtype and torch.equal(new[n], t), (
                    key, n)
    assert int(loaded.opt.step) == int(opt.step) == 1
