"""The port's sharded training on 4 gloo ranks of the CPU, against the
unsharded port and the unsharded JAX package.

One spawn (``tests/_torch_sharded_train_worker.py``) runs every case on
a (2, 2) ``("data", "model")`` mesh of 4 processes.  Each case shards a
smoke LM carrying the port's seeded weights and takes three AdamW steps
through ``make_train_step`` on one batch of B=4 S=16: qwen3-8b under
``tp``, ``ddp`` and ``auto``, qwen3-moe-30b-a3b (drop-free, as
``smoke_config`` sets it) under ``tp``, zamba2-1.2b (mamba2) under
``ddp``.  Held against the same steps of the unsharded port:

* the loss and the grad norm of every step within 1e-5 relative, the
  same on every rank, the loss falling;
* every parameter and both AdamW moments, gathered whole, within 1e-4
  of that leaf's largest absolute value;
* each rank's blocks (parameters and moments) shaped by
  ``train_state_specs``.

The reference's own sharded train test fails under jax 0.9.0 (ROADMAP
C.4), so it is not the yardstick; the unsharded JAX ``make_train_step``
on the converted weights holds the unsharded port's first step to
``tests/test_torch_training.py``'s tolerances (loss 1e-5, grad norm 1e-3
relative).  Also: the MoE
load-balance loss of a sharded forward within 1e-6 of the unsharded
port's (the product of two whole-batch means, not the mean of the
shards' products); a sharded checkpoint, read by the reference's
``load_checkpoint``, against the unsharded one's; and that checkpoint
loaded into a fresh sharded state.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models.model import LM as JLM
from repro.training.checkpoint import load_checkpoint as j_load
from repro.training.optimizer import adamw_init as j_adamw_init
from repro.training.train_loop import TrainState as JTrainState
from repro.training.train_loop import make_train_step as j_make_train_step
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_to_jax
from repro_torch.models.model import LM
from repro_torch.sharding.policy import (
    MeshShape,
    make_policy,
    spec_axes,
    train_state_specs,
)
from repro_torch.training.checkpoint import save_train_state
from repro_torch.training.losses import lm_loss
from repro_torch.training.train_loop import init_train_state, make_train_step
from _torch_spawn import join, spawn
from _torch_threads import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_sharded_train_worker.py")
TRAIN_CASES = (("qwen3-8b", "tp"), ("qwen3-8b", "ddp"), ("qwen3-8b", "auto"),
               ("qwen3-moe-30b-a3b", "tp"), ("zamba2-1.2b", "ddp"))
ARCHS = ("qwen3-8b", "qwen3-moe-30b-a3b", "zamba2-1.2b")
CKPT_CASE = ("qwen3-8b", "tp")
STEP_RTOL, LEAF_TOL, AUX_TOL = 1e-5, 1e-4, 1e-6
MESH = MeshShape(("data", "model"), (2, 2))
BF16 = torch.bfloat16
# bf16 cases: (name, layout, moments dtype, LM(remat=)); the first one
# also writes and reloads a sharded bf16 checkpoint
BF16_CASES = (("qwen3-8b", "tp", BF16, False),
              ("qwen3-8b", "auto", torch.float32, False),
              ("qwen3-moe-30b-a3b", "tp", BF16, False),
              ("qwen3-moe-30b-a3b", "tp", BF16, True))
BF16_CEILING = 2.0   # sharded bf16 vs unsharded bf16, over bf16 vs f32


def _batches(name, n=3, b=4, s=16):
    """One batch, ``n`` times (the reference's sharded test's rule: the
    loss then falls step by step)."""
    vocab = smoke_config(name).vocab_size
    rng = np.random.default_rng(sum(map(ord, name)))
    toks = rng.integers(1, vocab, (b, s)).astype(np.int32)
    return [{"tokens": toks, "targets": np.roll(toks, -1, 1)}] * n


def _whole(state):
    return {key: {n: t.detach().clone() for n, t in ts.items()}
            for key, ts in (("params", state.params), ("mu", state.opt.mu),
                            ("nu", state.opt.nu))}


def _steps(model, batches, moments=torch.float32):
    """Three unsharded steps: losses, grad norms and the whole state."""
    state = init_train_state(model, moments_dtype=moments)
    step = make_train_step(model)
    rec = {"loss": [], "grad_norm": [], "aux": []}
    for batch in batches:
        state, m = step(state, batch)
        rec["loss"].append(float(m["loss"]))
        rec["grad_norm"].append(float(m["grad_norm"]))
        rec["aux"].append(float(m["aux"]))
    rec["whole"] = _whole(state)
    return rec


def _bf16_refs(batches):
    """The unsharded port's three steps of each bf16 case's model at bf16
    (with the case's moments) and at float32 on the same values (each
    bf16 weight upcast; float32 moments), keyed (name, moments)."""
    refs = {}
    for name, _, moments, _ in BF16_CASES:
        if (name, moments) in refs:
            continue
        half = LM(smoke_config(name), device="cpu", seed=0,
                  param_dtype=BF16)
        full = LM(smoke_config(name), device="cpu", seed=0)
        full.load_state_dict({k: v.float()
                              for k, v in half.state_dict().items()})
        refs[(name, moments)] = (_steps(half, batches[name], moments),
                                 _steps(full, batches[name]))
    return refs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Each rank's outputs of the one 4-process run and, computed while
    it runs, the unsharded port's steps, its checkpoint and JAX's first
    steps on the same weights."""
    workdir = str(tmp_path_factory.mktemp("sharded_train"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)      # smoke shapes; leave the cores to the ranks
    try:
        return _run(workdir)
    finally:
        torch.set_num_threads(threads)


def _run(workdir):
    ports = {n: LM(smoke_config(n), device="cpu", seed=0) for n in ARCHS}
    weights = {n: {k: v.clone() for k, v in m.state_dict().items()}
               for n, m in ports.items()}
    batches = {n: _batches(n) for n in ARCHS}
    aux_tokens = np.random.default_rng(3).integers(1, 512, (4, 16)).astype(
        np.int32)
    aux_targets = np.roll(aux_tokens, -1, 1)
    aux_mask = np.ones((4, 16), np.float32)
    aux_mask[1, 5:] = aux_mask[2, 12:] = 0.0     # uneven counts per shard
    torch.save({"weights": weights, "batches": batches,
                "train_cases": TRAIN_CASES, "ckpt_case": CKPT_CASE,
                "bf16_cases": BF16_CASES,
                "aux_tokens": aux_tokens, "aux_targets": aux_targets,
                "aux_mask": aux_mask}, os.path.join(workdir, "inputs.pt"))
    procs = spawn(WORKER, workdir)

    ref = {"jax": {}, "ckpt": os.path.join(workdir, "unsharded.npz")}
    for name, model in ports.items():
        tree, _ = lm_params_to_jax(weights[name], model.cfg)
        jm, params = JLM(j_smoke_config(name)), jax.tree.map(jnp.asarray,
                                                             tree)
        jb = {k: jnp.asarray(v) for k, v in batches[name][0].items()}
        _, met = jax.jit(j_make_train_step(jm))(
            JTrainState(params, j_adamw_init(params)), jb)
        ref["jax"][name] = (float(met["loss"]), float(met["grad_norm"]))
        if name == CKPT_CASE[0]:
            ref["jax_like"] = JTrainState(params, j_adamw_init(params))
        if name == "qwen3-moe-30b-a3b":
            with torch.no_grad():
                out = model.train_logits(torch.as_tensor(aux_tokens))
                ref["aux"] = float(out["aux_loss"])
                ref["logits"] = out["logits"].clone()
                _, metrics = lm_loss(model, {
                    "tokens": torch.as_tensor(aux_tokens),
                    "targets": torch.as_tensor(aux_targets),
                    "mask": torch.as_tensor(aux_mask)})
                ref["loss_metrics"] = {k: float(v)
                                       for k, v in metrics.items()}
            ref["aux_jax"] = float(jm.train_logits(params, aux_tokens)[
                "aux_loss"])
        state = init_train_state(model)
        step = make_train_step(model)
        rec = {"loss": [], "grad_norm": [], "aux": []}
        for batch in batches[name]:
            state, m = step(state, batch)
            rec["loss"].append(float(m["loss"]))
            rec["grad_norm"].append(float(m["grad_norm"]))
            rec["aux"].append(float(m["aux"]))
        rec["whole"] = _whole(state)
        ref[name] = rec
        if name == CKPT_CASE[0]:
            save_train_state(ref["ckpt"], model, state, step=3)
    ref["bf16"] = _bf16_refs(batches)
    return {"outs": join(procs, workdir), "ref": ref, "ports": ports,
            "workdir": workdir}


@pytest.mark.parametrize("name,layout", TRAIN_CASES)
def test_sharded_steps_equal_the_unsharded_steps(run, name, layout):
    """Loss and grad norm of each of three steps: the same on every rank,
    within 1e-5 relative of the unsharded port's; the loss falls."""
    want = run["ref"][name]
    got = [o["train"][(name, layout)] for o in run["outs"]]
    for g in got[1:]:
        assert g["loss"] == got[0]["loss"]
        assert g["grad_norm"] == got[0]["grad_norm"]
    for key in ("loss", "grad_norm", "aux"):
        np.testing.assert_allclose(got[0][key], want[key], rtol=STEP_RTOL,
                                   atol=1e-9, err_msg=key)
    assert got[0]["loss"][-1] < got[0]["loss"][0]
    assert all(g["step"] == 3 for g in got)
    # the smoke configurations' 4 heads over 1 KV head do not divide 2
    assert got[0]["layout"] == {"auto": "ddp"}.get(layout, layout)


@pytest.mark.parametrize("name,layout", TRAIN_CASES)
def test_sharded_state_gathers_to_the_unsharded_state(run, name, layout):
    """After three steps every parameter and both moments, gathered
    whole, within 1e-4 of the leaf's largest absolute value of the
    unsharded port's."""
    got = run["outs"][0]["train"][(name, layout)]["whole"]
    want = run["ref"][name]["whole"]
    for key in ("params", "mu", "nu"):
        assert set(got[key]) == set(want[key])
        for n, w in want[key].items():
            scale = max(float(w.abs().max()), 1e-30)
            err = float((got[key][n] - w).abs().max())
            assert err <= LEAF_TOL * scale, (key, n, err, scale)


@pytest.mark.parametrize("name,layout", TRAIN_CASES)
def test_each_rank_holds_its_train_state_blocks(run, name, layout):
    """Parameters and both moments on a rank are the blocks
    ``train_state_specs`` names: each dim of the whole shape divided by
    the sizes of its spec entry's axes; some tensor is cut."""
    model = run["ports"][name]
    pol = make_policy(MESH, batch_size=4,
                      layout={"auto": "ddp"}.get(layout, layout))
    specs = train_state_specs(pol, model)
    sizes = dict(zip(MESH.axis_names, MESH.sizes))
    whole = dict(model.named_parameters())
    for out in run["outs"]:
        rec = out["train"][(name, layout)]
        for pname, spec in specs.params.items():
            want = tuple(n // int(np.prod([sizes[a] for a in spec_axes(e)]))
                         for n, e in zip(whole[pname].shape, spec))
            assert rec["local_shapes"][pname] == want, (pname, spec)
            assert specs.opt.mu[pname] == spec
            assert rec["moment_shapes"][pname] == want
        assert any(s != tuple(whole[p].shape)
                   for p, s in rec["local_shapes"].items())


@pytest.mark.parametrize("name", ARCHS)
def test_unsharded_first_step_matches_jax(run, name):
    """The yardstick: the unsharded port's first step against JAX's
    ``make_train_step`` on the same weights and batch
    (``tests/test_torch_training.py``'s tolerances: loss 1e-5, grad norm
    1e-3 relative)."""
    loss, gnorm = run["ref"]["jax"][name]
    assert run["ref"][name]["loss"][0] == pytest.approx(loss, rel=1e-5)
    assert run["ref"][name]["grad_norm"][0] == pytest.approx(gnorm, rel=1e-3)


def test_sharded_moe_aux_loss_is_the_whole_batch(run):
    """smoke qwen3-moe-30b-a3b under tp, rows over data: the load-balance
    loss E * sum f_e P_e of the whole batch on every rank, within 1e-6 of
    the unsharded port's (the mean of the two shards' losses is another
    number) and within 1e-4 of JAX's."""
    want = run["ref"]["aux"]
    for out in run["outs"]:
        assert out["aux_loss"] == pytest.approx(want, rel=0, abs=AUX_TOL)
    assert run["ref"]["aux_jax"] == pytest.approx(want, rel=1e-4)


def test_sharded_train_logits_are_the_ranks_rows(run):
    """smoke qwen3-moe-30b-a3b under tp on the (2, 2) mesh, rows over
    data: ``train_logits`` returns only this rank's 2 of the 4 rows (no
    gather), equal within 1e-5 to the unsharded logits of those rows;
    ``lm_loss``'s reported ce, aux and loss over a mask that leaves the
    two row shards 21 and 28 tokens are the same on every rank and the
    unsharded port's within 1e-6 relative."""
    want = run["ref"]["logits"]
    for out in run["outs"]:
        d = out["coord"][0]
        got = out["logits"]
        assert tuple(got.shape) == (2,) + tuple(want.shape[1:])
        np.testing.assert_allclose(got.numpy(),
                                   want[2 * d:2 * d + 2].numpy(),
                                   rtol=0, atol=1e-5)
    metrics = [out["loss_metrics"] for out in run["outs"]]
    assert all(m == metrics[0] for m in metrics[1:])
    for key, value in run["ref"]["loss_metrics"].items():
        assert metrics[0][key] == pytest.approx(value, rel=1e-6), key


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_sharded_checkpoint_reads_in_the_reference(run):
    """The sharded state's checkpoint (blocks gathered, rank 0 writes)
    loads with the reference's ``load_checkpoint`` into the reference's
    ``TrainState``: the keys, dtypes and shapes of the unsharded port's
    checkpoint, its values within 1e-4 of each leaf's largest."""
    like = run["ref"]["jax_like"]
    got = j_load(os.path.join(run["workdir"], "sharded.npz"), like)
    want = j_load(run["ref"]["ckpt"], like)
    for (k1, a), (k2, b) in zip(_leaves(got), _leaves(want)):
        assert k1 == k2 and a.dtype == b.dtype and a.shape == b.shape
        scale = max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= LEAF_TOL * scale, k1
    assert int(got.opt.step) == 3


def test_checkpoint_loads_into_a_sharded_state(run):
    """``load_train_state`` into a fresh sharded state (other weights,
    zero moments): each rank cuts its blocks, and gathered whole they
    are the checkpoint's tensors bitwise; the step counter is 3."""
    out = run["outs"][0]["train"][CKPT_CASE]
    for key in ("params", "mu", "nu"):
        for n, t in out["whole"][key].items():
            assert torch.equal(out["loaded"][key][n], t), (key, n)
    assert all(o["train"][CKPT_CASE]["loaded_step"] == 3
               for o in run["outs"])


# --------------------------------------------------------------- bf16 --
def _max_diff(a, b) -> float:
    return max(float((a[n].float() - b[n].float()).abs().max()) for n in b)


@pytest.mark.parametrize("name,layout,moments",
                         [c[:3] for c in BF16_CASES if not c[3]])
def test_sharded_bf16_steps_stay_within_the_bf16_gap(run, name, layout,
                                                     moments):
    """Three bf16 steps on the mesh (bf16 gradients reduced in bf16, one
    buffer per dtype): the same loss and grad norm on every rank, the
    loss falling, each rank's parameters and moments in their dtypes;
    the largest error of the loss and grad norm over the steps and of
    the parameters and both moments after them, against the unsharded
    bf16 steps, within ``BF16_CEILING`` x the unsharded bf16-vs-f32 gap
    of the same quantity."""
    got = [o["bf16"][(name, layout, False)] for o in run["outs"]]
    for g in got[1:]:
        assert g["loss"] == got[0]["loss"]
        assert g["grad_norm"] == got[0]["grad_norm"]
    assert got[0]["loss"][-1] < got[0]["loss"][0]
    half, full = run["ref"]["bf16"][(name, moments)]
    ratios = {}
    for key in ("loss", "grad_norm"):
        err = max(abs(a - b) for a, b in zip(got[0][key], half[key]))
        gap = max(abs(a - b) for a, b in zip(half[key], full[key]))
        ratios[key] = err / gap
    whole = got[0]["whole"]
    for key in ("params", "mu", "nu"):
        assert {n: t.dtype for n, t in whole[key].items()} == \
            {n: t.dtype for n, t in half["whole"][key].items()}, key
        ratios[key] = (_max_diff(whole[key], half["whole"][key])
                       / _max_diff(full["whole"][key], half["whole"][key]))
    print(f"{name} {layout} (moments {moments}): sharded bf16 vs "
          f"unsharded bf16 over unsharded bf16 vs f32: " + ", ".join(
              f"{k} {v:.2f}x" for k, v in ratios.items()))
    assert all(v <= BF16_CEILING for v in ratios.values()), ratios
    assert any(t.dtype == BF16 for t in whole["params"].values())
    assert all(t.dtype == moments for t in whole["mu"].values())


def test_sharded_remat_equals_the_plain_sharded_step_bitwise(run):
    """qwen3-moe-30b-a3b in bf16 under tp, rows over data: ``LM(remat=
    True)``'s three steps equal ``remat=False``'s bitwise (losses, grad
    norms, every parameter and moment gathered whole).  The recompute
    runs in the backward, after the forward removed its batch shard: it
    must take the MoE load-balance means over the whole batch again."""
    for out in run["outs"]:
        plain = out["bf16"][("qwen3-moe-30b-a3b", "tp", False)]
        remat = out["bf16"][("qwen3-moe-30b-a3b", "tp", True)]
        assert remat["loss"] == plain["loss"]
        assert remat["grad_norm"] == plain["grad_norm"]
        assert remat["aux"] == plain["aux"]
    plain = run["outs"][0]["bf16"][("qwen3-moe-30b-a3b", "tp", False)]
    remat = run["outs"][0]["bf16"][("qwen3-moe-30b-a3b", "tp", True)]
    for key in ("params", "mu", "nu"):
        for n, t in plain["whole"][key].items():
            assert torch.equal(remat["whole"][key][n], t), (key, n)


def test_sharded_bf16_checkpoint_loads_back_bitwise(run):
    """The sharded bf16 state (qwen3-8b tp, bf16 moments) written by
    ``save_train_state`` (blocks gathered one buffer per dtype) and
    loaded into a fresh sharded bf16 state: every tensor gathered whole
    bitwise the saved one, in its dtype; the file's manifest names
    bfloat16 and float32 leaves."""
    name, layout = BF16_CASES[0][:2]
    out = run["outs"][0]["bf16"][(name, layout, False)]
    for key in ("params", "mu", "nu"):
        for n, t in out["whole"][key].items():
            got = out["loaded"][key][n]
            assert got.dtype == t.dtype and torch.equal(got, t), (key, n)
    assert all(o["bf16"][(name, layout, False)]["loaded_step"] == 3
               for o in run["outs"])
    with np.load(os.path.join(run["workdir"], "sharded_bfloat16.npz")) as z:
        leaves = json.loads(str(z["__manifest__"]))["leaves"]
    assert {"bfloat16", "float32"} <= {v["dtype"] for v in leaves.values()}
