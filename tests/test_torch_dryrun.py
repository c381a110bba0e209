"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's, with no process group and nothing allocated.

``--all`` runs once per mesh (pod1 = (16, 16) ``data x model``, pod2 =
(2, 16, 16) ``pod x data x model``) into a temporary directory, and the
records are held against the reference's arithmetic for all ten
architectures and four shapes: one record per combination, ``ok`` or
``skipped`` as ``shape_supported`` says (the reference's answer); the
analytic fields (``step_cost``, parameter counts, tokens, model FLOPs)
equal; per-rank parameter bytes equal the reference's ``param_specs`` on
a ``jax.sharding.AbstractMesh`` at the reference's bf16 dtypes (the
leaves it keeps in float32 in float32).  ``input_specs``' shapes and
dtypes equal the reference's ``ShapeDtypeStruct`` stand-ins (its decode
state through ``jax.eval_shape``).  Also: ``roofline_terms``' dominance
on H100 rates, ``make_prefill_step`` / ``make_serve_step`` against
``LM.prefill`` / ``decode_step``, the ``--auto`` rule, and the flags
that steer only XLA changing nothing.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` for 512 host devices when
imported; it is imported with the save-and-restore of
``tests/test_dryrun_helpers.py``, and nothing here lowers the
512-device reference.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

_saved = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as j_dr  # noqa: E402
if _saved is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _saved

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import shape_supported as j_shape_supported  # noqa: E402
from repro.models.costs import step_cost as j_step_cost  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.sharding import policy as jpol  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ARCH_NAMES,
    INPUT_SHAPES,
    get_config,
    shape_supported,
    smoke_config,
)
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch.mesh import H100  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.runtime.serving import (  # noqa: E402
    make_prefill_step,
    make_serve_step,
)
from repro_torch.sharding.policy import (  # noqa: E402
    make_policy,
    param_specs,
    spec_axes,
)
from _torch_threads import cap_threads  # noqa: E402

cap_threads()

COMBOS = [(a, s) for a in ARCH_NAMES for s in INPUT_SHAPES]
JAX_MESHES = {"pod1": ((16, 16), ("data", "model")),
              "pod2": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """{mesh: {(arch, shape): record}} of ``--all`` on pod1 and pod2."""
    out = {}
    for mesh in JAX_MESHES:
        folder = str(tmp_path_factory.mktemp(mesh))
        assert dr.main(["--all", "--mesh", mesh, "--out", folder]) == 0
        files = sorted(os.listdir(folder))
        assert len(files) == len(COMBOS)
        out[mesh] = {}
        for arch, shape in COMBOS:
            with open(os.path.join(folder, f"{arch}_{shape}_{mesh}.json")) \
                    as f:
                out[mesh][arch, shape] = json.load(f)
    return out


@functools.lru_cache(maxsize=None)
def _jax_params(arch, shape):
    """The reference's parameter tree at its dry-run dtype (shapes only)."""
    jm = JLM(j_get_config(arch, shape=shape), param_dtype=jnp.bfloat16)
    return jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))


def _entry_size(entry, sizes) -> int:
    axes = () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)
    return int(np.prod([sizes[a] for a in axes]))


def _jax_param_bytes(arch, shape, mesh) -> int:
    """One rank's parameter bytes under the reference's ``param_specs``
    (layout tp, FSDP) on an abstract mesh."""
    dims, names = JAX_MESHES[mesh]
    sizes = dict(zip(names, dims))
    params = _jax_params(arch, shape)
    pol = jpol.make_policy(AbstractMesh(dims, names),
                           batch_size=INPUT_SHAPES[shape][1], layout="tp")
    specs = jpol.param_specs(pol, params)
    total = 0
    for leaf, spec in zip(jax.tree.leaves(params), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))):
        entries = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
        block = [n // _entry_size(e, sizes) for n, e in zip(leaf.shape,
                                                             entries)]
        total += int(np.prod(block)) * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("mesh", sorted(JAX_MESHES))
def test_all_writes_every_combination(records, mesh):
    """40 records a mesh: ``ok``, or ``skipped`` with the reference's
    reason where ``shape_supported`` says so (and it is the
    reference's answer)."""
    for (arch, shape), rec in records[mesh].items():
        ok, reason = shape_supported(arch, shape)
        assert (ok, reason) == j_shape_supported(arch, shape)
        assert rec["mesh"] == mesh and rec["chips"] == (
            256 if mesh == "pod1" else 512)
        if ok:
            assert rec["ok"] and "roofline" in rec, (arch, shape)
        else:
            assert not rec["ok"] and rec["skipped"] == reason


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_analytic_fields_equal_the_references(records, arch):
    """step_cost's FLOPs and bytes, the parameter counts, tokens per call
    and model FLOPs: the reference's arithmetic on its configuration."""
    for shape, (seq, batch, kind) in INPUT_SHAPES.items():
        rec = records["pod1"][arch, shape]
        if not rec["ok"]:
            continue
        cfg = j_get_config(arch, shape=shape)
        pc = cfg.param_counts()
        moments = 2 if pc["total"] >= j_dr.BF16_MOMENTS_THRESHOLD else 8
        sc = j_step_cost(cfg, kind=kind, batch=batch, seq=seq,
                         moments_bytes=moments)
        assert rec["analytic"] == {"flops": sc.flops,
                                   "hbm_bytes": sc.hbm_bytes}
        tokens = batch * seq if kind != "decode" else batch
        assert rec["params_total"] == pc["total"]
        assert rec["params_active"] == pc["active"]
        assert rec["tokens_per_call"] == tokens
        assert rec["model_flops"] == float(
            (6 if kind == "train" else 2) * pc["active"] * tokens)


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("mesh", sorted(JAX_MESHES))
def test_parameter_bytes_per_rank_equal_the_references(records, arch,
                                                       mesh):
    """Per-rank parameter bytes (layout tp, FSDP, bf16 with the
    reference's float32 leaves) == the reference's specs and dtypes."""
    shape = "train_4k"
    rec = records[mesh][arch, shape]
    assert rec["memory"]["argument_terms"]["parameters"] == \
        _jax_param_bytes(arch, shape, mesh)


def test_qwen3_8b_float32_parameters_per_rank_on_pod1():
    """At float32, qwen3-8b's rank of pod1 holds 129,208,320 bytes of
    parameters (the reference's specs on an abstract mesh)."""
    model = LM(get_config("qwen3-8b"), device="meta")
    pol = make_policy(dr.MESHES["pod1"], batch_size=256, layout="tp")
    inputs = dr.input_specs(model.cfg, "train_4k", model=model)
    terms = dr.argument_bytes(model, "train", inputs, pol)
    assert terms["parameters"] == 129_208_320
    assert terms["moments"] == 2 * 129_208_320
    assert terms["total"] == sum(v for k, v in terms.items()
                                 if k != "total")


def _flat(tree, path=()):
    """{path: (shape, dtype name)} of a tree of meta tensors or
    ShapeDtypeStructs (a named tuple by its fields' names)."""
    if hasattr(tree, "_fields"):          # the reference's rwkv6 state
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _flat(tree[k],
                                                     path + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, t in enumerate(tree)
                for p, v in _flat(t, path + (i,)).items()}
    return {path: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_equal_the_references(arch):
    """Every input stand-in of every supported shape: the reference's
    shapes and dtypes (the decode state at seq capacity, bf16)."""
    for shape in INPUT_SHAPES:
        if not shape_supported(arch, shape)[0]:
            continue
        jm = JLM(j_get_config(arch, shape=shape), param_dtype=jnp.bfloat16)
        want = j_dr.input_specs(jm.cfg, shape, model=jm)
        model = LM(get_config(arch, shape=shape), device="meta")
        got = dr.input_specs(model.cfg, shape, model=model)
        assert _flat(got) == _flat(want), (arch, shape)


def test_roofline_terms_dominance():
    """The three terms on H100 rates (bf16 tensor cores, HBM, NVLink) and
    the dominant one, as the reference's test builds them."""
    rec = {"chips": 256,
           "analytic": {"flops": 256 * H100["peak_flops_bf16"],
                        "hbm_bytes": 256 * H100["hbm_bw"] * 2},
           "collectives": {"total_bytes": H100["nvlink_bw"]},
           "model_flops": 256 * H100["peak_flops_bf16"] * 0.5}
    rl = dr.roofline_terms(rec)
    assert rl["compute_s"] == pytest.approx(1.0)
    assert rl["memory_s"] == pytest.approx(2.0)
    assert rl["collective_s"] == pytest.approx(1.0)
    assert rl["dominant"] == "memory"
    assert rl["useful_flops_ratio"] == pytest.approx(0.5)
    assert rl["rates"]["compute"] == "peak_flops_bf16"


def test_port_collectives_follow_its_design(records):
    """qwen3-8b decode_32k under tp on pod1: two all_reduces per
    attention layer (the sequence-sharded decode), one all_gather per
    module with blocks plus the logits; train: one reduce_scatter per
    gathered module; a 1x1 mesh moves nothing."""
    cfg = get_config("qwen3-8b")
    dec = records["pod1"]["qwen3-8b", "decode_32k"]["collectives"]
    assert dec["all-reduce"]["count"] == 2 * cfg.num_layers
    units = cfg.num_layers + 2           # embedding, layers, norm + head
    assert dec["all-gather"]["count"] == units + 1
    train = records["pod1"]["qwen3-8b", "train_4k"]["collectives"]
    assert train["reduce-scatter"]["count"] == units
    assert "not the reference's" in train["source"]
    model = LM(smoke_config("qwen3-8b"), device="meta")
    one = make_policy(((1, 1), ("data", "model")), batch_size=4,
                      layout="tp")
    inputs = {"tokens": torch.empty((4, 16), dtype=torch.int32,
                                    device="meta")}
    assert dr.collective_bytes(model, "train", inputs, one)[
        "total_bytes"] == 0


def test_train_step_gathers_no_logits(records):
    """qwen3-8b train_4k on pod1: the gathers are the modules' blocks
    only (each layer's twice: ``remat`` is on, and its recompute gathers
    again); the loss moves each cross entropy's token count and sum
    (8 bytes, one all_reduce), not the (256, 4096, 151936) bfloat16
    logits (318.6 GB a rank) that an all_gather would make whole."""
    cfg = get_config("qwen3-8b")
    train = records["pod1"]["qwen3-8b", "train_4k"]["collectives"]
    units = cfg.num_layers + 2           # embedding, layers, norm + head
    assert train["all-gather"]["count"] == units + cfg.num_layers
    logits = 256 * 4096 * cfg.padded_vocab * 2
    assert logits == 318_632_886_272
    assert train["total_bytes"] < logits / 10
    model = LM(smoke_config("deepseek-v3-671b"), device="meta")
    pol = make_policy(((2, 2), ("data", "model")), batch_size=4,
                      layout="tp")
    inputs = {k: torch.empty((4, 16), dtype=torch.int32, device="meta")
              for k in ("tokens", "targets")}
    dec = {"tokens": inputs["tokens"][:, :1]}
    with_mtp = dr.collective_bytes(model, "train", inputs, pol)
    no_loss = dr.collective_bytes(model, "prefill", dec, pol)
    assert with_mtp["all-reduce"]["count"] >= 1
    assert with_mtp["all-gather"]["count"] == \
        no_loss["all-gather"]["count"] - 1 + 3    # MTP: embed, block, head


def test_xla_only_flags_change_no_number():
    """``seq_parallel`` changes no number; ``remat`` (the port's
    ``LM(remat=True)``) adds exactly the train step's re-gathers: each
    checkpointed layer's all_gathers once more (zamba2's shared block is
    not checkpointed), and moves no byte of memory."""
    base = dr.analyze("zamba2-1.2b", "train_4k", "pod1")
    other = dr.analyze("zamba2-1.2b", "train_4k", "pod1", seq_parallel=True)
    for key in ("memory", "collectives", "analytic"):
        assert base[key] == other[key]
    assert (other["remat"], other["seq_parallel"]) == (True, True)
    plain = dr.analyze("zamba2-1.2b", "train_4k", "pod1", remat=False)
    assert plain["remat"] is False
    assert plain["memory"] == base["memory"]
    assert plain["analytic"] == base["analytic"]
    model = LM(get_config("zamba2-1.2b"), device="meta",
               param_dtype=torch.bfloat16)
    batch = dr.INPUT_SHAPES["train_4k"][1]
    pol = make_policy(dr.MESHES["pod1"], batch_size=batch, layout="tp")
    layers = [p for gi, g in enumerate(model.cfg.layer_plan)
              if g.mixer != "shared_attn" for p in model.groups[gi]]
    assert len(layers) == 32              # the 32 mamba2 layers
    regather = {"bytes": 0, "count": 0}
    for p in layers:
        for own in _unit_bytes_by_dtype(model, [p], pol):
            regather["bytes"] += 256 * own
            regather["count"] += 1
    got, want = base["collectives"], plain["collectives"]
    assert got["all-gather"] == {
        "bytes": want["all-gather"]["bytes"] + regather["bytes"],
        "count": want["all-gather"]["count"] + regather["count"]}
    for op in ("reduce-scatter", "all-reduce"):
        assert got[op] == want[op]
    assert regather["count"] > 0


def _unit_bytes_by_dtype(model, unit, pol):
    """One rank's bytes of a unit's cut blocks, one entry per dtype
    present, from the specs alone."""
    specs = _specs_by_id(model, pol)
    own = {}
    for mod in unit:
        for name, p in mod.named_parameters():
            spec = specs[id(p)]
            if any(pol.axis_size(spec_axes(e)) > 1 for e in spec):
                own[p.dtype] = own.get(p.dtype, 0) + dr._nbytes(
                    dr.block_shape(p.shape, spec, pol), p.dtype)
    return list(own.values())


def _specs_by_id(model, pol):
    """Each parameter's spec, keyed by the tensor's id."""
    named = dict(model.named_parameters())
    return {id(named[n]): s for n, s in param_specs(pol, model).items()}


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_bf16_collective_bytes_are_the_per_dtype_sum(shape):
    """qwen3-moe-30b-a3b (bf16 experts beside the float32 router) on
    pod1: a record's all_gather and reduce_scatter bytes are the sum, over
    the units and the dtypes in each, of one buffer per dtype at that
    dtype's bytes (no promotion to float32), and the counts one per
    (unit, dtype): what ``ShardedLM`` sends."""
    rec = dr.analyze("qwen3-moe-30b-a3b", shape, "pod1", remat=False)
    cfg = get_config("qwen3-moe-30b-a3b", shape=shape)
    seq, batch, kind = dr.INPUT_SHAPES[shape]
    model = LM(cfg, device="meta", param_dtype=torch.bfloat16)
    pol = make_policy(dr.MESHES["pod1"], batch_size=batch, layout="tp")
    owns = [own for unit in dr._gather_units(model, kind)
            for own in _unit_bytes_by_dtype(model, unit, pol)]
    dtypes = {p.dtype for p in model.parameters()}
    assert dtypes == {torch.bfloat16, torch.float32}
    two = [u for u in dr._gather_units(model, kind)
           if len(_unit_bytes_by_dtype(model, u, pol)) == 2]
    assert two, "no unit gathers two dtypes"
    got = rec["collectives"]
    n_logits = 0
    if kind != "train":     # the last logits' gather over the batch axes
        n_logits = batch * cfg.padded_vocab * 2
        assert got["all-gather"]["count"] == len(owns) + 1
    else:
        assert got["all-gather"]["count"] == len(owns)
        assert got["reduce-scatter"] == {"bytes": sum(owns),
                                         "count": len(owns)}
    assert got["all-gather"]["bytes"] == 256 * sum(owns) + n_logits


def test_auto_keeps_the_references_rule():
    assert dr.auto_settings("qwen3-8b", "decode_32k", "tp", True, False) \
        == ("tp", False, True)            # a 1.02 GB model-axis shard
    assert dr.auto_settings("deepseek-v3-671b", "decode_32k", "tp", True,
                            False) == ("tp", True, True)
    assert dr.auto_settings("rwkv6-3b", "train_4k", "tp", True, False) == \
        ("ddp", True, False)
    assert dr.auto_settings("qwen3-32b", "prefill_32k", "tp", True,
                            False) == ("tp", True, False)


@pytest.mark.parametrize("name", ["qwen3-8b", "whisper-large-v3"])
def test_prefill_and_serve_steps_are_the_lms(name):
    """make_prefill_step / make_serve_step return what LM.prefill and
    LM.decode_step return on the same inputs, bitwise (whisper with
    frames, qwen3-8b with ragged lengths)."""
    cfg = smoke_config(name)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, (2, 6)),
                           dtype=torch.int32)
    kw = {}
    if cfg.is_encoder_decoder:
        kw["frames"] = torch.as_tensor(rng.standard_normal(
            (2, cfg.encoder.max_frames, cfg.d_model)), dtype=torch.float32)
    else:
        kw["lengths"] = torch.tensor([6, 4], dtype=torch.int32)
    outs = []
    for use_steps in (True, False):
        model = LM(cfg, device="cpu", seed=0)
        if use_steps:
            logits, state = make_prefill_step(model, max_len=12)(toks, **kw)
            step = make_serve_step(model)
        else:
            logits, state = model.prefill(toks, max_len=12, **kw)
            step = model.decode_step
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        nxt, state = step(state, tok)
        outs.append((logits, nxt, state["pos"]))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
