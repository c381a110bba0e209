"""The port's sharded serving on 4 gloo ranks of the CPU, against the
unsharded port and the unsharded JAX package.

One spawn per module: ``tests/_torch_sharded_worker.py`` runs every
sharded case on a (2, 2) ``("data", "model")`` mesh of 4 processes
(gloo, ``init_method=file://`` in a temporary directory, 60 s timeouts,
a join deadline) and writes what each rank saw; the tests read it.  The
reference's own sharded tests fail under jax 0.9.0 (ROADMAP C.4), so the
port is held against the unsharded JAX run, on the weights the JAX
port drew (carried to JAX by ``lm_params_to_jax``):

* ``attn_decode_seq_sharded`` (each rank's slots through ``flash_decode``
  with the softmax state out, merged with ``all_reduce``) against JAX's
  ``attn_decode`` at the shapes of the reference's passing
  ``test_shard_map_flash_decode_matches_reference``: output within 3e-5,
  caches within 1e-6;
* sharded ``GenerationSession.generate_with_lengths`` (smoke qwen3-8b
  ``tp`` and ``auto``, rwkv6-3b ``auto``, zamba2-1.2b ``tp``) and the
  sharded ``ContinuousGenerationSession.serve`` (qwen3-8b ``tp``, 6
  prompts of 4-11 tokens on 4 slots) against the unsharded port and JAX
  sessions: tokens up to the first one whose top-2 logit margin is under
  1e-4 (a rank runs other batch shapes, so logits may differ in the last
  bits; ROADMAP C);
* smoke qwen3-moe-30b-a3b ``train_logits`` (drop-free: capacity factor
  E / top_k) within 3e-4 of the unsharded port and JAX;
* each rank's parameter blocks against their specs, a two-axis spec's
  block, the mesh helpers' refusals.

The plain ``flash_decode(return_stats=True)`` + ``merge_decode_stats``
over 1-4 slices equals the whole cache (no spawn).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models.config import LayerGroup as JLayerGroup
from repro.models.config import ModelConfig as JModelConfig
from repro.models.layers import attention as j_att
from repro.models.model import LM as JLM
from repro.runtime.serving import ContinuousGenerationSession as JContinuous
from repro.runtime.serving import GenerationSession as JSession
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_to_jax
from repro_torch.kernels.decode_attention import (
    flash_decode_plain,
    merge_decode_stats,
)
from repro_torch.launch import dryrun as dr
from repro_torch.launch import serve as serve_cli
from repro_torch.models.layers import attention as att
from repro_torch.models.config import LayerGroup, ModelConfig
from repro_torch.models.model import LM
from repro_torch.runtime.serving import (
    ContinuousGenerationSession,
    GenerationSession,
    greedy_margins,
)
from repro_torch.sharding.policy import MeshShape, make_policy
from _torch_threads import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_sharded_worker.py")
WORLD, JOIN_S = 4, 240
MARGIN = 1e-4
SESSION_CASES = (("qwen3-8b", "tp"), ("qwen3-8b", "auto"),
                 ("rwkv6-3b", "auto"), ("zamba2-1.2b", "tp"))
# bf16 sessions against the unsharded bf16 port behind bf16's margin
BF16_SESSION_CASES = (("qwen3-8b", "tp"), ("rwkv6-3b", "auto"))
BF16_MARGIN = 0.125       # tests/test_torch_bf16.py's MARGIN
ARCHS = ("qwen3-8b", "rwkv6-3b", "zamba2-1.2b", "qwen3-moe-30b-a3b")
ATTN_CFG = dict(name="t", arch_type="dense", d_model=64, vocab_size=128,
                num_heads=8, num_kv_heads=4, head_dim=16, d_ff=128)


def _attn_case():
    """The reference test's shapes: B=4, 32 slots, 8 heads over 4 KV
    heads of 16, pos (5, 11, 17, 29).  Returns the worker's inputs and
    the GQA's JAX parameters."""
    cfg = ModelConfig(layer_plan=(LayerGroup(mixer="attn", ffn="dense",
                                             count=1),), **ATTN_CFG).validate()
    gen = torch.Generator().manual_seed(0)
    p = att.GQA(cfg, device="cpu", generator=gen)
    rng = np.random.default_rng(0)
    case = {"cfg": cfg, "params": p.state_dict(),
            "x": torch.as_tensor(rng.standard_normal((4, 1, 64)),
                                 dtype=torch.float32),
            "ck": torch.as_tensor(rng.standard_normal((4, 32, 4, 16)) * 0.3,
                                  dtype=torch.float32),
            "cv": torch.as_tensor(rng.standard_normal((4, 32, 4, 16)) * 0.3,
                                  dtype=torch.float32),
            "pos": torch.as_tensor([5, 11, 17, 29], dtype=torch.int32)}
    return case, {n: {"w": jnp.asarray(t.numpy())}
                  for n, t in ((k.split(".")[0], v)
                               for k, v in p.state_dict().items())}


def _attn_want(case, params):
    """JAX's unsharded attn_decode of the case: (y, cache_k, cache_v)."""
    j_cfg = JModelConfig(layer_plan=(JLayerGroup(mixer="attn", ffn="dense",
                                                 count=1),),
                         **ATTN_CFG).validate()
    want = j_att.attn_decode(params, j_cfg,
                             *(jnp.asarray(case[k].numpy())
                               for k in ("x", "ck", "cv", "pos")))
    return [np.asarray(a) for a in want]


def _prompts(name, vocab):
    rng = np.random.default_rng(1)
    toks = rng.integers(4, vocab, (4, 12)).astype(np.int32)
    # ragged rows where the plan takes them (attention only)
    lens = np.array([12, 7, 12, 9], np.int32) if name == "qwen3-8b" else None
    return toks, lens


def _spawn(workdir):
    """The 4 ranks, each logging to a file (a full pipe would stall a
    rank inside a collective)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for r in range(WORLD):
        with open(os.path.join(workdir, f"log_{r}.txt"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, str(r), str(WORLD), workdir],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def _join(procs, workdir):
    try:
        for p in procs:
            p.wait(timeout=JOIN_S)
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        with open(os.path.join(workdir, f"log_{r}.txt")) as log:
            assert p.returncode == 0, f"rank {r}:\n{log.read()[-4000:]}"
    return [torch.load(os.path.join(workdir, f"out_{r}.pt"),
                       weights_only=False) for r in range(WORLD)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Inputs, each rank's outputs of the one 4-process run and, computed
    while it runs, the unsharded references of the port and of JAX (on
    the port's seeded weights, carried over by ``lm_params_to_jax``)."""
    workdir = str(tmp_path_factory.mktemp("sharded"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)      # smoke shapes; leave the cores to the ranks
    try:
        return _run(workdir)
    finally:
        torch.set_num_threads(threads)


def _run(workdir):
    ports, jax_models = {}, {}
    for name in ARCHS:
        ports[name] = LM(smoke_config(name), device="cpu", seed=0)
        tree, _ = lm_params_to_jax(ports[name].state_dict(), ports[name].cfg)
        jax_models[name] = (JLM(j_smoke_config(name)),
                            jax.tree.map(jnp.asarray, tree))
    attn, attn_params = _attn_case()
    prompts = {n: _prompts(n, smoke_config(n).vocab_size)
               for n in ("qwen3-8b", "rwkv6-3b", "zamba2-1.2b")}
    rng = np.random.default_rng(2)
    cont = [rng.integers(4, 512, int(rng.integers(4, 12))).astype(np.int32)
            for _ in range(6)]
    moe_tokens = np.random.default_rng(3).integers(1, 512, (4, 16)).astype(
        np.int32)
    torch.save({"weights": {n: m.state_dict() for n, m in ports.items()},
                "attn": attn, "prompts": prompts,
                "session_cases": SESSION_CASES,
                "bf16_session_cases": BF16_SESSION_CASES,
                "continuous_prompts": cont,
                "moe_tokens": moe_tokens}, os.path.join(workdir, "inputs.pt"))
    procs = _spawn(workdir)

    ref = {"attn": _attn_want(attn, attn_params), "sessions": {}}
    for name, (toks, lens) in prompts.items():
        jm, params = jax_models[name]
        ref["sessions"][name] = (
            GenerationSession(ports[name], max_len=32).generate_with_lengths(
                toks, max_new=8, lengths=lens),
            JSession(jm, params, max_len=32).generate_with_lengths(
                toks, max_new=8, lengths=lens))
    jm, params = jax_models["qwen3-8b"]
    ref["continuous"] = (
        ContinuousGenerationSession(ports["qwen3-8b"], max_slots=4,
                                    max_len=32).serve(cont, max_new=6),
        JContinuous(jm, params, max_slots=4, max_len=32).serve(cont,
                                                               max_new=6))
    jm, params = jax_models["qwen3-moe-30b-a3b"]
    with torch.no_grad():
        ref["moe"] = (
            ports["qwen3-moe-30b-a3b"].train_logits(
                torch.as_tensor(moe_tokens))["logits"].numpy(),
            np.asarray(jm.train_logits(params, moe_tokens)["logits"]))
    ref["bf16"] = {}
    for name, _ in BF16_SESSION_CASES:
        half = LM(smoke_config(name), device="cpu", seed=0,
                  param_dtype=torch.bfloat16)
        toks, lens = prompts[name]
        ref["bf16"][name] = (half, GenerationSession(
            half, max_len=32).generate_with_lengths(toks, max_new=8,
                                                    lengths=lens))
    # the margin cuts of the reference rows, while the ranks still run
    for name, (toks, lens) in prompts.items():
        for t, n, out in zip(toks, lens if lens is not None
                             else [toks.shape[1]] * len(toks),
                             ref["sessions"][name][0][1]):
            _held(ports[name], t[:n], out)
    for p, (_, out) in zip(cont, ref["continuous"][0]):
        _held(ports["qwen3-8b"], p, out)
    return {"outs": _join(procs, workdir), "ports": ports, "ref": ref,
            "prompts": prompts, "continuous_prompts": cont}


_HELD = {}


def _held(model, prompt, tokens) -> int:
    """How many leading ``tokens`` (a greedy continuation of ``prompt``)
    stand behind a top-2 logit margin of at least 1e-4 (memoized: the
    rows are held against several outputs)."""
    key = (id(model), np.asarray(prompt).tobytes(),
           np.asarray(tokens).tobytes())
    if key not in _HELD:
        low = np.flatnonzero(greedy_margins(model, prompt, tokens) < MARGIN)
        _HELD[key] = int(low[0]) if low.size else len(tokens)
    return _HELD[key]


def _assert_rows_equal(model, prompts, want, got, m_want=None, m_got=None):
    """Rows of ``got`` equal ``want`` up to the margin cut, and so do the
    pre-EOS lengths of the rows held whole; the cuts keep most of the
    tokens."""
    kept = total = 0
    for i, (prompt, w, g) in enumerate(zip(prompts, want, got)):
        n = _held(model, prompt, w)
        np.testing.assert_array_equal(np.asarray(g)[:n], np.asarray(w)[:n])
        if m_want is not None and n == len(w):
            assert m_got[i] == m_want[i], i
        kept, total = kept + n, total + len(w)
    assert kept >= 0.75 * total, (kept, total)


# ------------------------------------------------------------ the kernel --
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_plain_stats_merged_over_slices_equal_the_whole_cache(n):
    """flash_decode_plain(return_stats=True) over n slices, merged, equals
    the whole cache: ragged lengths, a slice with no valid slot, a
    length-0 row (which averages over every slot) and a window."""
    g = torch.Generator().manual_seed(n)
    b, h, hkv, d, s = 5, 8, 4, 16, 48
    q = torch.randn(b, h, d, generator=g)
    k = torch.randn(b, s, hkv, d, generator=g)
    v = torch.randn(b, s, hkv, d, generator=g)
    lens = torch.tensor([1, 17, 0, 48, 60], dtype=torch.int32)
    cuts = np.linspace(0, s, n + 1).astype(int)
    for window in (None, 7):
        whole, m_w, l_w = flash_decode_plain(q, k, v, lens, window=window,
                                             return_stats=True)
        assert torch.equal(whole, flash_decode_plain(q, k, v, lens,
                                                     window=window))
        parts = [flash_decode_plain(
            q, k[:, lo:hi], v[:, lo:hi], (lens - lo).clamp(min=0),
            window=window, return_stats=True)
            for lo, hi in zip(cuts[:-1], cuts[1:])]
        merged = merge_decode_stats(*zip(*parts))
        torch.testing.assert_close(merged, whole, rtol=0, atol=1e-6)
        # the stats of one slice are the whole cache's
        if n == 1:
            torch.testing.assert_close(parts[0][1], m_w, rtol=0, atol=0)
            torch.testing.assert_close(parts[0][2], l_w, rtol=0, atol=0)


# ------------------------------------------------------------ the ranks --
def test_seq_sharded_decode_matches_jax_attn_decode(run):
    """Each rank's rows and slots: output within 3e-5 of JAX's
    unsharded attn_decode, caches within 1e-6; ranks of one row block
    agree bitwise."""
    y_want, ck_want, cv_want = run["ref"]["attn"]
    y_want = y_want.reshape(4, -1)
    by_coord = {o["attn"]["coord"]: o["attn"] for o in run["outs"]}
    for (d, m), a in by_coord.items():
        rows = slice(2 * d, 2 * d + 2)
        slots = slice(16 * m, 16 * m + 16)
        np.testing.assert_allclose(a["y"].reshape(2, -1).numpy(),
                                   y_want[rows], rtol=3e-5, atol=3e-5)
        np.testing.assert_allclose(a["ck"].numpy(), ck_want[rows, slots],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(a["cv"].numpy(), cv_want[rows, slots],
                                   rtol=1e-6, atol=1e-6)
        assert torch.equal(a["y"], by_coord[(d, 1 - m)]["y"])


@pytest.mark.parametrize("name,layout", SESSION_CASES)
def test_sharded_session_serves_the_unsharded_tokens(run, name, layout):
    """generate_with_lengths on the mesh == the unsharded port session ==
    the unsharded JAX session, behind the margin; every rank returns the
    same whole batch."""
    toks, lens = run["prompts"][name]
    model = run["ports"][name]
    (m_ref, out_ref), (m_jax, out_jax) = run["ref"]["sessions"][name]
    got = [o["sessions"][(name, layout)] for o in run["outs"]]
    for g in got[1:]:
        np.testing.assert_array_equal(g["tokens"], got[0]["tokens"])
        np.testing.assert_array_equal(g["m"], got[0]["m"])
    # the smoke configurations' 1 or 40 heads do not divide the model axis
    assert got[0]["layout"] == {"auto": "ddp"}.get(layout, layout)
    # tp splits the attention caches' slots over model: decoded in place
    assert (got[0]["seq_sharded_calls"] > 0) == (
        got[0]["layout"] == "tp"), got[0]["seq_sharded_calls"]
    rows = [t[:n] for t, n in zip(toks, lens if lens is not None
                                  else [toks.shape[1]] * len(toks))]
    _assert_rows_equal(model, rows, out_ref, got[0]["tokens"], m_ref,
                       got[0]["m"])
    _assert_rows_equal(model, rows, out_ref, np.asarray(out_jax), m_ref,
                       np.asarray(m_jax))


def test_sharded_continuous_session_matches_unsharded(run):
    """ContinuousGenerationSession.serve on the mesh (qwen3-8b, tp: rows
    over data, slots over model; admission waves of 1, 2 and 4 rows)
    == the unsharded port's and JAX's slot tables, behind the margin."""
    prompts = run["continuous_prompts"]
    model = run["ports"]["qwen3-8b"]
    want, want_jax = run["ref"]["continuous"]
    got = run["outs"][0]["continuous"]
    for out in run["outs"][1:]:
        assert [m for m, _ in out["continuous"]] == [m for m, _ in got]
        for (_, a), (_, b) in zip(out["continuous"], got):
            np.testing.assert_array_equal(a, b)
    assert run["outs"][0]["continuous_prefills"] > 1
    assert run["outs"][0]["continuous_seq_sharded_calls"] > 0
    for other in (got, want_jax):
        _assert_rows_equal(model, prompts, [t for _, t in want],
                           [np.asarray(t) for _, t in other],
                           [m for m, _ in want], [m for m, _ in other])


def test_sharded_moe_train_logits_match(run):
    """qwen3-moe-30b-a3b (experts over model, rows over data) train_logits
    on the mesh: each rank's logits are its rows' (no gather), within
    3e-4 of those rows of the unsharded port and of JAX."""
    want, want_jax = run["ref"]["moe"]
    for out in run["outs"]:
        got, rows = out["moe_logits"].numpy(), out["moe_rows"]
        assert len(rows) == len(want) // 2
        np.testing.assert_allclose(got, want[rows], rtol=3e-4, atol=3e-4)
        np.testing.assert_allclose(got, want_jax[rows], rtol=3e-4,
                                   atol=3e-4)


def test_each_rank_holds_the_blocks_its_specs_name(run):
    """A parameter's local shape is its whole shape divided, dim by dim,
    by the sizes of the axes its spec names; a spec over two axes gives
    rank (d, m) block 2d + m (the major axis first)."""
    sizes = {"data": 2, "model": 2}
    for out in run["outs"]:
        for (name, _), sess in out["sessions"].items():
            whole = dict(run["ports"][name].named_parameters())
            for pname, spec in sess["specs"].items():
                want = tuple(
                    n // int(np.prod([sizes[a] for a in
                                      ((e,) if isinstance(e, str) else
                                       (e or ()))]))
                    for n, e in zip(whole[pname].shape, spec))
                assert sess["local_shapes"][pname] == want, (pname, spec)
            assert any(s != tuple(whole[p].shape) for p, s in
                       sess["local_shapes"].items())
        d, m = out["coord"]
        assert out["ddp_policy_batch_axes"] == ("data", "model")
        assert out["two_axis_rows"].tolist() == [4 * d + 2 * m,
                                                 4 * d + 2 * m + 1]


def test_mesh_helpers_refuse_what_they_cannot_build(run):
    for out in run["outs"]:
        assert out["production_mesh"] == (2, 2)
        assert len(out["refusals"]) == 2


def test_serve_mesh_refuses_to_run_outside_torchrun(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        serve_cli.main(["--smoke", "--device", "cpu", "--mesh", "2x2"])


# ---------------------------------------------------------------- bf16 --
@pytest.mark.parametrize("name,layout", BF16_SESSION_CASES)
def test_sharded_bf16_session_serves_the_unsharded_bf16_tokens(run, name,
                                                               layout):
    """A bf16 model on the mesh (qwen3-8b tp: the caches' slots over
    model, each rank's partial decode output rounded to bf16 before the
    float32 merge; rwkv6-3b auto: rows only): every rank returns the
    same tokens; each row equals the unsharded bf16 port's, or first
    differs at a token whose top-2 margin there is under bf16's 0.125
    (``tests/test_torch_bf16.py``); at least half the rows equal
    whole."""
    toks, lens = run["prompts"][name]
    half, (m_ref, out_ref) = run["ref"]["bf16"][name]
    got = [o["bf16_sessions"][(name, layout)] for o in run["outs"]]
    for g in got[1:]:
        np.testing.assert_array_equal(g["tokens"], got[0]["tokens"])
    assert got[0]["layout"] == {"auto": "ddp"}.get(layout, layout)
    assert (got[0]["seq_sharded_calls"] > 0) == (layout == "tp")
    rows = [t[:n] for t, n in zip(toks, lens if lens is not None
                                  else [toks.shape[1]] * len(toks))]
    equal = 0
    for prompt, want, g in zip(rows, out_ref, got[0]["tokens"]):
        g = np.asarray(g)
        if np.array_equal(g, want):
            equal += 1
            continue
        first = int(np.flatnonzero(g != want)[0])
        margins = greedy_margins(half, prompt, want[:first + 1])
        assert margins[first] < BF16_MARGIN, (prompt, want, g, margins)
    print(f"{name} {layout} bf16: {equal} of {len(rows)} rows equal, the "
          f"rest part behind a top-2 margin under {BF16_MARGIN}")
    assert equal >= len(rows) // 2, equal


def test_bf16_units_gather_one_buffer_per_dtype(run):
    """A bf16 qwen3-moe-30b-a3b prefill under tp: each unit's gather makes
    one all_gather per dtype among its blocks, each of exactly those
    blocks' bytes (a bf16 block at 2 bytes a value, never promoted); the
    MoE layers gather two (bf16 experts, float32 router).  The dry run's
    all-gather count and bytes for this prefill on a (2, 2) mesh are
    these calls' (each result buffer: 4 ranks' blocks), plus the last
    logits' gather."""
    model = LM(smoke_config("qwen3-moe-30b-a3b"), device="meta",
               param_dtype=torch.bfloat16)
    tokens = torch.empty((4, 16), dtype=torch.int32, device="meta")
    want = dr.collective_bytes(model, "prefill", {"tokens": tokens},
                               make_policy(MeshShape(("data", "model"),
                                                     (2, 2)),
                                           batch_size=4, layout="tp"))
    logits = 4 * model.cfg.padded_vocab * 2
    for out in run["outs"]:
        gathers = out["bf16_gathers"]
        assert gathers
        for g in gathers:
            assert sorted(g["calls"]) == sorted(g["blocks"].items()), g
        assert any(len(g["calls"]) == 2 for g in gathers)
        assert all("torch.bfloat16" in g["blocks"] for g in gathers)
        calls = [n for g in gathers for _, n in g["calls"]]
        assert want["all-gather"] == {"count": len(calls) + 1,
                                      "bytes": 4 * sum(calls) + logits}
