"""One rank of ``tests/test_torch_sharded.py``'s 4-process gloo run.

    python tests/_torch_sharded_worker.py RANK WORLD WORKDIR

Reads ``WORKDIR/inputs.pt`` (weights carried over from the JAX package,
prompts, the attention case), joins the process group through
``WORKDIR/pg`` (60 s timeout), builds a (2, 2) ``("data", "model")``
mesh, runs every sharded case of the port and writes what it saw to
``WORKDIR/out_RANK.pt``.  It imports torch and the port only.
"""

import datetime
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_host_mesh,
    make_production_mesh,
)
from repro_torch.models.layers import attention as att  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.runtime.sharded import (  # noqa: E402
    ShardedLM,
    make_sharded_session,
)
from repro_torch.sharding.policy import make_policy  # noqa: E402


def _lm(name, inputs):
    model = LM(smoke_config(name), device="cpu")
    model.load_state_dict(inputs["weights"][name], strict=True)
    return model


def _attention(inputs, mesh):
    """attn_decode_seq_sharded on this rank's rows (over ``data``) and
    slots (over ``model``)."""
    case = inputs["attn"]
    d, m = mesh.get_coordinate()
    rows = slice(2 * d, 2 * d + 2)
    s_loc = case["ck"].shape[1] // 2
    slots = slice(m * s_loc, (m + 1) * s_loc)
    p = att.GQA(case["cfg"], device="cpu", generator=None)
    p.load_state_dict(case["params"], strict=True)
    ck = case["ck"][rows, slots].clone()
    cv = case["cv"][rows, slots].clone()
    with torch.no_grad():
        y = att.attn_decode_seq_sharded(
            p, case["cfg"], case["x"][rows], ck, cv, case["pos"][rows],
            group=mesh.get_group("model"))
    return {"y": y, "ck": ck, "cv": cv, "coord": (d, m)}


SEQ_SHARDED_CALLS = [0]
_seq_sharded = att.attn_decode_seq_sharded


def _counted(*args, **kwargs):
    SEQ_SHARDED_CALLS[0] += 1
    return _seq_sharded(*args, **kwargs)


att.attn_decode_seq_sharded = _counted

# each gather of a unit's blocks: the blocks' bytes by dtype, and the
# all_gather calls it made (dtype and bytes of each flat buffer)
GATHERS = []
_gather_blocks = ShardedLM._gather_blocks
_all_gather = dist.all_gather


def _recorded_gather_blocks(self, params, blocks):
    rec = {"blocks": {}, "calls": []}
    for b in blocks:
        key = str(b.dtype)
        rec["blocks"][key] = rec["blocks"].get(key, 0) + b.nbytes
    GATHERS.append(rec)
    return _gather_blocks(self, params, blocks)


def _recorded_all_gather(parts, tensor, *args, **kwargs):
    if GATHERS:
        GATHERS[-1]["calls"].append((str(tensor.dtype), tensor.nbytes))
    return _all_gather(parts, tensor, *args, **kwargs)


ShardedLM._gather_blocks = _recorded_gather_blocks
dist.all_gather = _recorded_all_gather


def _bf16_lm(name):
    """The smoke LM in bf16 from seed 0 (the parent draws the same)."""
    return LM(smoke_config(name), device="cpu", seed=0,
              param_dtype=torch.bfloat16)


def main(rank: int, world: int, workdir: str) -> None:
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'pg')}",
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    mesh = make_host_mesh((2, 2), ("data", "model"), "cpu")
    out = {"coord": tuple(mesh.get_coordinate()),
           "attn": _attention(inputs, mesh)}

    sessions = {}
    for name, layout in inputs["session_cases"]:
        toks, lens = inputs["prompts"][name]
        sess = make_sharded_session(_lm(name, inputs), mesh, max_len=32,
                                    batch_size=4, layout=layout)
        SEQ_SHARDED_CALLS[0] = 0
        m_out, tokens = sess.generate_with_lengths(toks, max_new=8,
                                                   lengths=lens)
        sessions[(name, layout)] = {
            "m": m_out, "tokens": tokens, "layout": sess.layout,
            "seq_sharded_calls": SEQ_SHARDED_CALLS[0],
            "local_shapes": {n: tuple(p.shape) for n, p in
                             sess.model.model.named_parameters()},
            "specs": sess.model.specs}
    out["sessions"] = sessions

    bf16 = {}
    for name, layout in inputs["bf16_session_cases"]:
        toks, lens = inputs["prompts"][name]
        sess = make_sharded_session(_bf16_lm(name), mesh, max_len=32,
                                    batch_size=4, layout=layout)
        SEQ_SHARDED_CALLS[0] = 0
        m_out, tokens = sess.generate_with_lengths(toks, max_new=8,
                                                   lengths=lens)
        bf16[(name, layout)] = {"m": m_out, "tokens": tokens,
                                "layout": sess.layout,
                                "seq_sharded_calls": SEQ_SHARDED_CALLS[0]}
    out["bf16_sessions"] = bf16
    # a bf16 MoE model under tp: its experts bf16, its router float32,
    # both cut: each layer gathers two buffers
    moe16 = make_sharded_session(_bf16_lm("qwen3-moe-30b-a3b"), mesh,
                                 batch_size=4, layout="tp")
    GATHERS.clear()
    with torch.no_grad():
        moe16.model.prefill(torch.as_tensor(inputs["moe_tokens"]),
                            max_len=24)
    out["bf16_gathers"] = list(GATHERS)
    GATHERS.clear()

    sess = make_sharded_session(_lm("qwen3-8b", inputs), mesh,
                                continuous=True, max_slots=4, max_len=32,
                                batch_size=4, layout="tp")
    SEQ_SHARDED_CALLS[0] = 0
    out["continuous"] = sess.serve(inputs["continuous_prompts"], max_new=6)
    out["continuous_seq_sharded_calls"] = SEQ_SHARDED_CALLS[0]
    out["continuous_prefills"] = sess.n_prefills

    moe = make_sharded_session(_lm("qwen3-moe-30b-a3b", inputs), mesh,
                               batch_size=4, layout="tp")
    with torch.no_grad():
        out["moe_logits"] = moe.model.train_logits(
            torch.as_tensor(inputs["moe_tokens"]))["logits"]
    # the batch rows whose logits this rank returned
    out["moe_rows"] = moe.model.local_rows(
        torch.arange(len(inputs["moe_tokens"]))).tolist()

    # a spec entry naming two axes: the block of ("data", "model")
    ddp = make_sharded_session(_lm("rwkv6-3b", inputs), mesh, batch_size=4,
                               layout="ddp")
    out["two_axis_rows"] = ddp.model._rows(torch.arange(8),
                                           ddp.policy.batch_axes)
    out["production_mesh"] = tuple(make_production_mesh(
        model=2, device_type="cpu").shape)
    refusals = []
    for make in (lambda: make_host_mesh((4, 2), ("data", "model"), "cpu"),
                 lambda: make_production_mesh(model=3, device_type="cpu")):
        try:
            make()
        except ValueError as e:
            refusals.append(str(e))
    out["refusals"] = refusals
    out["ddp_policy_batch_axes"] = make_policy(mesh, batch_size=4,
                                               layout="ddp").batch_axes
    torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
