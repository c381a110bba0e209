"""One rank of ``tests/test_torch_graphs_sharded.py``'s 4-process gloo run.

    python tests/_torch_graphs_sharded_worker.py RANK WORLD WORKDIR

Reads ``WORKDIR/inputs.pt`` (the port's seeded weights, prompts, train
batches, the cases), stubs the CUDA graphs for the whole process
(``tests/_torch_graph_stub.py``: a replay runs the step again, a capture
refuses host transfers), joins the process group through ``WORKDIR/pg``
(60 s timeout), builds a (2, 2) ``("data", "model")`` mesh and, for each
case, runs the sharded graph paths beside their ``graphs.eager()``
forms: ``GenerationSession`` (two keys), ``prefill(into=)``,
``copy_rows(src_rows=)`` against the copy it replaced, the slot table
and ``compile_train_step``; records the bits, the storage of every
state leaf and the graph counters in ``WORKDIR/out_RANK.pt``.  It
imports torch and the port only.
"""

import contextlib
import datetime
import os
import sys

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(TESTS), "src"))
sys.path.insert(0, TESTS)

from _torch_graph_stub import (  # noqa: E402
    HostTransferInCapture,
    host_transfers_refused,
    install,
)
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.runtime import graphs  # noqa: E402
from repro_torch.runtime.serving import _wave_rows  # noqa: E402
from repro_torch.runtime.sharded import (  # noqa: E402
    _keep,
    _leaves,
    make_sharded_session,
    shard_lm,
)
from repro_torch.sharding.policy import spec_axes, to_placements  # noqa: E402
from repro_torch.training.train_loop import (  # noqa: E402
    compile_train_step,
    init_train_state,
    make_train_step,
)

MAX_LEN, MAX_NEW = 32, 8


# ------------------------------------------- the code the graphs replaced --
def old_block(lm, t, spec):
    """``ShardedLM._block`` before the graphs: ``distribute_tensor``."""
    if not lm._splits(spec):
        return t
    return distribute_tensor(t, lm.mesh, to_placements(lm.mesh, spec),
                             src_data_rank=None).to_local().clone()


def old_gather(lm, t, spec):
    """``ShardedLM._gather`` before the graphs: ``DTensor.full_tensor``."""
    if not lm._splits(spec):
        return t
    return DTensor.from_local(t, lm.mesh, to_placements(lm.mesh, spec),
                              run_check=False).full_tensor()


def old_copy_rows(lm, dst, src, slots):
    """``ShardedLM.copy_rows`` before the graphs, verbatim but for the
    two helpers above: the slots this rank holds read to the host."""
    dst_rows = dst["specs"]["pos"][0]
    n = dst["pos"].shape[0] * (lm.policy.axis_size(spec_axes(dst_rows))
                               if dst_rows else 1)
    held = old_block(lm, torch.arange(n, device=lm.device),
                     (dst_rows,)).tolist()
    where = {s: j for j, s in enumerate(slots)}
    mine = [(i, where[s]) for i, s in enumerate(held) if s in where]
    idx = torch.as_tensor(mine, dtype=torch.long,
                          device=lm.device).reshape(-1, 2)
    for (dp, name, axis), (sp, _, _), (fp, _, _), (fsp, _, _) in zip(
            _leaves(dst), _leaves(dst["specs"]), _leaves(src),
            _leaves(src["specs"])):
        fresh = old_gather(lm, fp[name], _keep(fsp[name], axis, True))
        if mine:
            dp[name].index_copy_(axis, idx[:, 0],
                                 fresh.index_select(axis, idx[:, 1]))


# ------------------------------------------------------------- helpers --
def _lm(name, inputs):
    model = LM(smoke_config(name), device="cpu")
    model.load_state_dict(inputs["weights"][name], strict=True)
    return model


def _bits(tree):
    return [t.detach().clone() for t in graphs.leaves(tree)]


def _ptrs(tree):
    return [t.data_ptr() for t in graphs.leaves(tree)]


def _gathers(lm, gen):
    """``_gather`` / ``_block`` against the DTensor forms, on specs
    cutting one dim over one axis, one over both, two dims one each."""
    same = []
    for spec in (("data", None), (None, "model"), (("data", "model"), None),
                 ("model", "data"), (None, None)):
        whole = torch.randn((8, 6), generator=gen)
        dist.broadcast(whole, 0)
        block = lm._block(whole, spec)
        same.append(torch.equal(block, old_block(lm, whole, spec)))
        same.append(torch.equal(lm._gather(block, spec),
                                old_gather(lm, block, spec)))
        same.append(torch.equal(lm._gather(block, spec), whole))
    return same


def _session(name, layout, inputs, mesh):
    """GenerationSession on the mesh: two keys eager, then twice from the
    (stubbed) graphs; each key's state leaves against the buffers its
    step graph was captured over; prefill(into=) and copy_rows(src_rows=)
    against their eager forms."""
    sess = make_sharded_session(_lm(name, inputs), mesh, max_len=MAX_LEN,
                                batch_size=4, layout=layout)
    lm = sess.model
    toks, lens = inputs["prompts"][name]
    short = inputs["short"][name]

    def run():
        out = sess.generate_with_lengths(toks, max_new=MAX_NEW, lengths=lens)
        return list(out) + list(sess.generate_with_lengths(
            short, max_new=MAX_NEW))

    with graphs.eager():
        eager = run()
    assert "_step_graphs" not in lm.__dict__
    got = [run(), run()]
    cache = lm._step_graphs
    entries = cache.entries()
    rec = {"layout": sess.layout, "eager": eager, "graph": got,
           "captures": cache.captures, "replays": cache.replays,
           "prefill_captures": sum(e.prefills.captures for e in entries),
           "prefill_replays": sum(e.prefills.replays for e in entries),
           "keys": len(cache),
           "step_storage": all(_ptrs(e.loop.state) == [
               t.data_ptr() for t in e.loop._static] for e in entries),
           "shared_pool": cache._pool_owner() is graphs.owner_cache(
               lm.model, 1)}
    rec.update(_into_and_rows(lm, inputs, name))
    return rec


def _into_and_rows(lm, inputs, name):
    toks, lens = inputs["prompts"][name]
    other, _ = inputs["other"][name]
    tok_t = torch.as_tensor(toks)
    len_t = None if lens is None else torch.as_tensor(lens)
    rec = {}
    with torch.inference_mode():
        want_logits, want = lm.prefill(tok_t, max_len=MAX_LEN,
                                       lengths=len_t)
        _, into = lm.prefill(torch.as_tensor(other), max_len=MAX_LEN,
                             lengths=len_t)
        ptrs = _ptrs(into)
        # the eager prefill's checks on the host, none in the capture
        with host_transfers_refused():
            logits, got = lm.prefill(tok_t, max_len=MAX_LEN, lengths=len_t,
                                     check=False, into=into)
        rec["into_is_into"] = got is into
        rec["into_storage"] = _ptrs(into) == ptrs
        rec["into_equal"] = torch.equal(logits, want_logits) and all(
            torch.equal(a, b) for a, b in zip(_bits(into), _bits(want)))
        rec["into_specs"] = into["specs"] == want["specs"]

        # a decode step keeps every leaf's storage
        ptrs = _ptrs(into)
        first = tok_t[:, :1].clone()
        with host_transfers_refused():
            lm.decode_step(into, first)
        rec["decode_storage"] = _ptrs(into) == ptrs

        # admission rows: a 4-slot table state, waves of 1-3 real rows
        # padded to 2 or 4, against the copy the graphs replaced
        rows_ok, storage_ok, refused = [], [], False
        _, table = lm.prefill(torch.as_tensor(other), max_len=MAX_LEN,
                              lengths=len_t)
        for slots, kp in (([3], 2), ([0, 2], 2), ([1, 0, 2], 4), ([2], 1)):
            block = torch.as_tensor(toks[:kp])
            _, new = lm.prefill(block, max_len=MAX_LEN,
                                lengths=None if len_t is None
                                else len_t[:kp])
            want = graphs.clone(table)
            old_copy_rows(lm, want, new, slots)
            eager = graphs.clone(table)
            lm.copy_rows(eager, new, slots)
            dev = graphs.clone(table)
            ptrs = _ptrs(dev)
            rows, src = (torch.as_tensor(a) for a in _wave_rows(slots, kp))
            with host_transfers_refused():
                lm.copy_rows(dev, new, rows, src)
            rows_ok.append(all(torch.equal(a, b) and torch.equal(a, c)
                               for a, b, c in zip(_bits(dev), _bits(want),
                                                  _bits(eager))))
            storage_ok.append(_ptrs(dev) == ptrs)
            try:
                with host_transfers_refused():
                    old_copy_rows(lm, graphs.clone(table), new, slots)
            except HostTransferInCapture:
                refused = True
        rec.update(rows_equal=rows_ok, rows_storage=storage_ok,
                   old_rows_refused=refused)
    return rec


def _table(name, layout, inputs, mesh):
    """The slot table on the mesh: serve eager, then twice from the
    (stubbed) graphs, reset between; its bits and storage."""
    sess = make_sharded_session(_lm(name, inputs), mesh, continuous=True,
                                max_slots=4, max_len=MAX_LEN, batch_size=4,
                                layout=layout)
    prompts = inputs["continuous"]
    ptrs = _ptrs(sess._table)
    with graphs.eager():
        eager = sess.serve(prompts, max_new=6)
    eager_bits = _bits(sess._table)
    runs = []
    for _ in range(2):
        sess.reset()
        runs.append((sess.serve(prompts, max_new=6), _bits(sess._table)))
    return {"eager": eager, "graph": [r for r, _ in runs],
            "bits_equal": [all(torch.equal(a, b) for a, b in
                               zip(bits, eager_bits)) for _, bits in runs],
            "storage": _ptrs(sess._table) == ptrs,
            "step_captures": sess._graphs.captures,
            "step_replays": sess._graphs.replays,
            "wave_captures": sess._waves.captures,
            "wave_replays": sess._waves.replays}


def _train(name, layout, inputs, mesh):
    """Two steps of ``compile_train_step`` over a ShardedLM, under
    ``graphs.eager()`` and from the (stubbed) graph, on the same weights
    and batches: metrics and this rank's state."""
    out = {}
    for mode in ("eager", "graph"):
        lm, _ = shard_lm(_lm(name, inputs), mesh, batch_size=4,
                         layout=layout)
        state = init_train_state(lm)
        step = compile_train_step(make_train_step(lm), lm)
        metrics = []
        with (graphs.eager() if mode == "eager"
              else contextlib.nullcontext()):
            for batch in inputs["batches"]:
                state, m = step(state, batch)
                metrics.append({k: torch.as_tensor(v).clone()
                                for k, v in m.items()})
        out[mode] = {"metrics": metrics, "state": _bits(
            (state.params, state.opt.mu, state.opt.nu, state.opt.step)),
            "captures": step.graphs.captures,
            "replays": step.graphs.replays}
    return out


def main(rank: int, world: int, workdir: str) -> None:
    install()
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'pg')}",
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    mesh = make_host_mesh((2, 2), ("data", "model"), "cpu")
    out = {"coord": tuple(mesh.get_coordinate()), "sessions": {},
           "tables": {}, "train": {}}
    for name, layout in inputs["session_cases"]:
        out["sessions"][(name, layout)] = _session(name, layout, inputs,
                                                   mesh)
    for name, layout in inputs["table_cases"]:
        out["tables"][(name, layout)] = _table(name, layout, inputs, mesh)
    for name, layout in inputs["train_cases"]:
        out["train"][(name, layout)] = _train(name, layout, inputs, mesh)
    lm, _ = shard_lm(_lm("qwen3-8b", inputs), mesh, batch_size=4,
                     layout="tp")
    out["gathers"] = _gathers(lm, torch.Generator().manual_seed(rank))
    torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
