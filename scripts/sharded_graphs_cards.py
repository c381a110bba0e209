"""A ``ShardedLM`` across cards from its CUDA graphs, against eager.

    python3 scripts/sharded_graphs_cards.py [--device cuda|cpu] [--full]

Spawns 4 ranks of this script (one card each on ``cuda``; gloo ranks of
the CPU on ``cpu``, where nothing is captured: a rehearsal of the control
flow), joined over ``tcp://localhost`` (a free port, 60 s timeouts), on a
(2, 2) ``("data", "model")`` mesh.  For each layout (``tp``, ``ddp``)
the smoke qwen3-8b runs, eager (``graphs.eager()``) and then twice from
the graphs, with every collective of a step captured (the weight and
state gathers, the sequence-sharded all_reduces, the train step's
reduce_scatter and all_reduces):

* ``GenerationSession`` (a B=4 ragged block and a B=1 block) and a slot
  table of 4 serving 6 prompts: tokens, rows and the table's bits
  equal, on every rank;
* two ``compile_train_step`` steps: metrics and this rank's parameters
  and moments equal.

``--full`` adds qwen3-8b at full width in bf16 under ``tp``: the B=8
generate from the graphs against eager, and the B=8 decode step in
turns, eager and from the session's step graph (device-synced ms).

Rank 0 prints each line, the cards' ``nvidia-smi`` name and power limit,
and a JSON line of the results; the exit code is 0 only if every rank
found every path equal and shut down within ``--limit`` seconds (every
graph is released first: NCCL destroys a communicator only once the
graphs that captured its collectives are gone).
"""

import argparse
import contextlib
import datetime
import json
import os
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4


def launch(args) -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--device", args.device,
         "--rank", str(r), "--port", str(port)]
        + (["--full"] if args.full else []),
        env=dict(os.environ, OMP_NUM_THREADS="1"),
        stdout=None if r == 0 else subprocess.DEVNULL)
        for r in range(WORLD)]
    deadline = time.time() + args.limit
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        print(f"ranks still running after {args.limit:.0f} s: killed",
              flush=True)
    finally:
        for p in procs:
            p.kill()
    return 0 if all(p.wait() == 0 for p in procs) else 1


def rank_main(args) -> int:
    sys.path[:0] = [os.path.join(HERE, "src"), HERE]
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import LM
    from repro_torch.runtime import graphs
    from repro_torch.runtime.sharded import make_sharded_session, shard_lm
    from repro_torch.training.train_loop import (compile_train_step,
                                                 init_train_state,
                                                 make_train_step)

    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.set_device(args.rank)
    dist.init_process_group(
        "nccl" if cuda else "gloo",
        init_method=f"tcp://localhost:{args.port}", rank=args.rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=60))
    dev = torch.device("cuda", args.rank) if cuda else torch.device("cpu")
    mesh = make_host_mesh((2, 2), ("data", "model"), dev.type)
    say = print if args.rank == 0 else (lambda *a, **k: None)
    if cuda:
        import chip_smoke as cs
        cs.SMI = cs.smi_line()
        say(f"{WORLD} ranks, {torch.cuda.get_device_name(dev)}; "
            f"nvidia-smi: {cs.SMI}", flush=True)
    results = {}

    def agree(key, what, ok: bool) -> None:
        flag = torch.tensor([1.0 if ok else 0.0], device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        results[key] = bool(flag.item())
        say(f"  {what}: {'equal on every rank' if results[key] else 'DIFFER'}",
            flush=True)

    def smoke():
        return LM(smoke_config("qwen3-8b"), device=dev, seed=0)

    def same(a, b):
        return len(a) == len(b) and all(np.array_equal(x, y)
                                        for x, y in zip(a, b))

    rng = np.random.default_rng(0)
    toks = rng.integers(4, 512, (4, 12)).astype(np.int32)
    lens = np.array([12, 7, 12, 9], np.int32)
    short = rng.integers(4, 512, (1, 9)).astype(np.int32)
    prompts = [rng.integers(4, 512, int(n)).astype(np.int32)
               for n in rng.integers(4, 12, 6)]
    stream = rng.integers(1, 512, (2, 4, 17)).astype(np.int32)
    batches = [{"tokens": s[:, :-1], "targets": s[:, 1:]} for s in stream]
    for layout in ("tp", "ddp"):
        before = graphs.totals()
        sess = make_sharded_session(smoke(), mesh, max_len=32, batch_size=4,
                                    layout=layout)
        table = make_sharded_session(smoke(), mesh, continuous=True,
                                     max_slots=4, max_len=32, batch_size=4,
                                     layout=layout)

        def run():
            out = list(sess.generate_with_lengths(toks, max_new=8,
                                                  lengths=lens))
            out += list(sess.generate_with_lengths(short, max_new=8))
            table.reset()
            for m, t in table.serve(prompts, max_new=6):
                out += [np.asarray([m]), t]
            return out + [t.cpu().numpy() for t in graphs.leaves(
                (table._state, table._tok, table._done))]

        with graphs.eager():
            want = run()
        ok = all(same(run(), want) for _ in range(2))
        moved = {k: graphs.totals()[k] - before[k] for k in before}
        agree(f"{layout} serving", f"smoke qwen3-8b {layout}: sessions and "
              f"slot table from the "
              f"graphs == eager ({moved['captures']} captures in "
              f"{moved['capture_s']:.2f}s, {moved['replays']} replays)", ok)

        runs = {}
        for mode in ("eager", "graph"):
            lm, _ = shard_lm(smoke(), mesh, batch_size=4, layout=layout)
            state = init_train_state(lm)
            step = compile_train_step(make_train_step(lm), lm)
            mets = []
            with (graphs.eager() if mode == "eager"
                  else contextlib.nullcontext()):
                for b in batches:
                    state, m = step(state, b)
                    mets.append(torch.stack([m["loss"], m["grad_norm"]]))
            runs[mode] = ([t.detach().clone() for t in graphs.leaves(
                (mets, state.params, state.opt.mu, state.opt.nu))],
                step.graphs.captures)
        ok = all(torch.equal(a, b) for a, b in zip(runs["eager"][0],
                                                   runs["graph"][0]))
        agree(f"{layout} training", f"smoke qwen3-8b {layout}: 2 compiled "
              f"train steps "
              f"({runs['graph'][1]} capture) == eager", ok)
        del sess, table, lm, state, step, runs

    if args.full and cuda:
        from repro_torch.models.registry import resolve
        model = resolve("qwen3-8b", size="full", device=dev, seed=0,
                        param_dtype=torch.bfloat16).model
        sess = make_sharded_session(model, mesh, max_len=cs.QW_T,
                                    batch_size=8, layout="tp")
        big = rng.integers(4, model.cfg.vocab_size, (8, 64)).astype(np.int32)
        big_lens = np.concatenate([[64], rng.integers(5, 65, 7)]).astype(
            np.int32)

        def gen():
            return list(sess.generate_with_lengths(
                big, max_new=cs.SH_NEW, lengths=big_lens))

        with graphs.eager():
            want = gen()
        agree("full serving", "qwen3-8b bf16 full width, tp on 2x2: B=8 "
              "generate from the "
              "graphs == eager", same(gen(), want))
        block = torch.as_tensor(big, device=dev)
        ms = {"eager": [], "graph": []}
        for _ in range(2):
            ms["eager"].append(cs.step_ms(sess.model, block))
            ms["graph"].append(cs.graph_step_ms(sess, big, big_lens))
        results["full_step_ms"] = ms
        say(f"  qwen3-8b bf16 full width, tp on 2x2, B=8 decode step in "
            f"turns: eager {ms['eager'][0]:.2f} / {ms['eager'][1]:.2f} ms, "
            f"from the graph {ms['graph'][0]:.2f} / {ms['graph'][1]:.2f} ms "
            f"[{cs.SMI}]", flush=True)
    say(json.dumps(results), flush=True)
    graphs.release_all()        # before NCCL destroys its communicators
    dist.barrier()
    dist.destroy_process_group()
    return 0 if all(v for v in results.values()
                    if isinstance(v, bool)) else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--limit", type=float, default=600.0,
                    help="seconds before the ranks are killed")
    ap.add_argument("--rank", type=int)
    ap.add_argument("--port", type=int)
    args = ap.parse_args()
    if args.rank is None:
        return launch(args)
    return rank_main(args)


if __name__ == "__main__":
    sys.exit(main())
