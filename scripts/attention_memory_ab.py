"""Peak memory and time of long-sequence attention on two trees, in turns.

    python3 scripts/attention_memory_ab.py OTHER_TREE [--order ABBA]

``A`` is OTHER_TREE (a checkout of another commit, for example unpacked
with ``git archive`` into a directory ``.gitignore`` lists), ``B`` this
tree.  Each letter of ``--order`` runs in its own process with that
tree's ``src`` as the port and this tree's ``chip_smoke.py`` as the
measurement code, so both ports run the same measurements on the same
card in one call:

* qwen3-8b at full width cut to 4 of 36 layers in bf16 (float32
  moments), 3 train steps at B=1 S=4096 (train_4k's length), eager and
  then from ``compile_train_step``'s graph (``chip_smoke.long_train_runs``):
  the first loss, the mean ms of steps 2-3 and the peak memory;
* deepseek-v3-671b cut as ``chip_smoke.py`` phase 14 cuts it (3 MLA
  layers and 1 MoE layer, float32, 60 GB), a B=1 S=4096 prefill twice
  (``chip_smoke.long_prefill``): the ms of each, the peak memory, or the
  out-of-memory error it hit.

Each process prints ``nvidia-smi``'s name and power limit and its lines.
Needs one CUDA card with 80 GB.
"""

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_tree(tree: str) -> None:
    # the port first, from ``tree``; chip_smoke (from this tree) then puts
    # its own src on the path, after the port's modules are bound
    sys.path[:0] = [os.path.join(tree, "src"), HERE]
    import torch
    import repro_torch
    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("attention_memory_ab: needs a CUDA card")
    print(f"port {os.path.dirname(repro_torch.__file__)}; "
          f"{cs.smi_line()}", flush=True)
    cfg = cs.cut_config("qwen3-8b", (cs.BT_CUT,))
    try:
        for mode, (loss, ms, peak) in cs.long_train_runs(cfg).items():
            print(f"  qwen3-8b ({cs.BT_CUT} of 36 layers) bf16 train step "
                  f"B=1 S={cs.LONG_S}, {mode}: first loss {loss!r}, "
                  f"{ms:.2f} ms a step (steps 2-3), peak "
                  f"{peak / 2**30:.2f} GiB", flush=True)
    except torch.cuda.OutOfMemoryError as e:
        print(f"  qwen3-8b train step B=1 S={cs.LONG_S}: OUT OF MEMORY: "
              f"{str(e).splitlines()[0]}", flush=True)
    cs.empty_cache()
    name = "deepseek-v3-671b"
    model, _ = cs.build_cut(cs.cut_config(name, **cs.MOE_CUTS[name]))
    print(cs.long_prefill_line(f"{name} ({model.cfg.num_layers} layers)",
                               cs.long_prefill(model)), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", help="the other tree (A)")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--run", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        run_tree(args.run)
        return 0
    trees = {"A": os.path.abspath(args.other), "B": HERE}
    rc = 0
    for letter in args.order:
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            args.other, "--run", trees[letter]],
                           capture_output=True, text=True, timeout=900)
        print(f"=== {letter} {trees[letter]} rc={p.returncode} "
              f"{time.perf_counter() - t0:.0f}s\n{p.stdout}{p.stderr[-2000:]}",
              flush=True)
        rc = rc or p.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
