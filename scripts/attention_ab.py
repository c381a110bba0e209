"""Time the attention kernels of two trees in one process tree, in turns.

    python3 scripts/attention_ab.py OTHER_TREE [--order ABBA]

Runs ``chip_smoke.timings``' attention cases (phase 6, without the scan
kernels and their tile sweep) once per letter of ``--order``: ``A`` is
OTHER_TREE (a checkout of another commit, for example unpacked with
``git archive`` into a directory ``.gitignore`` lists), ``B`` this tree.
Each run is its own process with that tree's ``src`` and ``chip_smoke``
first on the path, so both builds and both kernels are measured on the
same card in one call; each prints phase 6's lines.  Needs a CUDA card.
"""

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_tree(tree: str) -> None:
    sys.path[:0] = [os.path.join(tree, "src"), tree]
    import torch
    import chip_smoke
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        raise SystemExit("attention_ab: needs a CUDA card")
    t0 = time.perf_counter()
    _build.load_library()
    print(f"built in {time.perf_counter() - t0:.1f}s", flush=True)
    chip_smoke.scan_cases = lambda gen: []
    chip_smoke.tile_sweep = lambda gen: None
    chip_smoke.timings(torch.Generator(device="cuda").manual_seed(0))


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
