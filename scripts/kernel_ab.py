"""Time kernels of two trees in one process tree, in turns.

    python3 scripts/kernel_ab.py OTHER_TREE [--order ABBA]
        [--kernels attention|scans|all]

Runs ``chip_smoke.py``'s phase-6 cases of the chosen kernels once per
letter of ``--order``: ``A`` is OTHER_TREE (a checkout of another commit,
for example unpacked with ``git archive`` into a directory ``.gitignore``
lists), ``B`` this tree.  ``attention``: ``chip_smoke.timings``' attention
cases; ``scans``: ``chip_smoke.scan_cases`` (``rwkv6_wkv`` and
``ssd_scan``), each row with the plan's kernel and, where the tree has
more than one, every path; ``all``: both.  Each run is its own process
with that tree's ``src`` and ``chip_smoke`` first on the path, so both
builds and both kernels are measured on the same card in one call; each
prints its rows.  Needs a CUDA card.
"""

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("attention", "scans", "all")


def scan_line(name: str, r: dict) -> str:
    """One scan row in phase 6's words, from the keys every tree's
    ``scan_cases`` rows carry (``paths`` only where the tree has them)."""
    paths = ("" if "paths" not in r else "; paths " + ", ".join(
        f"{p} {ms:.5f}ms" for p, ms in r["paths"].items())
        + f" (plan: {r['plan']})")
    return (f"  {name} {r['shape']}: device {r['ms']:.5f}ms, eager "
            f"{r['eager_ms']:.5f}ms, bound {r['bound_ms']:.5f}ms by "
            f"{r['bound_by']}, plain {r['plain_ms']:.5f}ms (kernel vs plain "
            f"{r['max_abs_err']:.2e}){paths}")


def run_tree(tree: str, kernels: str) -> None:
    sys.path[:0] = [os.path.join(tree, "src"), tree]
    import torch
    import chip_smoke
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    t0 = time.perf_counter()
    _build.load_library()
    print(f"built in {time.perf_counter() - t0:.1f}s; {chip_smoke.smi_line()}",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if kernels in ("attention", "all"):
        scan_cases = chip_smoke.scan_cases
        chip_smoke.scan_cases = lambda gen: []
        chip_smoke.tile_sweep = lambda gen: None   # trees that still have it
        chip_smoke.timings(gen)
        chip_smoke.scan_cases = scan_cases
    if kernels in ("scans", "all"):
        for name, r in chip_smoke.scan_cases(gen):
            print(scan_line(name, r), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", help="the other tree (A)")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--kernels", choices=KERNELS, default="all")
    ap.add_argument("--run", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        run_tree(args.run, args.kernels)
        return 0
    trees = {"A": os.path.abspath(args.other), "B": HERE}
    rc = 0
    for letter in args.order:
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            args.other, "--kernels", args.kernels,
                            "--run", trees[letter]],
                           capture_output=True, text=True, timeout=900)
        print(f"=== {letter} {trees[letter]} rc={p.returncode} "
              f"{time.perf_counter() - t0:.0f}s\n{p.stdout}{p.stderr[-2000:]}",
              flush=True)
        rc = rc or p.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
