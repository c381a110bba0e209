"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: ``repro_torch`` starts with ``repro``), and
the plain references load nothing of the program."""

import subprocess
import sys
import textwrap

from conftest import ROOT

CHECK = textwrap.dedent("""
    import sys
    sys.path[:0] = [{src!r}, {root!r}]
    {body}
    top = {{k.split(".")[0] for k in sys.modules}}
    print(sorted(top & {{"jax", "jaxlib", "flax", "repro", "repro_torch"}}))
""")


def _loaded(body: str) -> str:
    code = CHECK.format(src=str(ROOT / "src"), root=str(ROOT), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_harness_and_every_file_it_loads_import_no_jax():
    body = textwrap.dedent("""
        from pathlib import Path
        from cnmt_bench.lib import harness
        import cnmt_bench.run, cnmt_bench.sweep, cnmt_bench.control
        for sub in ("metrics", "reference"):
            for f in sorted(Path({root!r}, "cnmt_bench", sub).glob("*.py")):
                harness.load_module(f)
    """).format(root=str(ROOT))
    assert _loaded(body) == "['repro_torch']"


def test_references_import_nothing_of_the_program():
    body = textwrap.dedent("""
        from pathlib import Path
        import importlib.util
        for f in sorted(Path({root!r}, "cnmt_bench", "reference")
                        .glob("*.py")):
            spec = importlib.util.spec_from_file_location(f.stem, f)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
    """).format(root=str(ROOT))
    assert _loaded(body) == "[]"
