"""Build the port's CUDA kernels with nvcc and load them through ctypes.

The sources under ``csrc/`` have a plain C interface.  At first use each
``.cu`` file is compiled for ``sm_90a`` by its own ``nvcc`` process (all
started together), and the objects are linked into one shared library
under ``build/repro_torch_kernels/`` at the repository root, named by a
hash of the sources and flags, so a changed source rebuilds and an
unchanged one loads at once.  Nothing here runs at import: the CPU path
never needs ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("flash_attention.cu", "decode_attention.cu", "rwkv6_wkv.cu",
           "ssd_scan.cu")
HEADERS = ("mma_common.cuh", "wgmma_common.cuh")   # included by the sources
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas=-v", "-Xcompiler", "-fPIC")

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# argument types of the C entry points (see the .cu files)
_SIGNATURES = {
    "repro_flash_attention": [_P] * 5 + [_I] * 7 + [_I64] * 12
                             + [_F, _I, _I, _I, _P],
    "repro_flash_decode": [_P] * 10 + [_I] * 8 + [_I64] * 10
                          + [_F, _I, _I, _P],
    "repro_rwkv6_wkv": [_P] * 8 + [_I] * 4 + [_I64] * 15 + [_P],
    "repro_ssd_scan": [_P] * 8 + [_I] * 7 + [_I64] * 15 + [_P],
    "repro_ssd_scan_ws": [_P] * 8 + [_I] * 5 + [_I64] * 15 + [_P],
}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    home_nvcc = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc")
    if path is None and home_nvcc.exists():
        path = str(home_nvcc)
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels cannot be built (put the CUDA "
            "toolkit's bin directory on PATH or set CUDA_HOME)")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"


def _build(lib_path: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (Path(s).stem + ".o") for s in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [f"{src}:\n{log}" for src, p, log in zip(SOURCES, procs, logs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, NVCC_FLAGS[0], "-shared", "-o", str(tmp_lib),
             *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        (BUILD_DIR / "ptxas.log").write_text("\n".join(logs))
        # atomic: a concurrent builder sees no file or a whole one
        os.replace(tmp_lib, lib_path)


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built first if it is missing.

    Raises ``RuntimeError`` when ``nvcc`` is absent or the build fails.
    """
    lib_path = library_path()
    if not lib_path.exists():
        _build(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc}")
