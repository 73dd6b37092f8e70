"""Build the CUDA sources of ``csrc/`` into plain-C shared libraries and
load them.

nvcc compiles for ``sm_90a`` into ``neuralstyletransferv1_torch/_build/``
(gitignored) at first use; the file name carries a hash of the source, the
headers of ``csrc/`` and the flags, so an edited source or header rebuilds
and an unchanged one is reused.
``build`` compiles several sources at once, one nvcc process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(source: str) -> tuple[Path, Path]:
    src = CSRC / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return src, BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build(sources) -> None:
    """Compile every ``csrc/`` source of ``sources`` that is not built yet,
    one nvcc process each, all started together."""
    jobs = []
    for source in sources:
        src, out = _target(source)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(src)]
        jobs.append((src, out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, out, tmp, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {src.name}:\n{log}")
            continue
        os.replace(tmp, out)
        (BUILD_DIR / f"{src.stem}.ptxas.txt").write_text(log)
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` (once) and return the loaded library."""
    if source in _LIBS:
        return _LIBS[source]
    build([source])
    lib = ctypes.CDLL(str(_target(source)[1]))
    _LIBS[source] = lib
    return lib
