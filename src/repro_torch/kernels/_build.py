"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C entry point and is compiled by
``nvcc`` for ``sm_90a`` into ``build/lib<name>-<hash>.so`` at the root of
the checkout, on first use; the hash is of the source, so an edited
source is rebuilt rather than a stale library loaded.  The library is
loaded with ``ctypes``.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

# No --use_fast_math: the kernels rely on IEEE division and precise log2.
# The sources include the shared headers of csrc/ (*.cuh).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(CSRC))

SOURCES = ("fake_quant", "quant_matmul", "flash_attention",
           "flash_attention_masked", "flash_attention_bwd",
           "flash_attention_wgmma", "flash_attention_bwd_wgmma",
           "flash_attention_bwd_wgmma_masked")


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source and
    of every shared header it may include."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(names=SOURCES) -> dict:
    """Compile every missing library in ``names``, one ``nvcc`` per source,
    all started together.  Returns ``{name: (seconds, compiler output)}``
    for the libraries it built; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, lib, time.perf_counter())
    built, failed = {}, []
    for name, (proc, tmp, lib, t0) in started.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{output}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half
        built[name] = (time.perf_counter() - t0, output)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return built


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (built first if missing)."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))
