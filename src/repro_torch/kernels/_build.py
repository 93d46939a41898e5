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
           "flash_attention_masked", "flash_attention_fp8",
           "flash_attention_bwd", "flash_attention_wgmma",
           "flash_attention_bwd_wgmma", "flash_attention_bwd_wgmma_masked")


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


# name -> (thread, result) of the builds in flight (``start``); the thread
# waits for its nvcc and fills result with (seconds, compiler output,
# return code)
_running: dict = {}


def start(names=SOURCES) -> None:
    """Start one ``nvcc`` for each missing library of ``names``, all
    together, and return at once: ``wait`` (or ``load``) collects them."""
    import threading
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in names:
        lib = library_path(name)
        if lib.exists() or name in _running:
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        result: list = []

        def collect(proc=proc, tmp=tmp, lib=lib, result=result,
                    t0=time.perf_counter()):
            output, _ = proc.communicate()
            if proc.returncode == 0:
                os.replace(tmp, lib)  # atomic: a loader never sees half
            result.append((time.perf_counter() - t0, output,
                           proc.returncode))

        thread = threading.Thread(target=collect, daemon=True)
        thread.start()
        _running[name] = (thread, result)


def wait(names=SOURCES) -> dict:
    """Wait for the builds of ``names`` in flight.  Returns ``{name:
    (seconds, compiler output)}`` for the libraries they built, each
    build's own seconds; raises if any build failed."""
    built, failed = {}, []
    for name in names:
        if name not in _running:
            continue
        thread, result = _running.pop(name)
        thread.join()
        secs, output, rc = result[0]
        if rc != 0:
            failed.append(f"{name}:\n{output}")
            continue
        built[name] = (secs, output)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return built


def build(names=SOURCES) -> dict:
    """Compile every missing library in ``names``, one ``nvcc`` per source,
    all started together, and wait for them (``start``, ``wait``)."""
    start(names)
    return wait(names)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (built first if missing, or waited for
    if ``start`` is building it)."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))
