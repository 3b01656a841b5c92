"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C function and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with ctypes. The
libraries go to ``build/cookietts_tpu_torch/<hash>/`` at the root of the
checkout, keyed by a hash of the sources and flags, so a changed source is
rebuilt and an unchanged one is reused. All sources compile in parallel, one
``nvcc`` process each. A failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "cookietts_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_SECONDS = 0.0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def load_all() -> Dict[str, ctypes.CDLL]:
    """Compile (if needed) and load every kernel library; returns them by
    source name. The compiler's register/shared-memory report is written
    next to each library as ``<name>.log``."""
    global BUILD_SECONDS
    if _LIBS:
        return _LIBS
    t0 = time.perf_counter()
    out = _build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sorted(CSRC.glob("*.cu")):
        lib = out / f"lib{src.stem}.so"
        if lib.exists():
            continue
        tmp = out / f"lib{src.stem}.{os.getpid()}.tmp.so"
        log = open(out / f"{src.stem}.log", "w")
        procs[src.stem] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)],
            stdout=log, stderr=subprocess.STDOUT), tmp, lib, log)
    failed = []
    for name, (proc, tmp, lib, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name}:\n{(out / f'{name}.log').read_text()}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for src in sorted(CSRC.glob("*.cu")):
        _LIBS[src.stem] = ctypes.CDLL(str(out / f"lib{src.stem}.so"))
    BUILD_SECONDS = time.perf_counter() - t0
    return _LIBS


def library(name: str) -> ctypes.CDLL:
    return load_all()[name]
