"""Builds the CUDA sources under ``csrc/`` and binds them with ctypes.

Each ``csrc/*.cu`` file becomes one shared library with a plain C interface
(every pointer and the stream as ``void*``, sizes as ``int``), compiled by
``nvcc`` for ``sm_90a`` at first use into ``build/<hash>/``, where the hash
covers the sources and the flags. All sources compile at once, one ``nvcc``
process each. Nothing here runs at import: the CPU tests import every module
and a CPU-only host has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, object] = {}
build_seconds = 0.0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file():
            return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    """Directory holding one ``lib<name>.so`` per source, built if missing."""
    global build_seconds
    out = BUILD_ROOT / _digest()
    if out.is_dir():
        return out
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    nvcc = _nvcc()
    start = time.perf_counter()
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        with open(tmp / f"{src.stem}.log", "w") as log:
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp / f"lib{src.stem}.so"),
                 str(src)], stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, proc in procs:
        if proc.wait() != 0:
            failed.append(f"{src.name}:\n"
                          + (tmp / f"{src.stem}.log").read_text())
    build_seconds = time.perf_counter() - start
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    try:
        tmp.rename(out)
    except OSError:  # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def function(lib_name: str, fn_name: str, argtypes: Sequence):
    """The C function ``fn_name`` of ``lib<lib_name>.so``, typed, returning
    the CUDA error code of its launch."""
    fn = _fns.get((lib_name, fn_name))
    if fn is not None:
        return fn
    lib = _libs.get(lib_name)
    if lib is None:
        lib = ctypes.CDLL(str(build_dir() / f"lib{lib_name}.so"))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _libs[lib_name] = lib
    fn = getattr(lib, fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    _fns[(lib_name, fn_name)] = fn
    return fn


def check(lib_name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = _libs[lib_name].kernel_error_string(err).decode()
        raise RuntimeError(f"{lib_name} launch failed: CUDA error {err} ({msg})")
