"""Builds the host-side C and C++ sources under ``csrc/`` with the host's
compiler and binds them with ctypes.

Each library compiles at first use, never at import, into
``build/lib<name>-<hash>.so``, where the hash covers the source, the
compiler and its flags; ``.gitignore`` lists ``build/``. Several processes
(test workers) may ask for the same library at once: the build runs under
an exclusive lock on ``build/<name>.lock``, into a temporary file renamed
over the target, so a process sees a whole library or none. A build that
fails raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "build"

_libs: Dict[str, ctypes.CDLL] = {}


def _compiler(source: Path) -> str:
    name = os.environ.get("CXX" if source.suffix == ".cc" else "CC") or (
        "g++" if source.suffix == ".cc" else "cc")
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"no host compiler {name!r} to build {source.name}")
    return found


def library_path(source: str, flags: Sequence[str],
                 libs: Sequence[str] = ()) -> Path:
    """The built ``csrc/<source>`` as a shared library, built if missing."""
    src = CSRC / source
    command = [_compiler(src), *flags, "-shared", "-fPIC", str(src), *libs]
    digest = hashlib.sha256(" ".join(command).encode() + src.read_bytes())
    out = BUILD_ROOT / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"
    if out.is_file():
        return out
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with open(BUILD_ROOT / f"{src.stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.is_file():  # another process built it while we waited
            return out
        fd, tmp = tempfile.mkstemp(dir=BUILD_ROOT, suffix=".so.tmp")
        os.close(fd)
        try:
            proc = subprocess.run(command + ["-o", tmp], capture_output=True,
                                  text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"building {source} failed:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def load(source: str, flags: Sequence[str],
         libs: Sequence[str] = ()) -> ctypes.CDLL:
    """``library_path``'s library, loaded once per process."""
    lib = _libs.get(source)
    if lib is None:
        lib = _libs[source] = ctypes.CDLL(str(library_path(source, flags,
                                                            libs)))
    return lib
