"""Build and load the CUDA kernels: nvcc by hand into a shared library
with a plain C interface, loaded through ctypes.

The library is built at first use into ``build/`` at the repository
root, named by a hash of its sources and flags, so an edited source
rebuilds and an unchanged one loads what is there.  Nothing here runs
at import; a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("ed25519_verify.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# what the last build or load reported: path, seconds, ptxas output
build_info: dict = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (if this hash is not built yet); return the
    library's path.  Writes the ptxas report beside it."""
    out = BUILD_DIR / f"cometbft_kernels-{_source_key()}.so"
    log = out.with_suffix(".log")
    if out.is_file():
        build_info.update(path=str(out), seconds=0.0, cached=True,
                          ptxas=log.read_text() if log.is_file() else "")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(_CSRC / s) for s in SOURCES]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    build_info.update(path=str(out), seconds=seconds, cached=False,
                      ptxas=proc.stdout + proc.stderr)
    return out


def load() -> ctypes.CDLL:
    """The built library with its C signatures declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.ed25519_verify_launch.argtypes = [ctypes.c_void_p] * 5 + [
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            lib.ed25519_verify_launch.restype = ctypes.c_int
            lib.ed25519_error_string.argtypes = [ctypes.c_int]
            lib.ed25519_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
