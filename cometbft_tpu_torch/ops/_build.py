"""Build and load the CUDA kernels: nvcc by hand into one shared library
with a plain C interface, loaded through ctypes.

The library is built at first use into ``build/`` at the repository
root, named by a hash of its sources, its headers and the flags, so an
edited source or header rebuilds and an unchanged one loads what is
there.  Each source compiles in its own nvcc process, all started
together, and one more nvcc links the objects into the library.
Nothing here runs at import; a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("ed25519_verify.cu", "ed25519_verify8.cu", "microbench.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# what the last build or load reported: path, seconds (wall, the
# compiles and the link), ptxas output
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
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for path in [_CSRC / s for s in SOURCES] + sorted(_CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc(args: list[str]) -> str:
    """Run nvcc; its merged output.  A failed run raises."""
    cmd = [nvcc_path(), *args]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}")
    return proc.stdout


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
    objs = [tmp.with_name(f"{tmp.name}.{Path(name).stem}.o")
            for name in SOURCES]
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            reports = list(pool.map(_nvcc, [
                [*COMPILE_FLAGS, "-c", "-o", str(obj), str(_CSRC / name)]
                for name, obj in zip(SOURCES, objs)]))
        _nvcc([*ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    ptxas = "".join(f"--- {name}\n{text}"
                    for name, text in zip(SOURCES, reports))
    log.write_text(ptxas)
    os.replace(tmp, out)
    build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                      cached=False, ptxas=ptxas)
    return out


def load() -> ctypes.CDLL:
    """The built library with its C signatures declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            verify_args = [ctypes.c_void_p] * 5 + [
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            for fn in (lib.ed25519_verify_launch, lib.ed25519_verify8_launch):
                fn.argtypes = verify_args
                fn.restype = ctypes.c_int
            lib.microbench_launch.argtypes = [
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            lib.microbench_launch.restype = ctypes.c_int
            lib.ed25519_error_string.argtypes = [ctypes.c_int]
            lib.ed25519_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
