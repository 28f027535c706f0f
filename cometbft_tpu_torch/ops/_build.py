"""Build and load the port's native libraries, each with a plain C
interface, loaded through ctypes.

  * the CUDA kernels: nvcc by hand into one shared library.  Each source
    compiles in its own nvcc process, all started together, and one
    more nvcc links the objects into the library;
  * the host prep (``ed25519_prep.cpp``), the host BLS12-381
    arithmetic (``bls_native.cpp``), the host ed25519 sign and single
    verify (``ed25519_host.cpp``) and the secret connection's
    ChaCha20-Poly1305 (``chacha20poly1305.cpp``): g++, each into a
    library of its own, so they build and run where there is no nvcc.
    No ``-march=native``: the multi-buffer SHA-512 and SHA-NI paths
    carry their own ``target(...)`` attributes and check the CPU at run
    time.  The BLS, ed25519 and AEAD libraries run their self-tests
    once a load and raise if one fails.

Each library is built at first use into ``build/`` at the repository
root, named by a hash of its sources, its headers and the flags, so an
edited source or header rebuilds and an unchanged one loads what is
there.  Nothing here runs at import; a failed build raises.
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
HOST_SOURCE = "ed25519_prep.cpp"
BLS_SOURCE = "bls_native.cpp"
ED25519_HOST_SOURCE = "ed25519_host.cpp"
AEAD_SOURCE = "chacha20poly1305.cpp"
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_host_lock = threading.Lock()
_bls_lock = threading.Lock()
_ed25519_host_lock = threading.Lock()
_aead_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_host_lib: ctypes.CDLL | None = None
_bls_lib: ctypes.CDLL | None = None
_ed25519_host_lib: ctypes.CDLL | None = None
_aead_lib: ctypes.CDLL | None = None
# what the last build or load reported: path, seconds (wall, the
# compiles and the link), ptxas output
build_info: dict = {}
# the same for the host libraries: path, seconds (g++ wall), cached
host_build_info: dict = {}
bls_build_info: dict = {}
ed25519_host_build_info: dict = {}
aead_build_info: dict = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _key(flags, paths) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for path in paths:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _source_key() -> str:
    return _key(COMPILE_FLAGS, [_CSRC / s for s in SOURCES] +
                sorted(_CSRC.glob("*.cuh")))


def _run(cmd: list[str]) -> str:
    """Run a compiler; its merged output.  A failed run raises."""
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(cmd[0]).name} failed ({proc.returncode}):"
                           f"\n{' '.join(cmd)}\n{proc.stdout}")
    return proc.stdout


def _nvcc(args: list[str]) -> str:
    return _run([nvcc_path(), *args])


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


def _build_host_library(source: str, stem: str, info: dict) -> Path:
    """Compile one host source with g++ (if this hash is not built yet);
    return the library's path."""
    key = _key(HOST_FLAGS, [_CSRC / source, *sorted(_CSRC.glob("*.hpp"))])
    out = BUILD_DIR / f"{stem}-{key}.so"
    if out.is_file():
        info.update(path=str(out), seconds=0.0, cached=True)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        _run(["g++", *HOST_FLAGS, "-o", str(tmp), str(_CSRC / source)])
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    info.update(path=str(out), seconds=time.perf_counter() - t0,
                cached=False)
    return out


def build_host() -> Path:
    """The host prep's library, built at first use."""
    return _build_host_library(HOST_SOURCE, "cometbft_prep", host_build_info)


def build_bls() -> Path:
    """The host BLS library, built at first use."""
    return _build_host_library(BLS_SOURCE, "cometbft_bls", bls_build_info)


def build_ed25519_host() -> Path:
    """The host ed25519 library, built at first use."""
    return _build_host_library(ED25519_HOST_SOURCE, "cometbft_ed25519",
                               ed25519_host_build_info)


def build_aead() -> Path:
    """The host ChaCha20-Poly1305 library, built at first use."""
    return _build_host_library(AEAD_SOURCE, "cometbft_aead", aead_build_info)


def load_host() -> ctypes.CDLL:
    """The built host library with its C signatures declared."""
    global _host_lib
    with _host_lock:
        if _host_lib is None:
            lib = ctypes.CDLL(str(build_host()))
            lib.ed25519_prep.argtypes = (
                [ctypes.c_char_p] * 3 + [ctypes.c_void_p] * 2 +
                [ctypes.c_int64] * 2 + [ctypes.c_char_p] * 2 +
                [ctypes.c_void_p] * 5)
            lib.ed25519_prep.restype = ctypes.c_int
            lib.ed25519_prep_threads.argtypes = [ctypes.c_int64]
            lib.ed25519_prep_threads.restype = ctypes.c_int
            lib.ed25519_prep_multibuffer.argtypes = []
            lib.ed25519_prep_multibuffer.restype = ctypes.c_int
            _host_lib = lib
        return _host_lib


def load_bls() -> ctypes.CDLL:
    """The built BLS library with its C signatures declared, after its
    self-test passed (once a load); a failed self-test raises."""
    global _bls_lib
    with _bls_lock:
        if _bls_lib is None:
            lib = ctypes.CDLL(str(build_bls()))
            ptr, i64 = ctypes.c_char_p, ctypes.c_int64
            buf = ctypes.c_void_p
            for name, args in (
                    ("bls_selftest", []),
                    ("bls_pairings_product_is_one", [ptr, buf, ptr, buf, i64]),
                    ("bls_g1_in_subgroup", [ptr, i64]),
                    ("bls_g2_in_subgroup", [ptr, i64]),
                    ("bls_hash_to_g2", [ptr, i64, ptr, i64, buf]),
                    ("bls_g1_uncompress", [ptr, buf]),
                    ("bls_g2_uncompress", [ptr, buf]),
                    ("bls_g1_mul", [ptr, i64, ptr, i64, buf]),
                    ("bls_g2_mul", [ptr, i64, ptr, i64, buf]),
                    ("bls_g1_sum", [ptr, i64, buf]),
                    ("bls_g2_sum", [ptr, i64, buf])):
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            t0 = time.perf_counter()
            if lib.bls_selftest() != 1:
                raise RuntimeError(
                    f"the BLS library failed its self-test: "
                    f"{bls_build_info.get('path')}")
            bls_build_info["selftest_seconds"] = time.perf_counter() - t0
            _bls_lib = lib
        return _bls_lib


def load_ed25519_host() -> ctypes.CDLL:
    """The built host ed25519 library with its C signatures declared,
    after its self-test passed (once a load); a failed build or
    self-test raises."""
    global _ed25519_host_lib
    with _ed25519_host_lock:
        if _ed25519_host_lib is None:
            lib = ctypes.CDLL(str(build_ed25519_host()))
            ptr, i64 = ctypes.c_char_p, ctypes.c_int64
            buf = ctypes.c_void_p
            for name, args in (
                    ("ed25519_host_selftest", []),
                    ("ed25519_host_public_key", [ptr, buf]),
                    ("ed25519_host_sign", [ptr, ptr, ptr, i64, buf]),
                    ("ed25519_host_verify", [ptr, ptr, i64, ptr])):
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            t0 = time.perf_counter()
            if lib.ed25519_host_selftest() != 1:
                raise RuntimeError(
                    f"the host ed25519 library failed its self-test: "
                    f"{ed25519_host_build_info.get('path')}")
            ed25519_host_build_info["selftest_seconds"] = \
                time.perf_counter() - t0
            _ed25519_host_lib = lib
        return _ed25519_host_lib


def load_aead() -> ctypes.CDLL:
    """The built ChaCha20-Poly1305 library with its C signatures
    declared, after its self-test (the RFC 8439 section 2.8.2 vector)
    passed, once a load; a failed build or self-test raises."""
    global _aead_lib
    with _aead_lock:
        if _aead_lib is None:
            lib = ctypes.CDLL(str(build_aead()))
            ptr, i64 = ctypes.c_char_p, ctypes.c_int64
            for name, args in (
                    ("aead_selftest", []),
                    ("aead_seal", [ptr, ptr, ptr, i64, ptr, i64,
                                   ctypes.c_void_p]),
                    ("aead_open", [ptr, ptr, ptr, i64, ptr, i64,
                                   ctypes.c_void_p])):
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            t0 = time.perf_counter()
            if lib.aead_selftest() != 1:
                raise RuntimeError(
                    f"the ChaCha20-Poly1305 library failed its self-test: "
                    f"{aead_build_info.get('path')}")
            aead_build_info["selftest_seconds"] = time.perf_counter() - t0
            _aead_lib = lib
        return _aead_lib
