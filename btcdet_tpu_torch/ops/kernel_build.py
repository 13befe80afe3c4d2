"""Build and load the package's native code.

Each `csrc/*.cu` file has a plain C interface (the `.cuh` headers beside
them hold device code they share) and is compiled by nvcc into its own
shared library under `build/kernels/` at the repository
root, at first use, then loaded with ctypes. Nothing here runs when a
module is imported: the CPU paths never need nvcc.

The host C++ of the data pipeline and the KITTI metric (`csrc/host/*.cpp`,
no CUDA) is built the same way by g++ (`load_host`); a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
HOST_SRC = CSRC / "host"
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# nvcc's output (including -Xptxas -v register/smem reports) per source
BUILD_LOGS: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """Missing, or older than its `.cu` or any shared `.cuh` header."""
    so = _lib_path(name)
    if not so.exists():
        return True
    srcs = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return so.stat().st_mtime < max(p.stat().st_mtime for p in srcs)


def _start(name: str) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.tmp_path = tmp
    return proc


def build(names) -> None:
    """Compile the named sources that are missing or older than their
    `.cu`, one nvcc process per source, all started together. Every
    process is waited for before a failure is raised."""
    with _LOCK:
        procs = [(n, _start(n)) for n in names if _stale(n)]
        failed = []
        for n, p in procs:
            BUILD_LOGS[n] = p.communicate()[0]
            if p.returncode == 0:
                os.replace(p.tmp_path, _lib_path(n))
            else:
                failed.append(n)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(f"{n}.cu:\n{BUILD_LOGS[n]}"
                                                               for n in failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/host/<name>.cpp`, built by g++ into
    `build/kernels/libhost_<name>.so` when missing or older than its source."""
    key = "host_" + name
    lib = _LIBS.get(key)
    if lib is not None:
        return lib
    with _LOCK:
        src, so = HOST_SRC / f"{name}.cpp", _lib_path(key)
        if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = BUILD_DIR / f"lib{key}.{os.getpid()}.tmp.so"
            cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
            r = subprocess.run([cxx, *GXX_FLAGS, str(src), "-o", str(tmp)],
                               capture_output=True, text=True)
            BUILD_LOGS[key] = r.stdout + r.stderr
            if r.returncode != 0:
                raise RuntimeError(f"g++ failed for {src.name}:\n{BUILD_LOGS[key]}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        _LIBS[key] = lib
    return lib
