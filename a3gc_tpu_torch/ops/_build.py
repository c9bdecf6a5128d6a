r"""Build the port's CUDA sources with nvcc into a shared library with a
plain C interface, and load it with ctypes.

The library is built at first use into :func:`build_dir`, named by a hash
of the source, every header in ``csrc/`` and the flags
(:func:`library_digest`), so that an edited source or header is never
served by a stale build. The directory is ``$A3GC_TORCH_BUILD_DIR`` where
that is set, else ``build/kernels/`` two directories above the package:
the repository root in a checkout (``build/`` is git-ignored there),
beside ``site-packages`` in an install, which had better set the
variable. Nothing here runs at import: the CPU-only test machines have no
nvcc.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

__all__ = ["load_library", "library_digest", "build_dir", "NVCC_FLAGS"]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

BUILD_DIR_ENV = "A3GC_TORCH_BUILD_DIR"

_lock = threading.Lock()      # guards _name_locks
_name_locks = {}              # one lock per library: builds run in parallel
_loaded = {}


def build_dir() -> str:
    r"""Where the kernel libraries are built and looked up:
    ``$A3GC_TORCH_BUILD_DIR`` where it is set (read at each build, so a
    caller may set it before the first launch), else ``BUILD_DIR``."""
    return os.path.abspath(os.environ.get(BUILD_DIR_ENV) or BUILD_DIR)


class BuiltLibrary:
    r"""A loaded kernel library with what its build reported."""

    def __init__(self, lib: ctypes.CDLL, build_seconds: float, log: str):
        self.lib = lib
        self.build_seconds = build_seconds   # 0.0 when an earlier build was reused
        self.log = log                       # nvcc's -Xptxas -v report


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def library_digest(name: str, csrc: str = _CSRC) -> str:
    r"""Hash of ``csrc/<name>.cu``, every ``csrc/*.cuh`` (by name and
    content, in name order) and the nvcc flags."""
    h = hashlib.sha1()
    for path in [os.path.join(csrc, name + ".cu")] + sorted(
            glob.glob(os.path.join(csrc, "*.cuh"))):
        h.update(os.path.basename(path).encode() + b"\0")
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load_library(name: str) -> BuiltLibrary:
    r"""Build (once per source version) and load ``csrc/<name>.cu``.
    Raises if nvcc is missing or the build fails. Different libraries
    build concurrently when called from several threads."""
    with _lock:
        lock = _name_locks.setdefault(name, threading.Lock())
    with lock:
        if name in _loaded:
            return _loaded[name]
        src = os.path.join(_CSRC, name + ".cu")
        digest = library_digest(name)
        out_dir = build_dir()
        os.makedirs(out_dir, exist_ok=True)
        out = os.path.join(out_dir, f"{name}_{digest}.so")
        log_path = out + ".log"
        seconds = 0.0
        if not os.path.isfile(out):
            nvcc = _nvcc()
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed building {src} (exit {proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}")
            with open(log_path, "w") as f:
                f.write(proc.stdout + proc.stderr)
            os.replace(tmp, out)      # atomic: concurrent builds agree
        log = ""
        if os.path.isfile(log_path):
            with open(log_path) as f:
                log = f.read()
        built = BuiltLibrary(ctypes.CDLL(out), seconds, log)
        _loaded[name] = built
        return built
