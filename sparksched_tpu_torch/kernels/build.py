"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source `csrc/<name>.cu` becomes `_build/lib<name>-<digest>.so`
(the digest covers the source, the `csrc/` headers it includes and the
flags, so an edited source or header is rebuilt). Nothing is built when
a module is imported: the first launch builds, or `build_all()` builds
every source with one nvcc process per source, all started together.
The build directory is listed in `.gitignore`."""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("bulk_events", "decima_encoder", "decima_encoder_bwd", "rbg_philox",
           "threefry")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels build only on a "
            "machine with the CUDA toolkit"
        )
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(path: str, seen: dict) -> None:
    """`path` and every `csrc/` file it includes, recursively, into
    `seen` (path -> bytes)."""
    if path in seen:
        return
    with open(path, "rb") as f:
        seen[path] = f.read()
    for inc in _INCLUDE.findall(seen[path]):
        _sources(os.path.join(CSRC, inc.decode()), seen)


def _lib_path(name: str) -> str:
    seen: dict[str, bytes] = {}
    _sources(os.path.join(CSRC, f"{name}.cu"), seen)
    digest = hashlib.sha256(b"".join(seen.values())
                            + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _start(name: str):
    """Start nvcc for one source into a temporary file; returns
    (process, tmp path, final path) or None when already built."""
    final = _lib_path(name)
    if os.path.exists(final):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, final


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, final = started
    out, _ = proc.communicate()
    build_log[name] = out
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, final)


def build_all(names=SOURCES) -> None:
    """Compile every source, one nvcc process each, all in parallel."""
    with _lock:
        started = {n: _start(n) for n in names}
        for n in names:
            _finish(n, started[n])


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building it first if
    needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(_lib_path(name))
            _loaded[name] = lib
        return lib
