"""Build the port's CUDA kernels from ``csrc/`` and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use by ``nvcc`` for Hopper (``-gencode arch=compute_90a,code=sm_90a``)
into ``csrc/_build/lib<name>-<hash>.so``; the hash is of the source and the
shared ``*.cuh`` headers, so an edited source rebuilds and an unchanged one
loads from the cache. Nothing
is built at import time.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Iterable

CSRC_DIR = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# what ptxas reported per kernel (registers, shared memory, spills)
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "bert4rec_tpu_torch are built on a CUDA machine")


def _lib_path(name: str) -> pathlib.Path:
    """The library's path, keyed by a hash of its source and of every
    shared header under ``csrc/``."""
    sha = hashlib.sha1((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        sha.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{sha.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> None:
    """Compile every named source that has no cached library, all
    ``nvcc`` processes started together; raises if any build fails."""
    todo = [n for n in names if not _lib_path(n).is_file()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or none
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The compiled library for ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return _libs[name]


def kernel_sources() -> list:
    """Every CUDA source of the port (names without the ``.cu``)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
