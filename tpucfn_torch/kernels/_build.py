"""Builds the port's CUDA sources into shared libraries and loads them.

Each source ``csrc/<name>.cu`` has a plain C interface and is compiled
with ``nvcc`` for ``sm_90a`` into ``_build/<name>-<hash>.so`` (the
directory is git-ignored), at first use, keyed on a hash of the source,
the shared headers ``csrc/*.cuh`` and the flags: an edited source
rebuilds, an unchanged one loads what is there.  Libraries are loaded
with ``ctypes``.  Nothing here runs at import time — the CPU tests import
every module of the package.

With a kernel-library cache installed (the fleet warm start,
:mod:`tpucfn_torch.compilecache.kernels`, which the training loop and the
serve CLI configure from ``TPUCFN_COMPILE_CACHE_ADDRS`` /
``TPUCFN_COMPILE_CACHE_DIR``), :func:`load` takes a library that is not in
the directory yet from the artifact store or the fleet before it builds
one.  Without one it builds and loads as above.  Each library has a lock
of its own: a fetch or a build never holds up the loading of another.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-ldl")

_lock = threading.Lock()  # guards _locks
_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}
nvcc_runs = 0  # nvcc processes started in this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(*names: str) -> dict[str, str]:
    """Compile every named source that has no library yet, one ``nvcc``
    process per source, all started together.  Returns each compiler's
    output (register and shared-memory use from ``-Xptxas -v``); raises
    if any build fails."""
    global nvcc_runs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
        with _lock:
            nvcc_runs += 1
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{logs[name]}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``: through the installed
    kernel-library cache when there is one, else built first if needed."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _loaded.get(name)
        if lib is None:
            from tpucfn_torch.compilecache.kernels import installed

            cache = installed()
            if cache is not None:
                lib = cache.load(name)
            else:
                build(name)
                lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
