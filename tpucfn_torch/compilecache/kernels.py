"""The fleet cache of the port's kernel libraries (the counterpart of
``tpucfn/compilecache/jit.py``).

The JAX package caches compiled XLA executables; the port compiles no
programs, it builds one shared library per CUDA source with ``nvcc``
(:mod:`tpucfn_torch.kernels._build`), and that build is what every fresh
host repays.  With a cache configured (``TPUCFN_COMPILE_CACHE_ADDRS``
and/or ``TPUCFN_COMPILE_CACHE_DIR``, as ``configure_from_env`` reads
them), :func:`tpucfn_torch.kernels._build.load` asks
:meth:`KernelLibraryCache.load` for a library, in this order:

1. a library already in the kernel directory (``kernels/_build/``) loads
   as it always did: ``compile_cached``;
2. otherwise :meth:`CompileCacheClient.get_or_compile` takes it from the
   local artifact store (``compile_cached``) or fetches it from the
   fleet's artifact server (``compile_fetched``);
3. otherwise it claims the key, builds with ``nvcc`` and publishes
   (``compile``): a cold fleet builds each library once.

The key is the library's own digest (its source, the shared headers and
the flags: :func:`tpucfn_torch.kernels._build.library_path`) with the
card's name and compute capability and the toolchain.  The handshake's
identity is the card's name (``device_kind``) and, in the slot the JAX
package fills with its jax version, :func:`toolchain_identity`: torch,
its CUDA runtime and ``nvcc --version``.

A failed, corrupt or stalled fetch falls back to building the same source
with ``nvcc``, never to the plain PyTorch version: the caller gets the
same library either way.  A fetched library is written tmp-then-rename
into the kernel directory and opened with ``ctypes``; one that will not
open is quarantined like a corrupt entry and rebuilt.

TRUST MODEL: opening a library runs its initialisers, so a fetched
library is code the fleet runs, as a pickled executable is in the JAX
package.  The sha256 checks prove that the bytes arrived as published,
not who published them: the artifact server and the store directories
must live on the cluster's private network and filesystem, reachable
only by fleet members.  Do not point ``TPUCFN_COMPILE_CACHE_ADDRS`` at
an untrusted server or ``TPUCFN_COMPILE_CACHE_DIR`` at a world-writable
path on a shared machine.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable

from tpucfn_torch.compilecache.service import (COMPILE_CACHE_DIR_ENV,
                                               CompileCacheClient,
                                               cache_addrs_from_env)
from tpucfn_torch.compilecache.store import (ArtifactStore, cache_key,
                                             default_store_dir)

_default: "KernelLibraryCache | None" = None
_default_lock = threading.Lock()


def toolchain_identity() -> str:
    """torch, its CUDA runtime and the release line of ``nvcc --version``:
    what a library built here depends on beyond its source."""
    import torch

    release = "none"
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        from torch.utils.cpp_extension import CUDA_HOME

        cand = Path(CUDA_HOME or "") / "bin" / "nvcc"
        nvcc = str(cand) if CUDA_HOME and cand.exists() else None
    if nvcc is not None:
        try:
            out = subprocess.run([nvcc, "--version"], capture_output=True,
                                 text=True, timeout=30).stdout
            release = next((line.strip() for line in out.splitlines()
                            if "release" in line), out.strip()[-80:])
        except (OSError, subprocess.SubprocessError):
            release = "unknown"
    return f"torch {torch.__version__}; cuda {torch.version.cuda}; nvcc {release}"


def device_identity() -> tuple[str, str]:
    """(card name, ``sm_<major><minor>``) of the current CUDA device."""
    import torch

    major, minor = torch.cuda.get_device_capability()
    return torch.cuda.get_device_name(), f"sm_{major}{minor}"


class KernelLibraryCache:
    """Kernel directory, then artifact store and fleet, then ``nvcc``.

    ``build_fn(name)`` builds ``csrc/<name>.cu`` into its library path
    (:func:`tpucfn_torch.kernels._build.build`); ``open_fn(path)`` opens
    a library (``ctypes.CDLL``).  Both are injectable, so the CPU tests
    drive the whole protocol with a counting builder and no card."""

    def __init__(self, client: CompileCacheClient, *, arch: str,
                 build_fn: Callable[[str], object] | None = None,
                 open_fn: Callable[[str], object] = ctypes.CDLL,
                 library_path: Callable[[str], Path] | None = None):
        from tpucfn_torch.kernels import _build

        self.client = client
        self.arch = arch
        self.build_fn = build_fn or (lambda name: _build.build(name))
        self.open_fn = open_fn
        self.library_path = library_path or _build.library_path
        self.dir_hits_c = client.registry.counter(
            "compilecache_kernel_dir_hits_total",
            "kernel libraries already in the local kernel directory")

    def key(self, name: str) -> str:
        """The cache key of ``csrc/<name>.cu``'s library on this card and
        toolchain, computed before any build: a hit skips ``nvcc``."""
        return cache_key({"library": name,
                          "build": self.library_path(name).name,
                          "device_kind": self.client.device_kind,
                          "arch": self.arch,
                          "toolchain": self.client.jax_version})

    def _mark(self, outcome: str) -> None:
        if self.client.probe is not None:
            try:
                self.client.probe.mark(outcome)
            except Exception:  # noqa: BLE001 — the probe is best-effort
                pass

    def load(self, name: str):
        """The opened library for ``csrc/<name>.cu``."""
        path = self.library_path(name)
        if path.exists():
            self.dir_hits_c.add()
            self._mark("store")
            return self.open_fn(str(path))

        def compile_fn():
            t0 = time.monotonic()
            self.build_fn(name)
            tracer = self.client.tracer
            if tracer is not None:
                # the build the fleet's later fetches save
                tracer.record("kernel_build", start=t0,
                              dur_s=time.monotonic() - t0, library=name)
            return self.open_fn(str(path))

        def serialize_fn(_lib) -> bytes:
            return path.read_bytes()

        def deserialize_fn(payload: bytes, meta: dict):
            # tmp then rename, opened before the rename: a library that
            # will not open never takes the kernel directory's name
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}"
                                   ".fetch")
            tmp.write_bytes(payload)
            try:
                lib = self.open_fn(str(tmp))
            except BaseException:
                tmp.unlink(missing_ok=True)
                raise
            os.replace(tmp, path)
            return lib

        lib, _outcome = self.client.get_or_compile(
            self.key(name), compile_fn, serialize_fn=serialize_fn,
            deserialize_fn=deserialize_fn, label=name)
        return lib


def install(cache: KernelLibraryCache | None) -> KernelLibraryCache | None:
    """Make ``cache`` the process default that ``_build.load`` consults
    (None: none); returns the one it replaces."""
    global _default
    with _default_lock:
        prev, _default = _default, cache
    return prev


def installed() -> KernelLibraryCache | None:
    return _default


def configure_from_env(*, tracer=None, registry=None, probe=None,
                       env=None) -> KernelLibraryCache | None:
    """Build and install the process-default kernel-library cache from
    the launcher's env fan-out; None (and nothing installed, ``_build``
    unchanged) when neither ``TPUCFN_COMPILE_CACHE_ADDRS`` nor
    ``TPUCFN_COMPILE_CACHE_DIR`` is set.  The identity is read from the
    card: call it from a process that runs the kernels, never from the
    planes that do not touch the card (input hosts, the artifact server,
    the coordinator)."""
    e = os.environ if env is None else env
    addrs = cache_addrs_from_env(e)
    store_dir = (e.get(COMPILE_CACHE_DIR_ENV) or "").strip()
    if not addrs and not store_dir:
        return None
    device_kind, arch = device_identity()
    # The client's ``jax_version`` slot carries the port's toolchain: the
    # handshake and the store refuse a library built by another.
    toolchain = toolchain_identity()
    store = ArtifactStore(store_dir or default_store_dir(),
                          device_kind=device_kind, jax_version=toolchain)
    client = CompileCacheClient(store, addrs, device_kind=device_kind,
                                jax_version=toolchain, registry=registry,
                                tracer=tracer, probe=probe)
    cache = KernelLibraryCache(client, arch=arch)
    install(cache)
    return cache
