"""ctypes binding for the native tpurecord reader (the port of
``tpucfn/data/native.py``).

The C++ library (``csrc/tpurecord.cc``, a copy of the JAX package's
``native/tpurecord.cc`` held equal by ``tests/test_torch_isolation.py``)
owns the hot read path: offset indexing, CRC validation with the GIL
released, payloads served as views over the file mapping.  This module
builds it with ``g++ -O3 -fPIC -shared -std=c++17 -Wall ... -lz`` (the
flags of ``native/build.sh``) at first use, into ``_build/`` beside this
file (git-ignored; nothing is built into ``native/``), loads it, and
falls back to the pure-Python reader in :mod:`tpucfn_torch.data.records`
when no toolchain is present: same format, same errors, slower.  The
fallback is visible: :func:`native_available` says which reader runs,
``native_error()`` why the library did not load, and
:class:`~tpucfn_torch.data.pipeline.ShardedDataset` records the reader it
used in its ``reader`` attribute.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "tpurecord.cc"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_LIB_PATH = _BUILD_DIR / "libtpurecord.so"
_GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
_lib = None
_lib_error: str | None = None


def _build() -> None:
    """Compile the library into ``_LIB_PATH``: written under a temporary
    name and renamed into place, so a concurrent loader never opens a
    half-written file."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=_BUILD_DIR, suffix=".so.part")
    os.close(fd)
    try:
        subprocess.run(["g++", *_GXX_FLAGS, "-o", tmp, str(_SRC), "-lz"],
                       check=True, capture_output=True, text=True,
                       timeout=120)
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _stale(lib) -> bool:
    """A library from an older source: it lacks the zero-copy entry
    points, or the source changed after it was built."""
    return (not hasattr(lib, "tpurec_validate")
            or _SRC.stat().st_mtime_ns > _LIB_PATH.stat().st_mtime_ns)


def _load_lib():
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    try:
        if not _LIB_PATH.exists():
            _build()
        lib = ctypes.CDLL(str(_LIB_PATH))
        if _stale(lib):
            # Stale .so: rebuild, then load under a DIFFERENT path —
            # dlopen caches by original path and re-CDLL'ing _LIB_PATH
            # would return the old image even after the file on disk
            # changed. The copy path is deterministic (keyed by
            # mtime+size) so concurrent or repeated upgrades reuse one
            # file instead of leaking a temp dir per process.
            import shutil

            _build()
            st = _LIB_PATH.stat()
            # Per-uid 0700 cache dir (a world-writable /tmp path could be
            # pre-planted by another local user); unique-name + rename so
            # a concurrent upgrader never dlopens a half-written copy.
            cache_dir = Path(tempfile.gettempdir()) / f"tpurec-{os.getuid()}"
            try:
                cache_dir.mkdir(mode=0o700, exist_ok=True)
                dstat = cache_dir.stat()
                if dstat.st_uid != os.getuid() or (dstat.st_mode & 0o077):
                    raise OSError("cache dir not exclusively ours")
            except OSError:
                cache_dir = Path(tempfile.mkdtemp(prefix="tpurec-"))
            fresh = cache_dir / f"{st.st_mtime_ns}-{st.st_size}.so"
            if not fresh.exists():
                tmp_fd, tmp_name = tempfile.mkstemp(dir=cache_dir,
                                                    suffix=".so.part")
                os.close(tmp_fd)
                shutil.copyfile(_LIB_PATH, tmp_name)
                os.replace(tmp_name, fresh)  # atomic publish
            lib = ctypes.CDLL(str(fresh))
        lib.tpurec_open.restype = ctypes.c_void_p
        lib.tpurec_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
        lib.tpurec_count.restype = ctypes.c_long
        lib.tpurec_count.argtypes = [ctypes.c_void_p]
        # (tpurec_length / tpurec_read / tpurec_read_batch are the
        # copy-out C embedding API — unused by this zero-copy binding.)
        lib.tpurec_index.restype = None
        lib.tpurec_index.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.tpurec_validate.restype = ctypes.c_long
        lib.tpurec_validate.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_long), ctypes.c_long,
        ]
        lib.tpurec_close.restype = None
        lib.tpurec_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    except Exception as e:  # no g++ / build failure → Python fallback
        detail = getattr(e, "stderr", None)
        _lib_error = f"{e}: {detail.strip()}" if detail else str(e)
    return _lib


def native_available() -> bool:
    return _load_lib() is not None


def native_error() -> str | None:
    """Why the native library did not load (None when it did, or before
    the first attempt)."""
    return _lib_error


class NativeShardReader:
    """CRC-validated reader over one tpurecord shard, backed by C++."""

    def __init__(self, path: str | Path):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(f"native reader unavailable: {_lib_error}")
        err = ctypes.create_string_buffer(256)
        self._lib = lib
        self._h = lib.tpurec_open(str(path).encode(), err, len(err))
        if not self._h:
            raise ValueError(f"{path}: {err.value.decode()}")
        self.path = str(path)
        # Zero-copy read path: C++ owns the validated index and the CRC
        # scan (GIL released); payload bytes are served as memoryviews
        # over this mapping — no per-record copy anywhere.
        n = int(lib.tpurec_count(self._h))
        self._offs = np.zeros(n, np.int64)
        self._lens = np.zeros(n, np.int64)
        if n:
            lib.tpurec_index(
                self._h,
                self._offs.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                self._lens.ctypes.data_as(ctypes.POINTER(ctypes.c_long)))
        if n == 0:
            self._mm = None
        else:
            try:
                self._mm = memoryview(np.memmap(self.path, np.uint8, mode="r"))
            except (OSError, ValueError):
                # Filesystems without mmap (some FUSE/network mounts):
                # one read()-copy at open, views served over it — the
                # same behavior the C++ side falls back to.
                self._mm = memoryview(np.fromfile(self.path, np.uint8))

    def __len__(self) -> int:
        return int(self._lib.tpurec_count(self._h))

    def read(self, idx: int) -> memoryview:
        if idx < 0 or idx >= len(self._offs):
            raise IndexError(f"record {idx} out of range in {self.path}")
        return self.read_batch([idx])[0]

    def read_batch(self, indices: Sequence[int]) -> list[memoryview]:
        """Zero-copy batch read: ONE FFI call CRC-validates the records
        in place (C++, GIL released), then payloads are returned as
        memoryviews straight over the file mapping — no data copy on
        either side of the boundary.  Views are bytes-compatible for
        every consumer (decode_example wraps them in BytesIO); they keep
        the mapping alive."""
        n = len(indices)
        if n == 0:
            return []
        idx_arr = (ctypes.c_long * n)(*indices)
        bad = int(self._lib.tpurec_validate(self._h, idx_arr, n))
        if bad == -3:
            raise IndexError(f"batch indices out of range in {self.path}")
        if bad >= 0:
            raise ValueError(f"{self.path}: CRC mismatch at record {bad}")
        mm, offs, lens = self._mm, self._offs, self._lens
        return [mm[offs[i]:offs[i] + lens[i]] for i in indices]

    _ITER_CHUNK = 1024  # validate-call granularity (no buffers involved)

    def __iter__(self) -> Iterator[memoryview]:
        n = len(self)
        for start in range(0, n, self._ITER_CHUNK):
            yield from self.read_batch(range(start, min(start + self._ITER_CHUNK, n)))

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.tpurec_close(self._h)
            self._h = None
            self._mm = None  # outstanding views keep the mapping alive

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def read_record_shard_native(path: str | Path) -> Iterator[memoryview]:
    """Drop-in for :func:`tpucfn_torch.data.records.read_record_shard`."""
    r = NativeShardReader(path)
    try:
        yield from r
    finally:
        r.close()


def decode_batch(reader: NativeShardReader, indices: Sequence[int]) -> list[dict[str, np.ndarray]]:
    from tpucfn_torch.data.records import decode_example

    return [decode_example(p) for p in reader.read_batch(indices)]
