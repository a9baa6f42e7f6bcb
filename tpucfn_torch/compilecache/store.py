"""Content-addressed local store of compiled artifacts (the port of
``tpucfn/compilecache/store.py``), here the kernel libraries that
``nvcc`` builds from ``tpucfn_torch/kernels/csrc`` (see
:mod:`tpucfn_torch.compilecache.kernels`).

Every definition but :func:`default_store_dir` is a copy of the JAX
package's, held equal by ``tests/test_torch_isolation.py``: two files an
entry (``<key>.meta.json`` and ``<key>.<sha16>.bin``), written
tmp-then-rename with the meta last; every read re-hashes the payload and
quarantines a corrupt entry into ``corrupt/``; an entry recorded for
another device kind or toolchain raises :class:`CacheMismatch`;
``claim``/``release`` are the local single-flight lock; ``gc`` caps the
directory LRU-first.

:func:`default_store_dir` is the port's own: ``$TPUCFN_COMPILE_CACHE_DIR``
first, as in the reference, else ``compilecache/`` under the port's state
dir (``$TPUCFN_TORCH_STATE_DIR`` or ``~/.tpucfn_torch``), never the JAX
package's XLA-cache sibling.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from pathlib import Path


def default_store_dir() -> str:
    """$TPUCFN_COMPILE_CACHE_DIR, else ``compilecache`` under the port's
    state dir: one resolution rule shared by the client and the CLI's
    server and gc."""
    d = os.environ.get("TPUCFN_COMPILE_CACHE_DIR", "").strip()
    if d:
        return d
    state = os.environ.get("TPUCFN_TORCH_STATE_DIR", "").strip()
    return str(Path(state or "~/.tpucfn_torch").expanduser() / "compilecache")


class CacheCorrupt(RuntimeError):
    """An entry exists but fails its integrity check (payload hash,
    torn meta).  The reader quarantines it and treats the key as a
    miss — loudly, via this exception, so callers can count it."""


class CacheMismatch(RuntimeError):
    """An entry's recorded device_kind/jax version disagree with the
    running process — refusing beats deserializing an executable built
    for different hardware or a different compiler."""


def cache_key(components: dict) -> str:
    """Stable content digest of a program's identity, computed BEFORE
    compiling (that is what lets a hit skip the compile entirely).
    ``components`` is a flat JSON-able dict — the jit glue feeds
    (StableHLO hash, avals, in/out shardings, mesh, device_kind,
    jax/jaxlib versions, relevant config flags); anything that changes
    the compiled artifact must be in here or two different programs
    alias one key."""
    blob = json.dumps(components, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def _payload_sha(payload: bytes) -> str:
    return hashlib.sha256(payload).hexdigest()


_KEY_OK = set("0123456789abcdef")


def valid_key(key: str) -> bool:
    """Keys are sha256 hex digests; anything else is refused at every
    boundary (store paths, server frames) — a key IS a filename, and
    this is the path-traversal guard."""
    return 16 <= len(key) <= 64 and all(c in _KEY_OK for c in key)


class ArtifactStore:
    """One directory of content-addressed executable artifacts."""

    def __init__(self, d: str | Path, *, device_kind: str = "",
                 jax_version: str = ""):
        self.dir = Path(d)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.device_kind = device_kind
        self.jax_version = jax_version

    # -- paths -------------------------------------------------------------

    def _meta_path(self, key: str) -> Path:
        return self.dir / f"{key}.meta.json"

    def _bin_path(self, key: str, sha: str) -> Path:
        return self.dir / f"{key}.{sha[:16]}.bin"

    def _bin_from_meta(self, key: str, meta: dict) -> Path | None:
        name = meta.get("bin")
        # the bin name is derived, never trusted: it must be this key's
        # hash-named pattern (the meta file is the only writable input)
        if isinstance(name, str) and name.startswith(f"{key}.") \
                and name.endswith(".bin") and "/" not in name:
            return self.dir / name
        sha = meta.get("sha256")
        if isinstance(sha, str) and sha:
            return self._bin_path(key, sha)
        return None

    # -- read side ---------------------------------------------------------

    def has(self, key: str) -> bool:
        if not valid_key(key):
            return False
        meta = self.meta(key)
        if meta is None:
            return False
        p = self._bin_from_meta(key, meta)
        return p is not None and p.is_file()

    def meta(self, key: str) -> dict | None:
        if not valid_key(key):
            return None
        try:
            m = json.loads(self._meta_path(key).read_text())
        except (OSError, json.JSONDecodeError):
            return None
        return m if isinstance(m, dict) else None

    def get(self, key: str) -> tuple[bytes, dict] | None:
        """``(payload, meta)`` for one verified entry, or None on a
        plain miss.  Integrity failure quarantines AND raises
        :class:`CacheCorrupt`; an entry recorded for different hardware
        or jax raises :class:`CacheMismatch` (without quarantine — it
        is a valid artifact, just not ours)."""
        if not valid_key(key):
            return None
        meta = self.meta(key)
        if meta is None:
            # Payload without (readable) meta is the documented
            # IN-FLIGHT window of put() — bin renamed in, meta (the
            # commit marker) not yet — and the claim-wait loop polls
            # get() during exactly that window, so it must read as a
            # plain miss.  Quarantining here would destroy a healthy
            # concurrent publish mid-commit; a genuinely torn publish
            # just leaves an inert bin a later complete put overwrites.
            return None
        bin_path = self._bin_from_meta(key, meta)
        try:
            if bin_path is None:
                raise OSError("meta names no payload")
            payload = bin_path.read_bytes()
        except OSError:
            if not self._meta_path(key).exists():
                # Concurrent eviction (gc unlinks meta first, then bin):
                # we loaded the meta just before it went.  The entry is
                # GONE, not corrupt — a clean miss, exactly what a
                # reader arriving a moment later would see.
                return None
            self.quarantine(key)
            raise CacheCorrupt(
                f"artifact {key} meta present but payload unreadable "
                f"in {self.dir} — quarantined")
        if _payload_sha(payload) != meta.get("sha256"):
            self.quarantine(key)
            raise CacheCorrupt(
                f"artifact {key} payload fails its recorded sha256 in "
                f"{self.dir} — quarantined, treating as a miss")
        # Mark recency for LRU eviction (gc orders by meta atime):
        # relatime mounts update atime at most daily, which would make
        # a hot entry look cold — touch it explicitly on every hit.
        try:
            os.utime(self._meta_path(key))
        except OSError:
            pass
        if self.device_kind and meta.get("device_kind") \
                and meta["device_kind"] != self.device_kind:
            raise CacheMismatch(
                f"artifact {key} was compiled for device_kind "
                f"{meta['device_kind']!r}, this process runs "
                f"{self.device_kind!r}")
        if self.jax_version and meta.get("jax_version") \
                and meta["jax_version"] != self.jax_version:
            raise CacheMismatch(
                f"artifact {key} was serialized under jax "
                f"{meta['jax_version']}, this process runs "
                f"{self.jax_version}")
        return payload, meta

    # -- write side --------------------------------------------------------

    def put(self, key: str, payload: bytes, meta: dict | None = None) -> dict:
        """Atomic publish: payload first, meta (the commit marker)
        last, both via tmp-then-rename.  Re-publishing an existing key
        is a no-op (content-addressed: same key, same content)."""
        if not valid_key(key):
            raise ValueError(f"invalid artifact key {key!r}")
        sha = _payload_sha(payload)
        full = {
            "device_kind": self.device_kind,
            "jax_version": self.jax_version,
            "created_ts": time.time(),
            **(meta or {}),
        }
        # Integrity fields are NEVER caller-supplied: a publisher's meta
        # carrying a wrong sha256 (bug or lie) would otherwise poison
        # this key slot into permanent CacheCorrupt quarantine on every
        # subsequent read.  What we hash is what we store, and the bin
        # name carries the hash so a racing publisher of DIFFERENT
        # bytes writes a different file (our meta can only ever point
        # at our payload).
        bin_path = self._bin_path(key, sha)
        full["key"] = key
        full["sha256"] = sha
        full["size"] = len(payload)
        full["bin"] = bin_path.name
        if self.has(key):
            existing = self.meta(key)
            if existing is not None:
                return existing
        pid = os.getpid()
        tmp_bin = self.dir / f".{key}.bin.{pid}.tmp"
        tmp_bin.write_bytes(payload)
        tmp_bin.replace(bin_path)
        tmp_meta = self.dir / f".{key}.meta.{pid}.tmp"
        tmp_meta.write_text(json.dumps(full))
        tmp_meta.replace(self._meta_path(key))
        return full

    def quarantine(self, key: str) -> None:
        """Move a bad entry aside (``corrupt/``) so the key slot frees
        for a fresh publish and the bad bytes stay for forensics —
        the checkpoint quarantine pattern, applied to executables."""
        qdir = self.dir / "corrupt"
        qdir.mkdir(exist_ok=True)
        stamp = f"{int(time.time() * 1000):x}"
        meta = self.meta(key)
        targets = [self._meta_path(key)]
        if meta is not None:
            p = self._bin_from_meta(key, meta)
            if p is not None:
                targets.insert(0, p)
        for p in targets:
            if p.exists():
                try:
                    p.replace(qdir / f"{p.name}.{stamp}")
                except OSError:
                    pass

    def gc(self, max_bytes: int, *, orphan_age_s: float = 3600.0) -> dict:
        """Cap the store at ``max_bytes`` of live entries, LRU by meta
        atime (``get`` touches it on every hit), and sweep debris
        (ISSUE 14 satellite — shared long-lived dirs accumulate one
        entry per program per jax version forever, and the draft-engine
        programs of speculative serving double the rate):

        * live entries (meta + its payload) evict oldest-read first
          until the live total fits ``max_bytes`` — a key with a LIVE
          ``.claim`` lockfile is NEVER evicted (a compiler owns it right
          now; its publish must not race a deletion);
        * orphan payloads (hash-named bins no meta points at — racing
          publishers' losers) and stale ``.tmp`` files older than
          ``orphan_age_s`` are removed outright (younger ones may be a
          publish in flight: put() renames bin before meta);
        * eviction removes the meta FIRST (the commit marker: readers
          downgrade to a clean miss mid-eviction, never a torn entry).

        Returns a stats dict; quarantined ``corrupt/`` forensics are
        reported but never deleted (they exist to be looked at)."""
        if max_bytes < 0:
            raise ValueError(f"max_bytes must be >= 0, got {max_bytes}")
        now = time.time()
        entries = []  # (atime, key, size, meta_path, bin_path)
        referenced: set[str] = set()
        live_bytes = 0
        for key in self.keys():
            meta_path = self._meta_path(key)
            # Stat BEFORE reading: on a strictatime mount the read
            # below would stamp every meta with gc's own pass, erasing
            # the very recency order this collects.
            try:
                st = meta_path.stat()
            except OSError:
                continue
            size, atime = st.st_size, st.st_atime
            meta = self.meta(key)
            if meta is None:
                continue
            bin_path = self._bin_from_meta(key, meta)
            if bin_path is not None:
                referenced.add(bin_path.name)
                try:
                    size += bin_path.stat().st_size
                except OSError:
                    pass
            entries.append((atime, key, size, meta_path, bin_path))
            live_bytes += size
        stats = {"entries": len(entries), "live_bytes": live_bytes,
                 "evicted": 0, "evicted_bytes": 0, "kept_claimed": 0,
                 "orphans_removed": 0, "orphan_bytes": 0,
                 "corrupt_bytes": sum(
                     p.stat().st_size
                     for p in (self.dir / "corrupt").glob("*")
                     if p.is_file()) if (self.dir / "corrupt").is_dir()
                 else 0}
        for atime, key, size, meta_path, bin_path in sorted(entries):
            if live_bytes <= max_bytes:
                break
            if (self.dir / f"{key}.claim").exists():
                stats["kept_claimed"] += 1
                continue
            for p in ([meta_path] + ([bin_path] if bin_path else [])):
                try:
                    p.unlink()
                except OSError:
                    pass
            live_bytes -= size
            stats["evicted"] += 1
            stats["evicted_bytes"] += size
        for p in self.dir.glob("*.bin"):
            if p.name in referenced:
                continue
            try:
                if now - p.stat().st_mtime <= orphan_age_s:
                    continue
                stats["orphan_bytes"] += p.stat().st_size
                p.unlink()
                stats["orphans_removed"] += 1
            except OSError:
                pass
        for p in self.dir.glob(".*.tmp"):
            try:
                if now - p.stat().st_mtime > orphan_age_s:
                    stats["orphan_bytes"] += p.stat().st_size
                    p.unlink()
                    stats["orphans_removed"] += 1
            except OSError:
                pass
        stats["live_bytes_after"] = live_bytes
        return stats

    def keys(self) -> list[str]:
        return sorted(p.name[: -len(".meta.json")]
                      for p in self.dir.glob("*.meta.json")
                      if valid_key(p.name[: -len(".meta.json")]))

    # -- local single-flight ----------------------------------------------

    def claim(self, key: str, *, stale_s: float = 600.0) -> bool:
        """Best-effort cross-process single-flight on one machine
        (O_EXCL lockfile): True = this process owns the compile for
        ``key`` and must :meth:`release` (or publish) when done.  A
        claim older than ``stale_s`` is presumed orphaned by a dead
        compiler and is broken — compiles are long, but not eternal."""
        lock = self.dir / f"{key}.claim"
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            try:
                if time.time() - lock.stat().st_mtime > stale_s:
                    lock.unlink(missing_ok=True)
                    return self.claim(key, stale_s=stale_s)
            except OSError:
                pass
            return False
        except OSError:
            return False
        with os.fdopen(fd, "w") as f:
            f.write(str(os.getpid()))
        return True

    def release(self, key: str) -> None:
        (self.dir / f"{key}.claim").unlink(missing_ok=True)
