"""Object-store staging — the "S3 → local → HBM" half of the data path.

The reference's workflow staged datasets from S3 onto the cluster's
shared volume before training (SURVEY.md §2.1 "S3 data staging", §3.1:
``aws s3 sync s3://bucket/dataset /efs/dataset``).  tpucfn models that
with a small :class:`Store` interface — list/read/write/download by key —
with three implementations:

* :class:`LocalStore` — a directory tree; the CI-testable default, and
  also the "shared filesystem" case (NFS/Filestore mounts).
* :class:`CliObjectStore` — gs:// and s3:// URLs via the corresponding
  CLI (``gsutil`` / ``aws s3``) in a subprocess.  The build environment
  has zero egress and no cloud CLIs, so this class takes an injectable
  ``runner`` and the test suite drives it with recorded argv fixtures;
  on a real pod the default runner shells out.

:func:`stage` is the ``s3 sync`` analogue: download every shard under a
prefix into a local cache directory (idempotent — existing files with
matching sizes are kept), returning the local paths that
``ShardedDataset`` consumes.  Training never reads the remote store on
the hot path; steps stream from local disk/page cache.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path
from typing import Callable, Sequence

# runner(argv) -> stdout str; raises CalledProcessError on failure.
CliRunner = Callable[[Sequence[str]], str]


def _default_runner(argv: Sequence[str]) -> str:
    return subprocess.run(
        list(argv), check=True, capture_output=True, text=True
    ).stdout


class Store:
    """Key-addressed blob store; keys are '/'-separated relative paths."""

    def list(self, prefix: str = "") -> list[str]:
        raise NotImplementedError

    def read_bytes(self, key: str) -> bytes:
        raise NotImplementedError

    def write_bytes(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def download(self, key: str, dest: str | Path) -> Path:
        """Fetch ``key`` to the local path ``dest`` (parent dirs created)."""
        dest = Path(dest)
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.write_bytes(self.read_bytes(key))
        return dest

    def size(self, key: str) -> int | None:
        """Object size in bytes, or None if unknown/cheaply unavailable."""
        return None

    def upload(self, src: str | Path, key: str) -> None:
        """Publish a local file to ``key``. Default round-trips through
        memory; path-capable backends override to stream from disk."""
        self.write_bytes(key, Path(src).read_bytes())


class LocalStore(Store):
    def __init__(self, root: str | Path):
        self.root = Path(root)

    def _p(self, key: str) -> Path:
        p = (self.root / key).resolve()
        if not p.is_relative_to(self.root.resolve()):
            raise ValueError(f"key {key!r} escapes store root")
        return p

    def list(self, prefix: str = "") -> list[str]:
        # Directory semantics, matching CliObjectStore: prefix 'imagenet'
        # must not match a sibling 'imagenet2012/...'.
        base = self.root
        out = []
        if not base.exists():
            return out
        pfx = prefix.strip("/")
        for p in sorted(base.rglob("*")):
            if p.is_file():
                key = p.relative_to(base).as_posix()
                if not pfx or key == pfx or key.startswith(pfx + "/"):
                    out.append(key)
        return out

    def read_bytes(self, key: str) -> bytes:
        return self._p(key).read_bytes()

    def write_bytes(self, key: str, data: bytes) -> None:
        p = self._p(key)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(data)

    def size(self, key: str) -> int | None:
        p = self._p(key)
        return p.stat().st_size if p.exists() else None

    def upload(self, src: str | Path, key: str) -> None:
        import shutil

        dest = self._p(key)
        if dest.exists() and os.path.samefile(src, dest):
            return  # publishing a file onto itself is a no-op
        dest.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(src, dest)


class CliObjectStore(Store):
    """gs:// / s3:// objects via the cloud CLI in a subprocess.

    Commands used (stable, scriptable surfaces):
        gsutil ls gs://b/prefix**      |  aws s3 ls --recursive b/prefix
        gsutil cp gs://b/key dest      |  aws s3 cp s3://b/key dest
        gsutil cp src gs://b/key       |  aws s3 cp src s3://b/key

    ``runner`` is injectable so CI (zero egress, no CLIs installed)
    exercises the full argv surface against recorded fixtures.
    """

    def __init__(self, base_url: str, runner: CliRunner | None = None):
        if not base_url.startswith(("gs://", "s3://")):
            raise ValueError(f"unsupported object-store url {base_url!r}")
        self.base_url = base_url.rstrip("/")
        self.scheme = base_url.split("://", 1)[0]
        self.runner = runner or _default_runner

    def _url(self, key: str) -> str:
        return f"{self.base_url}/{key}" if key else self.base_url

    def list(self, prefix: str = "") -> list[str]:
        # ``prefix`` has directory semantics (like `s3 sync`): an explicit
        # '/' separator is appended so 'datasets/imagenet' never matches a
        # sibling 'datasets/imagenet2012'.
        if self.scheme == "gs":
            base = self._url(prefix.strip("/"))
            out = self.runner(["gsutil", "ls", base.rstrip("/") + "/**"])
        else:
            bucket_and_path = self.base_url[len("s3://"):]
            bucket = bucket_and_path.split("/", 1)[0]
            base_key = (bucket_and_path.split("/", 1)[1].strip("/") + "/"
                        if "/" in bucket_and_path else "")
            list_prefix = base_key + prefix.strip("/")
            if prefix.strip("/"):
                list_prefix += "/"
            out = self.runner(["aws", "s3api", "list-objects-v2", "--bucket",
                               bucket, "--prefix", list_prefix,
                               "--query", "Contents[].Key", "--output", "text"])
            keys = []
            for tok in out.split():
                if tok != "None":
                    keys.append(tok[len(base_key):] if base_key and
                                tok.startswith(base_key) else tok)
            return sorted(keys)
        keys = []
        root = self.base_url + "/"
        for line in out.splitlines():
            line = line.strip()
            if line.startswith(root) and not line.endswith("/"):
                keys.append(line[len(root):])
        return sorted(keys)

    def read_bytes(self, key: str) -> bytes:
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            dest = Path(td) / "obj"
            self.download(key, dest)
            return dest.read_bytes()

    def download(self, key: str, dest: str | Path) -> Path:
        dest = Path(dest)
        dest.parent.mkdir(parents=True, exist_ok=True)
        cli = ["gsutil", "cp"] if self.scheme == "gs" else ["aws", "s3", "cp"]
        self.runner(cli + [self._url(key), str(dest)])
        return dest

    def write_bytes(self, key: str, data: bytes) -> None:
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            src = Path(td) / "obj"
            src.write_bytes(data)
            self.upload(src, key)

    def upload(self, src: str | Path, key: str) -> None:
        # Stream straight from disk: no RAM pass, no temp copy.
        cli = ["gsutil", "cp"] if self.scheme == "gs" else ["aws", "s3", "cp"]
        self.runner(cli + [str(src), self._url(key)])

    def size(self, key: str) -> int | None:
        try:
            if self.scheme == "gs":
                out = self.runner(["gsutil", "stat", self._url(key)])
                for line in out.splitlines():
                    if "Content-Length" in line:
                        return int(line.split(":", 1)[1].strip())
                return None
            bucket_and_path = self.base_url[len("s3://"):]
            bucket = bucket_and_path.split("/", 1)[0]
            base_key = (bucket_and_path.split("/", 1)[1].strip("/") + "/"
                        if "/" in bucket_and_path else "")
            out = self.runner(["aws", "s3api", "head-object", "--bucket", bucket,
                               "--key", base_key + key,
                               "--query", "ContentLength", "--output", "text"])
            return int(out.strip())
        except (subprocess.CalledProcessError, ValueError):
            return None  # treat as unknown: stage() re-downloads


def store_for_url(url: str, runner: CliRunner | None = None) -> tuple[Store, str]:
    """(store, prefix) for a dataset URL.

    ``gs://bucket/path`` and ``s3://bucket/path`` → CliObjectStore rooted
    at the bucket with ``path`` as the prefix; ``file:///dir`` or a plain
    path → LocalStore rooted at the dir with empty prefix.
    """
    if url.startswith(("gs://", "s3://")):
        scheme, rest = url.split("://", 1)
        bucket, _, prefix = rest.partition("/")
        return CliObjectStore(f"{scheme}://{bucket}", runner=runner), prefix
    if url.startswith("file://"):
        url = url[len("file://"):]
    return LocalStore(url), ""


def stage(
    store: Store,
    prefix: str,
    cache_dir: str | Path,
    *,
    suffix: str = ".tpurec",
    owner_slice: tuple[int, int] | None = None,
) -> list[Path]:
    """Sync-down every ``suffix`` object under ``prefix`` into
    ``cache_dir`` (the ``aws s3 sync`` analogue).

    * Idempotent: a local file whose size matches the remote object is
      not re-fetched, so restarts only pay the transfer once.
    * Atomic: downloads land in a temp name and rename into place, so a
      concurrent reader never sees a torn shard.
    * Collision-free: keys keep their path relative to ``prefix`` under
      ``cache_dir`` (train/x.tpurec and val/x.tpurec stay distinct).
    * ``owner_slice=(i, n)`` downloads only shards ``i::n`` of the
      sorted list (the ShardedDataset ownership rule) but returns ALL
      local paths in sorted order, so every process computes the same
      shard list while fetching only what it will read — the multi-host
      bandwidth contract of the reference's per-worker `s3 cp` loop.
    """
    import os as _os
    import uuid

    cache = Path(cache_dir)
    cache.mkdir(parents=True, exist_ok=True)
    keys = sorted(k for k in store.list(prefix) if k.endswith(suffix))
    pfx = prefix.strip("/")
    out = []
    for i, key in enumerate(keys):
        rel = key[len(pfx):].lstrip("/") if pfx and key.startswith(pfx) else key
        dest = cache / rel
        out.append(dest)
        if owner_slice is not None and i % owner_slice[1] != owner_slice[0]:
            continue
        # Check the cheap local condition first: a cold cache skips the
        # per-shard remote stat entirely.
        if dest.exists():
            remote_size = store.size(key)
            if remote_size is not None and dest.stat().st_size == remote_size:
                continue
        tmp = dest.with_name(f".{dest.name}.{uuid.uuid4().hex[:8]}.tmp")
        store.download(key, tmp)
        _os.replace(tmp, dest)
    if not out:
        raise FileNotFoundError(
            f"no {suffix} objects under prefix {prefix!r} in {store!r}")
    return out


def stage_url(url: str, cache_dir: str | Path,
              runner: CliRunner | None = None,
              owner_slice: tuple[int, int] | None = None) -> list[Path]:
    """One-call staging: resolve ``url`` to a store and sync its shards
    down to ``cache_dir``."""
    store, prefix = store_for_url(url, runner=runner)
    return stage(store, prefix, cache_dir, owner_slice=owner_slice)
