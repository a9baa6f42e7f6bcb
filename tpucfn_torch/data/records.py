"""tpurecord — the on-disk sharded record format.

Capability parity with the reference's data story: datasets staged as
RecordIO shard files that each worker reads its slice of (SURVEY.md §2.1
"S3 data staging", §3.2 "DataIter next batch (RecordIO from EFS/local)").
This is a deliberately simple, seekable, integrity-checked format:

    shard file := magic u32 | version u32 | count u64 | records...
    record     := length u32 | crc32 u32 | payload bytes

Payloads are application-defined (the vision pipelines store
``npz``-encoded example dicts). Shards are the unit of host-level
parallelism: shard ``i`` belongs to process ``i % num_processes``.

A C++ reader with the same wire format lives in ``native/`` (used via
ctypes when built) for decode-bound pipelines; this module is the
always-available pure-Python implementation and the format's reference.
"""

from __future__ import annotations

import io
import struct
import zlib
from pathlib import Path
from typing import Any, Iterable, Iterator

import numpy as np

MAGIC = 0x7B0C_F117
VERSION = 1
_HEADER = struct.Struct("<IIQ")
_REC_HEADER = struct.Struct("<II")


class RecordShardWriter:
    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "wb")
        self._count = 0
        self._f.write(_HEADER.pack(MAGIC, VERSION, 0))

    def write(self, payload: bytes) -> None:
        self._f.write(_REC_HEADER.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF))
        self._f.write(payload)
        self._count += 1

    def write_example(self, example: dict[str, np.ndarray]) -> None:
        buf = io.BytesIO()
        np.savez(buf, **example)
        self.write(buf.getvalue())

    def close(self) -> None:
        self._f.seek(0)
        self._f.write(_HEADER.pack(MAGIC, VERSION, self._count))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_record_shard(path: str | Path) -> Iterator[bytes]:
    """Yield raw payloads; raises on magic/CRC mismatch (corrupt staging —
    the failure mode the reference silently hit when an S3 sync truncated
    a RecordIO file)."""
    with open(path, "rb") as f:
        magic, version, count = _HEADER.unpack(f.read(_HEADER.size))
        if magic != MAGIC:
            raise ValueError(f"{path}: bad magic {magic:#x} — not a tpurecord shard")
        if version != VERSION:
            raise ValueError(f"{path}: unsupported tpurecord version {version}")
        for i in range(count):
            hdr = f.read(_REC_HEADER.size)
            if len(hdr) < _REC_HEADER.size:
                raise ValueError(f"{path}: truncated at record {i}/{count}")
            length, crc = _REC_HEADER.unpack(hdr)
            payload = f.read(length)
            if len(payload) < length or (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                raise ValueError(f"{path}: CRC mismatch at record {i}/{count}")
            yield payload


def shard_record_count(path: str | Path) -> int:
    """Record count from the shard header alone (16 bytes read) — lets
    streaming datasets report length without scanning payloads."""
    with open(path, "rb") as f:
        magic, version, count = _HEADER.unpack(f.read(_HEADER.size))
    if magic != MAGIC:
        raise ValueError(f"{path}: bad magic {magic:#x} — not a tpurecord shard")
    return count


def decode_example(payload: bytes) -> dict[str, np.ndarray]:
    with np.load(io.BytesIO(payload)) as z:
        return {k: z[k] for k in z.files}


def write_dataset_shards(
    examples: Iterable[dict[str, Any]],
    out_dir: str | Path,
    *,
    num_shards: int,
    prefix: str = "data",
) -> list[Path]:
    """Stage a dataset into ``num_shards`` tpurecord files — the analogue
    of the reference's ``aws s3 sync`` staging step, producing the layout
    the sharded reader expects."""
    out = Path(out_dir)
    writers = [
        RecordShardWriter(out / f"{prefix}-{i:05d}-of-{num_shards:05d}.tpurec")
        for i in range(num_shards)
    ]
    try:
        for i, ex in enumerate(examples):
            writers[i % num_shards].write_example(
                {k: np.asarray(v) for k, v in ex.items()}
            )
    finally:
        for w in writers:
            w.close()
    return [w.path for w in writers]
