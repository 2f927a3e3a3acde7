"""Pluggable GCS persistence: snapshot + append-WAL.

Reference: src/ray/gcs/gcs_server/gcs_table_storage.h:252 (pluggable table
storage) over store_client/{in_memory,redis}_store_client.h. The round-1
design persisted debounced whole-state snapshots only, which loses writes
acknowledged between snapshot points; this adds a write-ahead log so every
acked mutation survives a GCS crash:

- `append(record)` durably logs one mutation (buffered write + flush per
  record; fsync at most once a second — the same window as Redis
  appendfsync-everysec, documented rather than pretended away).
- `rotate()` starts a new WAL segment and returns the old segment's seq;
  called atomically with the state pickle on the GCS loop, so a snapshot
  plus all segments newer than its watermark is always a complete state.
- `commit_snapshot(data, watermark)` persists the snapshot, then deletes
  segments <= watermark. If the commit crashes mid-way, restore still
  works from the previous snapshot + the surviving segments.
- `restore()` -> (snapshot_bytes | None, [records...]) replaying every
  surviving segment in order; a torn tail record (crash mid-append) ends
  replay for that segment.

Record framing: [u32 len][u32 crc32][payload].
"""

from __future__ import annotations

import os
import re
import struct
import time
import zlib
from typing import List, Optional, Tuple

_SEG_RE = re.compile(r"^wal\.(\d{8})$")


class GcsStorage:
    """Interface (ref: GcsTableStorage). Implementations must make
    append() durable enough that restore() returns it after a crash."""

    def append(self, record: bytes) -> None:
        raise NotImplementedError

    def rotate(self) -> int:
        raise NotImplementedError

    def commit_snapshot(self, data: bytes, watermark: int) -> None:
        raise NotImplementedError

    def restore(self) -> Tuple[Optional[bytes], List[bytes]]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemoryGcsStorage(GcsStorage):
    """No durability (ref: in_memory_store_client.h) — default for tests
    and throwaway clusters."""

    def append(self, record: bytes) -> None:
        pass

    def rotate(self) -> int:
        return 0

    def commit_snapshot(self, data: bytes, watermark: int) -> None:
        pass

    def restore(self) -> Tuple[Optional[bytes], List[bytes]]:
        return None, []


class FileGcsStorage(GcsStorage):
    def __init__(self, dirpath: str, fsync_interval_s: float = 1.0):
        self.dir = dirpath
        os.makedirs(dirpath, exist_ok=True)
        self._fsync_interval = fsync_interval_s
        self._last_fsync = 0.0
        seqs = self._segments()
        self._seq = (seqs[-1] + 1) if seqs else 1
        self._f = None
        self._open_segment()

    # -- internals -----------------------------------------------------------

    def _segments(self) -> List[int]:
        out = []
        try:
            for name in os.listdir(self.dir):
                m = _SEG_RE.match(name)
                if m:
                    out.append(int(m.group(1)))
        except OSError:
            pass
        return sorted(out)

    def _seg_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"wal.{seq:08d}")

    def _open_segment(self):
        if self._f is not None:
            self._f.close()
        self._f = open(self._seg_path(self._seq), "ab")

    # -- GcsStorage ----------------------------------------------------------

    def append(self, record: bytes) -> None:
        self._f.write(struct.pack("<II", len(record),
                                  zlib.crc32(record) & 0xFFFFFFFF))
        self._f.write(record)
        self._f.flush()
        now = time.monotonic()
        if now - self._last_fsync >= self._fsync_interval:
            self._last_fsync = now
            os.fsync(self._f.fileno())

    def rotate(self) -> int:
        # no fsync here: rotate runs on the GCS event loop and must stay
        # cheap (segment swap only). The everysec append fsync already
        # bounds machine-crash loss; process crashes lose nothing that
        # was flushed to the page cache.
        old = self._seq
        self._seq += 1
        self._open_segment()
        return old

    def commit_snapshot(self, data: bytes, watermark: int) -> None:
        path = os.path.join(self.dir, "gcs_snapshot.pkl")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        for seq in self._segments():
            if seq <= watermark:
                try:
                    os.unlink(self._seg_path(seq))
                except OSError:
                    pass

    def restore(self) -> Tuple[Optional[bytes], List[bytes]]:
        snap = None
        path = os.path.join(self.dir, "gcs_snapshot.pkl")
        try:
            with open(path, "rb") as f:
                snap = f.read()
        except OSError:
            pass
        records: List[bytes] = []
        for seq in self._segments():
            if seq == self._seq:
                continue   # our own (empty) live segment
            try:
                with open(self._seg_path(seq), "rb") as f:
                    while True:
                        hdr = f.read(8)
                        if len(hdr) < 8:
                            break
                        n, crc = struct.unpack("<II", hdr)
                        payload = f.read(n)
                        if len(payload) < n or \
                                (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                            break   # torn tail: crash mid-append
                        records.append(payload)
            except OSError:
                continue
        return snap, records

    def close(self) -> None:
        if self._f is not None:
            try:
                os.fsync(self._f.fileno())
            except OSError:
                pass
            self._f.close()
            self._f = None
