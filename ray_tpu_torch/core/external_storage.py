"""External storage for spilled objects (host-tier → disk).

Reference: python/ray/_private/external_storage.py:72 (FileSystemStorage —
spill serialized objects to files under a spill dir, return restore URLs) and
src/ray/raylet/local_object_manager.h:41 (spill under memory pressure,
restore on demand, delete on ref release).

TPU-first redesign notes: the shm segment is the host staging tier for both
control-plane objects and HBM-offloaded arrays, so spilling backs *both*
tiers; files carry the already-serialized wire bytes (zero re-serialization
on either side of the spill boundary).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.core.ids import ObjectID


class FilesystemStorage:
    """Spill store writing one file per object under `root`.

    URLs are `file://<path>`; paths embed the object id so restore needs no
    extra index (the nodelet keeps one anyway for fast `contains`).
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        self._spilled: Dict[ObjectID, str] = {}
        self._sizes: Dict[ObjectID, int] = {}
        self._bytes = 0

    # -- spill ----------------------------------------------------------------

    def spill(self, oid: ObjectID, data: memoryview | bytes) -> str:
        nbytes = data.nbytes if isinstance(data, memoryview) else len(data)
        path = os.path.join(self.root, oid.hex())
        # unique tmp per attempt: concurrent spills of the SAME object
        # (periodic spill loop vs put-pressure free_space) must not share
        # a tmp path, or one racer renames it away under the other
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # atomic: readers never see partial files
        url = f"file://{path}"
        with self._lock:
            prev = self._sizes.get(oid)
            if prev is not None:
                self._bytes -= prev
            self._bytes += nbytes
            self._sizes[oid] = nbytes
            self._spilled[oid] = url
        return url

    def contains(self, oid: ObjectID) -> bool:
        with self._lock:
            return oid in self._spilled

    def url_of(self, oid: ObjectID) -> Optional[str]:
        with self._lock:
            return self._spilled.get(oid)

    # -- restore --------------------------------------------------------------

    def restore(self, oid: ObjectID) -> Optional[bytes]:
        url = self.url_of(oid)
        if url is None:
            return None
        path = url[len("file://"):]
        try:
            with open(path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            self._forget(oid)
            return None

    def read_range(self, oid: ObjectID, offset: int,
                   size: int) -> Optional[Tuple[int, bytes]]:
        """(total_size, chunk) for chunked remote pulls straight off disk."""
        url = self.url_of(oid)
        if url is None:
            return None
        path = url[len("file://"):]
        try:
            total = os.path.getsize(path)
            with open(path, "rb") as f:
                f.seek(offset)
                return total, f.read(size)
        except FileNotFoundError:
            return None

    # -- delete ---------------------------------------------------------------

    def _forget(self, oid: ObjectID) -> None:
        with self._lock:
            self._spilled.pop(oid, None)
            sz = self._sizes.pop(oid, None)
            if sz is not None:
                self._bytes -= sz

    def delete(self, oid: ObjectID) -> None:
        url = self.url_of(oid)
        self._forget(oid)
        if url is None:
            return
        try:
            os.remove(url[len("file://"):])
        except FileNotFoundError:
            pass

    def delete_all(self) -> None:
        with self._lock:
            oids = list(self._spilled)
        for oid in oids:
            self.delete(oid)

    # -- stats ----------------------------------------------------------------

    def num_spilled(self) -> int:
        with self._lock:
            return len(self._spilled)

    def bytes_spilled(self) -> int:
        with self._lock:
            return self._bytes

    def spilled_ids(self) -> List[ObjectID]:
        with self._lock:
            return list(self._spilled)
