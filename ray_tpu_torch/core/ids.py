"""Binary IDs for tasks/objects/actors/nodes.

Reference: src/ray/common/id.h — Ray embeds ownership info in IDs (ObjectID =
TaskID + index, TaskID embeds ActorID/JobID). We keep the same embedding so an
ObjectID alone identifies the task that produced it (needed for lineage
reconstruction) while fixing all IDs at 20 bytes, the native store's key width.

Layout:
  JobID    = 4 bytes
  ActorID  = 12 bytes = 8 unique + JobID
  TaskID   = 16 bytes = 4 unique + ActorID
  ObjectID = 20 bytes = TaskID + 4-byte big-endian return index
  NodeID / WorkerID / PlacementGroupID = 20 random bytes
"""

from __future__ import annotations

import os
import struct


class BaseID:
    SIZE = 20
    __slots__ = ("_bytes", "_hash")

    def __init__(self, b: bytes):
        if len(b) != self.SIZE:
            raise ValueError(f"{type(self).__name__} needs {self.SIZE} bytes, got {len(b)}")
        self._bytes = b
        self._hash = None

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    @classmethod
    def from_hex(cls, h: str):
        return cls(bytes.fromhex(h))

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __hash__(self):
        # ids key every hot-path dict (directory, refcounts, queues);
        # cache the hash — it's taken dozens of times per task
        h = self._hash
        if h is None:
            h = self._hash = hash((type(self).__name__, self._bytes))
        return h

    # The cache must NOT cross process boundaries: bytes hashing is
    # per-process salted (PYTHONHASHSEED), so a shipped cached hash
    # would disagree with locally-constructed equal ids and silently
    # miss every dict probe (observed: workers "not found" at their own
    # nodelet, actors never alive).
    def __getstate__(self):
        return self._bytes

    def __setstate__(self, state):
        if isinstance(state, tuple):
            # legacy slots format ((None, {"_bytes": ...})) from state
            # files written before __getstate__ existed
            state = state[1]["_bytes"]
        self._bytes = state
        self._hash = None

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()[:16]})"


class NodeID(BaseID):
    SIZE = 20


class WorkerID(BaseID):
    SIZE = 20


class PlacementGroupID(BaseID):
    SIZE = 20


class JobID(BaseID):
    SIZE = 4


class ActorID(BaseID):
    SIZE = 12

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(os.urandom(8) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[8:])


class TaskID(BaseID):
    SIZE = 16

    @classmethod
    def of(cls, actor_id: ActorID) -> "TaskID":
        return cls(os.urandom(4) + actor_id.binary())

    @classmethod
    def for_driver(cls, job_id: JobID) -> "TaskID":
        return cls(os.urandom(4) + b"\x00" * 8 + job_id.binary())

    def actor_id(self) -> ActorID:
        return ActorID(self._bytes[4:])

    def job_id(self) -> JobID:
        return JobID(self._bytes[12:])


class ObjectID(BaseID):
    SIZE = 20

    @classmethod
    def for_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + struct.pack(">I", index))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        # Put objects use the high bit of the index space so they never
        # collide with return indices (ref: id.h ObjectID::FromIndex).
        return cls(task_id.binary() + struct.pack(">I", 0x80000000 | put_index))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:16])

    def return_index(self) -> int:
        return struct.unpack(">I", self._bytes[16:])[0]

    def is_put(self) -> bool:
        return bool(self.return_index() & 0x80000000)
