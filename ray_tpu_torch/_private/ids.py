"""Unique identifiers for jobs, tasks, actors, objects, nodes, placement groups.

Capability parity with the reference's ID system (reference: src/ray/common/id.h:103-330),
redesigned: every ID is an immutable bytes-backed value with a kind tag, hex round-trip,
and deterministic derivation (ObjectID from (TaskID, return index), TaskID from
(JobID | ActorID, submission seed)) so ownership and lineage can be recomputed without
central coordination.
"""

from __future__ import annotations

import hashlib
import os
import threading

_NIL = b""


class BaseID:
    """Immutable binary ID. Subclasses fix SIZE (bytes) and a one-byte kind tag."""

    SIZE = 16
    KIND = b"?"
    __slots__ = ("_bytes", "_hash")

    def __init__(self, binary: bytes):
        if not isinstance(binary, bytes):
            raise TypeError(f"{type(self).__name__} expects bytes, got {type(binary)}")
        if binary != _NIL and len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} expects {self.SIZE} bytes, got {len(binary)}"
            )
        self._bytes = binary
        self._hash = hash((self.KIND, binary))

    @classmethod
    def nil(cls):
        return cls(_NIL)

    def is_nil(self) -> bool:
        return self._bytes == _NIL

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    def hex(self) -> str:
        return self._bytes.hex()

    def binary(self) -> bytes:
        return self._bytes

    def __eq__(self, other) -> bool:
        return (
            type(other) is type(self)
            and other._bytes == self._bytes  # noqa: SLF001
        )

    def __hash__(self) -> int:
        return self._hash

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._bytes.hex()[:16]})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


def _derive(kind: bytes, *parts: bytes, size: int) -> bytes:
    h = hashlib.blake2b(digest_size=size)
    h.update(kind)
    for p in parts:
        h.update(len(p).to_bytes(4, "little"))
        h.update(p)
    return h.digest()


class JobID(BaseID):
    SIZE = 4
    KIND = b"J"
    _counter = 0
    _lock = threading.Lock()

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(value.to_bytes(cls.SIZE, "little"))

    def int_value(self) -> int:
        return int.from_bytes(self._bytes, "little")


class NodeID(BaseID):
    SIZE = 16
    KIND = b"N"


class WorkerID(BaseID):
    SIZE = 16
    KIND = b"W"


class ActorID(BaseID):
    SIZE = 16
    KIND = b"A"

    @classmethod
    def of(cls, job_id: JobID, parent_task_id: "TaskID", actor_index: int) -> "ActorID":
        return cls(
            _derive(
                cls.KIND,
                job_id.binary(),
                parent_task_id.binary(),
                actor_index.to_bytes(8, "little"),
                size=cls.SIZE,
            )
        )


class TaskID(BaseID):
    SIZE = 20
    KIND = b"T"

    @classmethod
    def for_driver(cls, job_id: JobID) -> "TaskID":
        return cls(_derive(cls.KIND, b"driver", job_id.binary(), size=cls.SIZE))

    @classmethod
    def for_task(cls, job_id: JobID, parent: "TaskID", index: int) -> "TaskID":
        return cls(
            _derive(
                cls.KIND,
                job_id.binary(),
                parent.binary(),
                index.to_bytes(8, "little"),
                size=cls.SIZE,
            )
        )

    @classmethod
    def for_actor_creation(cls, actor_id: ActorID) -> "TaskID":
        return cls(_derive(cls.KIND, b"actor-creation", actor_id.binary(), size=cls.SIZE))

    @classmethod
    def for_actor_task(
        cls, job_id: JobID, actor_id: ActorID, caller: "TaskID", index: int
    ) -> "TaskID":
        return cls(
            _derive(
                cls.KIND,
                job_id.binary(),
                actor_id.binary(),
                caller.binary(),
                index.to_bytes(8, "little"),
                size=cls.SIZE,
            )
        )


class ObjectID(BaseID):
    SIZE = 24
    KIND = b"O"

    @classmethod
    def for_task_return(cls, task_id: TaskID, return_index: int) -> "ObjectID":
        return cls(
            _derive(
                cls.KIND,
                task_id.binary(),
                return_index.to_bytes(4, "little"),
                size=cls.SIZE,
            )
        )

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        return cls(
            _derive(
                cls.KIND,
                b"put",
                task_id.binary(),
                put_index.to_bytes(4, "little"),
                size=cls.SIZE,
            )
        )


class PlacementGroupID(BaseID):
    SIZE = 16
    KIND = b"P"


ObjectRefID = ObjectID  # alias used by the public ObjectRef wrapper
