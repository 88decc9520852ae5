"""StorageContext: one URI-addressed filesystem plane for the port's
checkpoints — a copy of the JAX package's ``train/_storage.py`` (the port
imports nothing of that package), with the same behaviour.

Reference: python/ray/train/v2/_internal/execution/storage.py (fsspec/
pyarrow-backed StorageContext behind `storage_path` — local dirs, NFS,
s3://, gs://). Here fsspec carries every scheme it knows (file, memory, s3,
gs, ...); plain paths resolve to the local filesystem, including atomic
finalize (rename) where the backend supports it.
"""

from __future__ import annotations

import json
import os
import posixpath
from typing import Any, List


class StorageContext:
    """Filesystem operations rooted at a URI."""

    def __init__(self, uri: str):
        import fsspec

        self.uri = uri
        self.fs, self.root = fsspec.core.url_to_fs(uri)
        self._local = type(self.fs).__name__ == "LocalFileSystem"

    # -- paths ----------------------------------------------------------

    def join(self, *parts: str) -> str:
        if self._local:
            return os.path.join(*parts)
        return posixpath.join(*parts)

    def basename(self, path: str) -> str:
        return posixpath.basename(path.rstrip("/"))

    # -- directory ops ---------------------------------------------------

    def makedirs(self, path: str) -> None:
        self.fs.makedirs(path, exist_ok=True)

    def exists(self, path: str) -> bool:
        return self.fs.exists(path)

    def isdir(self, path: str) -> bool:
        return self.fs.isdir(path)

    def listdir(self, path: str) -> List[str]:
        if not self.fs.isdir(path):
            return []
        return sorted(self.basename(p) for p in self.fs.ls(path, detail=False))

    def delete(self, path: str) -> None:
        try:
            self.fs.rm(path, recursive=True)
        except FileNotFoundError:
            pass

    def rename(self, src: str, dst: str) -> None:
        """Atomic on local filesystems; move (copy+delete) elsewhere —
        finalize protocols must tolerate either."""
        if self._local:
            os.replace(src, dst)
            return
        self.fs.mv(src, dst, recursive=True)

    # -- file ops ---------------------------------------------------------

    def open(self, path: str, mode: str = "rb"):
        if "w" in mode or "a" in mode:
            parent = posixpath.dirname(path) if not self._local \
                else os.path.dirname(path)
            if parent:
                self.makedirs(parent)
        return self.fs.open(path, mode)

    def write_bytes(self, path: str, data: bytes) -> None:
        with self.open(path, "wb") as f:
            f.write(data)

    def read_bytes(self, path: str) -> bytes:
        with self.open(path, "rb") as f:
            return f.read()

    def write_json(self, path: str, obj: Any) -> None:
        def coerce(o):
            try:
                return float(o)  # numpy/jax scalars from user metrics
            except (TypeError, ValueError):
                return str(o)

        self.write_bytes(path, json.dumps(obj, default=coerce).encode())

    def read_json(self, path: str) -> Any:
        return json.loads(self.read_bytes(path).decode())

    def download_dir(self, src: str, local_dir: str) -> None:
        """Recursively copy a storage directory to the local filesystem."""
        os.makedirs(local_dir, exist_ok=True)
        # fs.find returns protocol-stripped paths; strip the base the same
        # way or file:// sources produce ../-laden relative paths
        base = self.fs._strip_protocol(src.rstrip("/"))
        for path in self.fs.find(base):
            rel = os.path.relpath(path, base)
            out = os.path.join(local_dir, rel)
            os.makedirs(os.path.dirname(out), exist_ok=True)
            with open(out, "wb") as f:
                f.write(self.read_bytes(path))


def get_storage(uri_or_path: str) -> StorageContext:
    # no cache: construction is cheap and fsspec already caches filesystem
    # instances per protocol (a per-path cache would grow unbounded across
    # a training run's per-checkpoint paths)
    return StorageContext(uri_or_path)
