"""cgroup-v2 resource isolation of system vs worker processes.

Reference surface: src/ray/common/cgroup2/cgroup_manager.h (CgroupManager —
a node's processes split into a `system` cgroup holding the daemon/store
processes with a guaranteed memory reservation, and a `workers` cgroup whose
memory/cpu are bounded so runaway user code pressures ITSELF before it can
starve the control plane) and sysfs_cgroup_driver.h / fake_cgroup_driver.h
(the real sysfs driver + the in-memory fake every test uses).

Layout under the configured base cgroup:

    <base>/system      daemon, object store, control processes
                       memory.min = system_reserved_memory_bytes
    <base>/workers     every spawned worker process
                       memory.high/max = worker_memory_{high,max}_bytes
                       cpu.weight = worker_cpu_weight

Opt-in via the `cgroup_isolation_enabled` config flag; when the cgroup2
filesystem is absent or unwritable (containers without delegation — the
common dev case) the manager disables itself with one log line and the
daemon runs exactly as before.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

CGROUP_ROOT = "/sys/fs/cgroup"


class CgroupDriver:
    """Filesystem operations of the cgroup2 hierarchy (reference:
    sysfs_cgroup_driver.h). Paths are relative to the cgroup2 root."""

    def available(self) -> bool:
        raise NotImplementedError

    def create(self, path: str) -> None:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    def write(self, path: str, filename: str, value: str) -> None:
        raise NotImplementedError

    def read(self, path: str, filename: str) -> str:
        raise NotImplementedError

    def move_pid(self, path: str, pid: int) -> None:
        self.write(path, "cgroup.procs", str(pid))

    def pids(self, path: str) -> List[int]:
        raw = self.read(path, "cgroup.procs")
        return [int(x) for x in raw.split() if x.strip()]


class SysFsCgroupDriver(CgroupDriver):
    """The real /sys/fs/cgroup (v2) driver."""

    def __init__(self, root: str = CGROUP_ROOT):
        self.root = root

    def _abs(self, path: str) -> str:
        return os.path.join(self.root, path.lstrip("/"))

    def available(self) -> bool:
        # presence of the v2 controllers file is the gate; WRITABILITY is
        # probed by setup() itself (delegated subtrees may be writable even
        # when the root is not)
        return os.path.exists(os.path.join(self.root, "cgroup.controllers"))

    def create(self, path: str) -> None:
        os.makedirs(self._abs(path), exist_ok=True)

    def delete(self, path: str) -> None:
        try:
            os.rmdir(self._abs(path))
        except OSError:
            pass

    def write(self, path: str, filename: str, value: str) -> None:
        with open(os.path.join(self._abs(path), filename), "w") as f:
            f.write(value)

    def read(self, path: str, filename: str) -> str:
        with open(os.path.join(self._abs(path), filename)) as f:
            return f.read()


class FakeCgroupDriver(CgroupDriver):
    """In-memory cgroup tree for tests (reference: fake_cgroup_driver.h) —
    the manager's protocol is exercised without a writable cgroupfs."""

    def __init__(self):
        self.tree: Dict[str, Dict[str, str]] = {"": {}}
        self.deleted: List[str] = []

    def available(self) -> bool:
        return True

    def _norm(self, path: str) -> str:
        return path.strip("/")

    def create(self, path: str) -> None:
        path = self._norm(path)
        parts = path.split("/")
        for i in range(1, len(parts) + 1):
            self.tree.setdefault("/".join(parts[:i]), {})

    def delete(self, path: str) -> None:
        path = self._norm(path)
        self.tree.pop(path, None)
        self.deleted.append(path)

    def write(self, path: str, filename: str, value: str) -> None:
        path = self._norm(path)
        if path not in self.tree:
            raise FileNotFoundError(path)
        if filename == "cgroup.procs":
            # cgroup2 semantics: writing a pid MOVES it from its old group
            for files in self.tree.values():
                pids = files.get("cgroup.procs", "").split()
                if value in pids:
                    pids.remove(value)
                    files["cgroup.procs"] = "\n".join(pids)
            existing = self.tree[path].get("cgroup.procs", "")
            self.tree[path]["cgroup.procs"] = (
                existing + "\n" + value if existing else value)
            return
        self.tree[path][filename] = value

    def read(self, path: str, filename: str) -> str:
        path = self._norm(path)
        return self.tree.get(path, {}).get(filename, "")


class CgroupManager:
    """Builds and owns the node's system/workers split (reference:
    cgroup_manager.h). All failures degrade to no-isolation."""

    def __init__(self, base: str, driver: Optional[CgroupDriver] = None, *,
                 system_reserved_memory_bytes: int = 0,
                 worker_memory_high_bytes: int = 0,
                 worker_memory_max_bytes: int = 0,
                 worker_cpu_weight: int = 0):
        self.base = base.strip("/")
        self.driver = driver or SysFsCgroupDriver()
        self.system_reserved = system_reserved_memory_bytes
        self.worker_high = worker_memory_high_bytes
        self.worker_max = worker_memory_max_bytes
        self.worker_cpu_weight = worker_cpu_weight
        self.enabled = False

    @property
    def system_path(self) -> str:
        return f"{self.base}/system"

    @property
    def workers_path(self) -> str:
        return f"{self.base}/workers"

    def setup(self, system_pids: Optional[List[int]] = None) -> bool:
        """Create the hierarchy, enable controllers, apply limits, and move
        the system processes in. Returns whether isolation is active."""
        d = self.driver
        if not d.available():
            logger.info("cgroup2 unavailable/unwritable: worker isolation "
                        "disabled")
            return False
        try:
            d.create(self.base)
            # leaf groups must exist BEFORE subtree_control (no-internal-
            # process rule: the base keeps no processes of its own)
            d.create(self.system_path)
            d.create(self.workers_path)
            # controllers must be delegated down EVERY ancestor or the
            # base's cgroup.controllers will lack memory/cpu and the leaf
            # limits below fail (cgroup2 top-down delegation)
            parts = self.base.split("/")
            for depth in range(len(parts)):
                ancestor = "/".join(parts[:depth]) if depth else ""
                try:
                    d.write(ancestor, "cgroup.subtree_control",
                            "+memory +cpu")
                except OSError:
                    if depth == 0:
                        # root-level delegation is often pre-configured (or
                        # forbidden in delegated subtrees): tolerate, the
                        # base-level write below is the authoritative check
                        continue
                    raise
            d.write(self.base, "cgroup.subtree_control", "+memory +cpu")
            if self.system_reserved > 0:
                d.write(self.system_path, "memory.min",
                        str(self.system_reserved))
            if self.worker_high > 0:
                d.write(self.workers_path, "memory.high",
                        str(self.worker_high))
            if self.worker_max > 0:
                d.write(self.workers_path, "memory.max",
                        str(self.worker_max))
            if self.worker_cpu_weight > 0:
                d.write(self.workers_path, "cpu.weight",
                        str(self.worker_cpu_weight))
            for pid in system_pids or []:
                d.move_pid(self.system_path, pid)
        except OSError as e:
            logger.warning("cgroup setup failed (%s): worker isolation "
                           "disabled", e)
            return False
        self.enabled = True
        return True

    def add_system_process(self, pid: int) -> None:
        if not self.enabled:
            return
        try:
            self.driver.move_pid(self.system_path, pid)
        except OSError:  # noqa: PERF203 — raced process exit
            pass

    def add_worker(self, pid: int) -> None:
        """Confine one spawned worker process."""
        if not self.enabled:
            return
        try:
            self.driver.move_pid(self.workers_path, pid)
        except OSError:
            pass  # worker died before confinement; fate-sharing reaps it

    def cleanup(self) -> None:
        """Tear the hierarchy down (processes still inside fall back to the
        parent cgroup when the dirs are removed after they exit)."""
        if not self.enabled:
            return
        for path in (self.workers_path, self.system_path, self.base):
            self.driver.delete(path)
        self.enabled = False


def manager_from_config(session_name: str) -> Optional[CgroupManager]:
    """Build the daemon's manager when the config flag is on; None keeps
    the daemon entirely cgroup-free."""
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    if not GLOBAL_CONFIG.get("cgroup_isolation_enabled"):
        return None
    return CgroupManager(
        f"ray_tpu_torch/{session_name}",
        system_reserved_memory_bytes=GLOBAL_CONFIG.get(
            "cgroup_system_reserved_memory_bytes"),
        worker_memory_high_bytes=GLOBAL_CONFIG.get(
            "cgroup_worker_memory_high_bytes"),
        worker_memory_max_bytes=GLOBAL_CONFIG.get(
            "cgroup_worker_memory_max_bytes"),
        worker_cpu_weight=GLOBAL_CONFIG.get("cgroup_worker_cpu_weight"),
    )


__all__ = ["CgroupDriver", "CgroupManager", "FakeCgroupDriver",
           "SysFsCgroupDriver", "manager_from_config"]
