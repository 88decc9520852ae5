"""Multi-node test clusters on one machine.

Capability parity with the reference's cluster test vehicle (reference:
python/ray/cluster_utils.py:141 Cluster — starts multiple real raylets + one
GCS as subprocesses on a single machine, the backbone of every multi-node
integration test). Each added node is a real node-daemon subprocess with its
own shared-memory object store.

Scale plane: `add_sim_nodes(count)` attaches a simulated-node plane — ONE
subprocess speaking the full node-daemon control protocol for `count` nodes
(no worker pools / object stores; see _private/simnode.py) — so a test can
put 500-1000 registered, heartbeating nodes behind the same control store
its few REAL daemons use.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import uuid
from dataclasses import dataclass
from typing import Dict, List, Optional

from ray_tpu_torch._private import node as node_mod
from ray_tpu_torch._private.config import GLOBAL_CONFIG


@dataclass
class NodeHandle:
    proc: subprocess.Popen
    address: str
    node_id: str
    store_name: str


@dataclass
class SimPlaneHandle:
    proc: subprocess.Popen
    count: int
    node_ids: List[str]
    register_storm_s: float


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 head_resources: Optional[Dict[str, float]] = None,
                 head_labels: Optional[Dict[str, str]] = None):
        self.session_dir = node_mod.new_session_dir()
        self.cs_proc, self.address = node_mod.start_control_store(self.session_dir)
        self.nodes: List[NodeHandle] = []
        self.sim_planes: List[SimPlaneHandle] = []
        self.standby_proc: Optional[subprocess.Popen] = None
        if GLOBAL_CONFIG.get("store_standby_enabled"):
            self.standby_proc = node_mod.start_standby_store(
                self.session_dir, self.address)
        if initialize_head:
            self.add_node(resources=head_resources, labels=head_labels)

    def start_standby(self) -> subprocess.Popen:
        """Attach a warm-standby control store (idempotent: one per
        cluster). Kill the primary (`kill_primary_store`) and the standby
        takes over at the same address."""
        if self.standby_proc is None or self.standby_proc.poll() is not None:
            self.standby_proc = node_mod.start_standby_store(
                self.session_dir, self.address)
        return self.standby_proc

    def kill_primary_store(self):
        """SIGKILL the primary control store (failover drills). The
        standby — if one is attached — recovers at the same address;
        `node._wait_ready(standby_proc.standby_ready_file, standby_proc)`
        blocks until it serves. The handles swap: the standby IS the
        primary now, so a later start_standby() attaches a fresh one and a
        second kill_primary_store() kills the right process."""
        node_mod.kill_process(self.cs_proc, force=True)
        if self.standby_proc is not None:
            self.cs_proc = self.standby_proc
            self.standby_proc = None

    @property
    def head_node(self) -> NodeHandle:
        return self.nodes[0]

    def add_node(self, resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None) -> NodeHandle:
        proc, info = node_mod.start_node_daemon(
            self.address, self.session_dir, resources=resources, labels=labels
        )
        handle = NodeHandle(
            proc=proc,
            address=info["address"],
            node_id=info["node_id"],
            store_name=info["store_name"],
        )
        self.nodes.append(handle)
        return handle

    def add_sim_nodes(self, count: int,
                      resources: Optional[Dict[str, float]] = None,
                      seed: Optional[int] = None,
                      timeout: float = 120.0) -> SimPlaneHandle:
        """Attach `count` simulated nodes (one subprocess hosting the whole
        plane). Blocks until every simnode has registered."""
        ready = os.path.join(
            self.session_dir, f"sim_ready_{uuid.uuid4().hex[:6]}.json")
        log = open(os.path.join(
            self.session_dir, "logs",
            f"simnodes_{uuid.uuid4().hex[:6]}.log"), "ab")
        cmd = [
            sys.executable, "-m", "ray_tpu_torch._private.simnode",
            "--control-address", self.address,
            "--count", str(count),
            "--ready-file", ready,
            "--config-json", GLOBAL_CONFIG.serialize_overrides(),
        ]
        if seed is not None:
            cmd += ["--seed", str(seed)]
        if resources:
            cmd += ["--resources", json.dumps(resources)]
        proc = subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True,
            env={**os.environ, "RT_CHAOS_ROLE": "simplane"},
        )
        log.close()
        info = node_mod._wait_ready(ready, proc, timeout=timeout)
        handle = SimPlaneHandle(
            proc=proc, count=info["count"],
            node_ids=info.get("node_ids", []),
            register_storm_s=info.get("register_storm_s", 0.0),
        )
        self.sim_planes.append(handle)
        return handle

    def kill_node(self, node: NodeHandle, force: bool = True):
        node_mod.kill_process(node.proc, force=force)
        if node in self.nodes:
            self.nodes.remove(node)

    def shutdown(self):
        for n in list(self.nodes):
            self.kill_node(n)
        for sp in list(self.sim_planes):
            node_mod.kill_process(sp.proc, force=True)
        self.sim_planes.clear()
        node_mod.kill_process(self.cs_proc, force=True)
        if self.standby_proc is not None:
            node_mod.kill_process(self.standby_proc, force=True)
            self.standby_proc = None
