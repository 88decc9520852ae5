"""GCP provider: GCE GPU worker instances + whole NVLink domains behind the
autoscaler's provider interface.

The port's counterpart of ``ray_tpu/autoscaler/gcp.py``, whose provider
creates CPU worker VMs through the GCE API and whole TPU slices through
the TPU API. Here both go through the GCE API: a worker is one instance,
and an NVLink domain is ``hosts`` instances of its pod type's machine type
(an A3 / A4 VM is one domain of 1-8 GPUs; a GB200 NVL72 rack is 18 hosts of
4), created one insert a host so each host's metadata carries its index.

Reference surface: python/ray/autoscaler/_private/gcp/node_provider.py
(+ node.py's GCPCompute resource wrapper) and the v2 instance manager
(autoscaler/v2/instance_manager/instance_manager.py:29). The REST calls go
through a swappable `GcpTransport` seam, so the exact production code
paths run offline against `FakeGcpTransport` (the reference tests the same
way via fake_multi_node). The fake simulates instance/operation lifecycles
and "boots" created machines through a callback; a test's callback spawns
real local node daemons with the labels a VM's startup script would pass,
so autoscaler → provider → API → boot → daemon-joins is exercised end to
end.

Auth on real GCE rides the metadata server's default service-account
token (the standard in-cluster credential; no SDK dependency).

A machine's startup script labels the daemon it starts with
``INSTANCE_LABEL`` = its own instance name (which every GCE VM reads from
its metadata server, and the fake's ``boot`` receives as ``name``). Each
handle names that label in ``match_labels``, so the autoscaler finds the
daemon a VM booted in the store's node table and takes its node id; the
JAX package's provider, with no such label, matches nothing.
"""

from __future__ import annotations

import itertools
import json
import logging
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.autoscaler import NodeProvider, SliceSpec

logger = logging.getLogger(__name__)

_GCE_API = "https://compute.googleapis.com/compute/v1"
_METADATA_TOKEN = ("http://metadata.google.internal/computeMetadata/v1/"
                   "instance/service-accounts/default/token")

# pod type -> (GCE machine type, hosts, GPUs a host) for the domain shapes
# the provider knows how to ask GCE for. A3 / A4 machine types come with
# their GPUs attached (no guestAccelerators list).
ACCELERATOR_TYPES: Dict[str, Dict[str, Any]] = {
    "H100-1": {"machine_type": "a3-highgpu-1g", "hosts": 1,
               "gpus_per_host": 1},
    "H100-2": {"machine_type": "a3-highgpu-2g", "hosts": 1,
               "gpus_per_host": 2},
    "H100-4": {"machine_type": "a3-highgpu-4g", "hosts": 1,
               "gpus_per_host": 4},
    "H100-8": {"machine_type": "a3-highgpu-8g", "hosts": 1,
               "gpus_per_host": 8},
    "H200-8": {"machine_type": "a3-ultragpu-8g", "hosts": 1,
               "gpus_per_host": 8},
    "B200-8": {"machine_type": "a4-highgpu-8g", "hosts": 1,
               "gpus_per_host": 8},
    "GB200-72": {"machine_type": "a4x-highgpu-4g", "hosts": 18,
                 "gpus_per_host": 4},
}

# the node label a machine's startup script gives its daemon: the
# instance's own name
INSTANCE_LABEL = "gce-instance"

# instance states in which the machine exists and runs or is about to
# (GCE's lifecycle: PROVISIONING -> STAGING -> RUNNING -> STOPPING ->
# TERMINATED, then gone once deleted)
_LIVE_STATES = ("PROVISIONING", "STAGING", "RUNNING")

# GCE refuses live migration for a VM with GPUs: it must stop on host
# maintenance
_GPU_SCHEDULING = {"onHostMaintenance": "TERMINATE"}


class GcpTransport:
    """The HTTP seam: request(method, url, body) -> parsed JSON."""

    def request(self, method: str, url: str,
                body: Optional[dict] = None) -> dict:
        raise NotImplementedError


class GceTransport(GcpTransport):
    """Real transport: bearer token from the GCE metadata server."""

    def __init__(self, timeout: float = 30.0):
        self.timeout = timeout
        self._token: Optional[str] = None
        self._token_expiry = 0.0

    def _auth(self) -> str:
        if self._token is None or time.time() >= self._token_expiry - 60:
            req = urllib.request.Request(
                _METADATA_TOKEN, headers={"Metadata-Flavor": "Google"})
            with urllib.request.urlopen(req, timeout=10) as resp:
                tok = json.loads(resp.read())
            self._token = tok["access_token"]
            self._token_expiry = time.time() + tok.get("expires_in", 300)
        return self._token

    def request(self, method: str, url: str,
                body: Optional[dict] = None) -> dict:
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            url, data=data, method=method,
            headers={
                "Authorization": f"Bearer {self._auth()}",
                "Content-Type": "application/json",
            })
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            payload = resp.read()
        return json.loads(payload) if payload else {}


def _items(metadata: dict) -> Dict[str, str]:
    """A GCE metadata block's items as a dict."""
    return {i["key"]: i["value"] for i in (metadata or {}).get("items", ())}


class FakeGcpTransport(GcpTransport):
    """Offline simulation of the GCE REST surface: insert/get/delete of
    instances plus operation polling. A created instance calls `boot`
    (name, kind, labels, metadata) — kind "gce" for a worker, "domain" for
    a domain host, metadata its items as a dict; tests hook this to spawn
    real local daemons, which is exactly the role of a VM's startup
    script. `boot` returns a cleanup callable, which the instance's DELETE
    calls."""

    def __init__(self, boot: Optional[Callable[..., Any]] = None,
                 op_latency: int = 1):
        self.boot = boot
        self.op_latency = op_latency  # GETs until an operation reports done
        self.instances: Dict[str, dict] = {}
        self.ops: Dict[str, dict] = {}
        self.booted: Dict[str, Any] = {}
        self.calls: List[tuple] = []
        self._op_counter = itertools.count(1)

    def _mk_op(self, target: str) -> dict:
        name = f"op-{next(self._op_counter)}"
        self.ops[name] = {"name": name, "target": target,
                          "polls_left": self.op_latency}
        return {"name": name, "done": self.op_latency == 0}

    def _poll_op(self, name: str) -> dict:
        op = self.ops[name]
        op["polls_left"] = max(0, op["polls_left"] - 1)
        return {"name": name, "done": op["polls_left"] == 0}

    def request(self, method: str, url: str,
                body: Optional[dict] = None) -> dict:
        self.calls.append((method, url))
        # operations
        if "/operations/" in url:
            return self._poll_op(url.rsplit("/", 1)[-1])
        if "compute.googleapis.com" in url and "/instances" in url:
            if method == "POST":
                name = (body or {}).get("name", "inst")
                inst = dict(body or {})
                inst["status"] = "RUNNING"
                self.instances[name] = inst
                if self.boot is not None:
                    labels = inst.get("labels", {})
                    kind = ("domain" if labels.get("rt-kind") == "domain"
                            else "gce")
                    self.booted[name] = self.boot(
                        name, kind, labels, _items(inst.get("metadata")))
                return self._mk_op(name)
            name = url.rsplit("/", 1)[-1]
            if method == "DELETE":
                self.instances.pop(name, None)
                handle = self.booted.pop(name, None)
                if handle is not None and hasattr(handle, "__call__"):
                    handle()
                return self._mk_op(name)
            if method == "GET":
                inst = self.instances.get(name)
                return dict(inst, name=name) if inst else {
                    "error": "notFound"}
        raise ValueError(f"FakeGcpTransport: unhandled {method} {url}")


class GpuVmNodeProvider(NodeProvider):
    """Autoscaler provider provisioning GCE worker VMs (create_node) and
    whole NVLink domains of GPU VMs (create_slice). The startup metadata
    each machine receives tells its boot script how to join the cluster —
    identical in spirit to the reference's `ray start` startup commands."""

    _counter = itertools.count(1)

    def __init__(self, project: str, zone: str,
                 control_address: str,
                 transport: Optional[GcpTransport] = None,
                 machine_type: str = "n2-standard-8",
                 cluster_name: str = "rt"):
        self.project = project
        self.zone = zone
        self.control_address = control_address
        self.transport = transport or GceTransport()
        self.machine_type = machine_type
        self.cluster_name = cluster_name

    # -- REST helpers ---------------------------------------------------

    def _gce_base(self) -> str:
        return (f"{_GCE_API}/projects/{self.project}/zones/{self.zone}")

    def _machine_type(self, machine_type: str) -> str:
        return f"zones/{self.zone}/machineTypes/{machine_type}"

    def _wait_op(self, base: str, op: dict, timeout: float = 300.0):
        deadline = time.monotonic() + timeout
        while not op.get("done"):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"GCP operation {op.get('name')} stuck")
            time.sleep(min(2.0, max(0.05, deadline - time.monotonic())))
            op = self.transport.request(
                "GET", f"{base}/operations/{op['name']}")

    # -- worker VMs -----------------------------------------------------

    def create_node(self, resources: Dict[str, float]) -> Any:
        name = f"{self.cluster_name}-worker-{next(self._counter):04d}"
        body = {
            "name": name,
            "machineType": self._machine_type(self.machine_type),
            "labels": {"rt-cluster": self.cluster_name, "rt-kind": "worker"},
            "metadata": {"items": [
                {"key": "rt-control-address", "value": self.control_address},
                {"key": "rt-resources", "value": json.dumps(resources)},
            ]},
        }
        if resources.get("GPU"):
            body["scheduling"] = dict(_GPU_SCHEDULING)
        op = self.transport.request(
            "POST", f"{self._gce_base()}/instances?name={name}", body)
        self._wait_op(self._gce_base(), op)
        logger.info("gcp: launched worker VM %s", name)
        # node_id is the instance name (as in the JAX package) until the
        # autoscaler matches the daemon the VM boots by its label
        return {"name": name, "kind": "gce", "node_id": name,
                "match_labels": {INSTANCE_LABEL: name}, "proc": _NoProc()}

    def node_alive(self, handle: Any) -> bool:
        """Whether the instance behind a worker or host handle exists in a
        live state; a domain handle (``nodes``) is alive while any of its
        hosts is. An answer other than the instance or its absence (the
        API unreachable) counts as alive: the store's records decide."""
        if "nodes" in handle:
            return any(self.node_alive(n) for n in handle["nodes"])
        try:
            inst = self.transport.request(
                "GET", f"{self._gce_base()}/instances/{handle['name']}")
        except urllib.error.HTTPError as e:
            return e.code != 404
        except OSError:
            return True
        return inst.get("status") in _LIVE_STATES

    def terminate_node(self, handle: Any) -> None:
        op = self.transport.request(
            "DELETE", f"{self._gce_base()}/instances/{handle['name']}")
        self._wait_op(self._gce_base(), op)

    # -- NVLink domains -------------------------------------------------

    def create_slice(self, pod_type: str, spec: SliceSpec) -> Dict[str, Any]:
        acc = ACCELERATOR_TYPES.get(pod_type, {})
        if acc and spec.hosts != acc["hosts"]:
            # a GB200-72 rack always boots 18 hosts: a config that tracks
            # fewer would leave hosts outside the gang (and more could
            # never join) — fail the launch instead of wedging placement
            raise ValueError(
                f"slice_types[{pod_type!r}].hosts={spec.hosts} but a "
                f"{acc['machine_type']} domain has {acc['hosts']} hosts")
        name = (f"{self.cluster_name}-{pod_type.lower()}-"
                f"{next(self._counter):04d}")
        machine_type = acc.get("machine_type", pod_type)
        hosts = [f"{name}-{h}" for h in range(spec.hosts)]
        ops = []
        for h, host in enumerate(hosts):
            body = {
                "name": host,
                "machineType": self._machine_type(machine_type),
                # GCE label values are lower case; the metadata keeps the
                # pod type as the head resource spells it
                "labels": {
                    "rt-cluster": self.cluster_name,
                    "rt-kind": "domain",
                    "rt-pod-type": pod_type.lower(),
                },
                "metadata": {"items": [
                    {"key": "rt-control-address",
                     "value": self.control_address},
                    {"key": "rt-hosts", "value": str(spec.hosts)},
                    {"key": "rt-resources",
                     "value": json.dumps(spec.resources_per_host)},
                    {"key": "rt-slice-name", "value": name},
                    {"key": "rt-pod-type", "value": pod_type},
                    {"key": "rt-host-index", "value": str(h)},
                ]},
                "scheduling": dict(_GPU_SCHEDULING),
            }
            ops.append(self.transport.request(
                "POST", f"{self._gce_base()}/instances?name={host}", body))
        for op in ops:
            self._wait_op(self._gce_base(), op)
        for host in hosts:
            inst = self.transport.request(
                "GET", f"{self._gce_base()}/instances/{host}")
            if inst.get("status") != "RUNNING":
                raise RuntimeError(
                    f"GCE instance {host} in state {inst.get('status')}")
        logger.info("gcp: provisioned NVLink domain %s (%d x %s)", name,
                    spec.hosts, machine_type)
        # hosts register themselves as daemons when their startup script
        # runs; the autoscaler matches each by its instance label, so
        # handle-level procs are placeholders
        return {"slice_name": name, "pod_type": pod_type,
                "nodes": [{"name": host, "host": h,
                           "node_id": f"{name}/{h}",
                           "match_labels": {INSTANCE_LABEL: host},
                           "proc": _NoProc()}
                          for h, host in enumerate(hosts)]}

    def terminate_slice(self, handle: Dict[str, Any]) -> None:
        ops = [self.transport.request(
            "DELETE", f"{self._gce_base()}/instances/{n['name']}")
            for n in handle["nodes"]]
        for op in ops:
            self._wait_op(self._gce_base(), op)


class _NoProc:
    """Cloud machines have no local process handle; ``node_alive`` asks
    the API instead."""

    def poll(self):
        return None


__all__ = [
    "ACCELERATOR_TYPES",
    "FakeGcpTransport",
    "GceTransport",
    "GcpTransport",
    "GpuVmNodeProvider",
    "INSTANCE_LABEL",
]
