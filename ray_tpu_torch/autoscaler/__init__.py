"""Autoscaler: reconcile cluster size against scheduling demand.

The port's counterpart of ``ray_tpu/autoscaler/__init__.py``: every
decision is the JAX package's (the drain, undrain and terminate calls,
the preemption replacements, the batched ``create_nodes`` storm path),
with TPU slices replaced by NVLink domains (``gpu/slice.py``): a pending
``GPU-{pod_type}-head`` reservation provisions a whole domain, whose hosts
carry the ``gpu-domain-name``, ``gpu-pod-type`` and ``rt.gpu.coord``
labels gang placement reads.

Where the JAX package's decisions cannot work, the port's differ: a cloud
provider's handle carries ``match_labels``, and the node id of the daemon
whose labels hold them replaces the handle's own (``_match_booted``), so a
cloud worker counts as launching only until its daemon registers and
scales in as a local one does; a domain all of whose hosts were matched
so drains and terminates as a whole once every host idles past the
timeout. Providers whose handles carry the daemons' own ids keep JAX's
decisions exactly.

Reference surface: python/ray/autoscaler/v2/autoscaler.py:51 (Autoscaler),
v2/scheduler.py:895 (ResourceDemandScheduler bin-packing pending demand
into node types), v2/instance_manager (provider reconciliation), and the
fake_multi_node provider used as the test vehicle
(python/ray/autoscaler/_private/fake_multi_node/node_provider.py).

Shape: a reconciler polls the control store's cluster-load aggregate,
derives desired capacity from EVERY pending-demand source — unmet lease
shapes from daemon heartbeats, unplaced placement-group bundles,
queued-job resource requests from the job plane, and demand pushed via
`report_demand` (elastic train posts its target width there) — bin-packs
the remainder into the provider's node type, launches up to max_workers
nodes, and drains + terminates nodes idle past idle_timeout_s (graceful
drain first, never a kill). The `demand_driven` lever collapses the
demand sources back to heartbeat shapes only — the liveness-reactive
baseline the bench A/Bs against.

Runs driver-side (through the core worker's control connection) or
standalone against a `control_address` (its own RPC client on an owned
event loop — the bench/daemon mode, no driver required).
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.config import GLOBAL_CONFIG

logger = logging.getLogger(__name__)


class NodeProvider:
    """Provider ABC (reference: autoscaler/node_provider.py). Providers
    that can provision whole NVLink domains additionally implement
    create_slice/terminate_slice (the autoscaler detects the capability
    with hasattr, not a concrete class check)."""

    def create_node(self, resources: Dict[str, float]) -> Any:
        raise NotImplementedError

    def terminate_node(self, handle: Any) -> None:
        raise NotImplementedError

    def node_alive(self, handle: Any) -> bool:
        """Whether the provider-side node behind `handle` still runs —
        the reconciler prunes handles whose nodes died out-of-band. A
        provider that can't tell returns True (the control store's death
        records remain the arbiter)."""
        return True


class LocalNodeProvider(NodeProvider):
    """Spawns node-daemon subprocesses on this machine — the counterpart of
    the reference's fake_multi_node provider (laptop-scale e2e autoscaling
    tests without a cloud)."""

    def __init__(self, control_address: str, session_dir: str):
        self.control_address = control_address
        self.session_dir = session_dir

    def create_node(self, resources: Dict[str, float]) -> Any:
        from ray_tpu_torch._private import node as node_mod

        proc, info = node_mod.start_node_daemon(
            self.control_address, self.session_dir, resources=dict(resources))
        return {"proc": proc, "node_id": info["node_id"],
                "address": info["address"]}

    def terminate_node(self, handle: Any) -> None:
        from ray_tpu_torch._private import node as node_mod

        node_mod.kill_process(handle["proc"])

    def node_alive(self, handle: Any) -> bool:
        return handle["proc"].poll() is None


@dataclass
class SliceSpec:
    """Shape of one NVLink domain's node group: `hosts` daemons, each
    exposing `resources_per_host`, host 0 additionally carrying the
    `GPU-{pod_type}-head` reservation resource. All hosts share a
    gpu-domain-name label and carry row-major coordinates (rt.gpu.coord)
    for TOPOLOGY_STRICT_PACK (the JAX package's TPU slice node group;
    reference: python/ray/_private/accelerators/tpu.py:345)."""

    hosts: int = 2
    resources_per_host: Dict[str, float] = field(
        default_factory=lambda: {"CPU": 1.0, "GPU": 1.0})


class SliceNodeProvider(LocalNodeProvider):
    """Provisions WHOLE NVLink domains as labeled node groups. The local
    implementation spawns labeled node daemons (the counterpart of the
    reference's fake_multi_node provider); a cloud provider overrides
    create_slice/terminate_slice with its own calls (``gcp.py``: GCE GPU
    instances; reference:
    autoscaler/v2/instance_manager/instance_manager.py:29)."""

    _counter = 0

    def create_slice(self, pod_type: str, spec: SliceSpec) -> Dict[str, Any]:
        from ray_tpu_torch._private import node as node_mod
        from ray_tpu_torch._private import protocol as pb

        SliceNodeProvider._counter += 1
        slice_name = f"{pod_type}-domain-{SliceNodeProvider._counter:04d}"
        nodes = []
        for h in range(spec.hosts):
            resources = dict(spec.resources_per_host)
            if h == 0:
                # one reservation token per domain (reference: tpu.py:345
                # TPU-{pod_type}-head on worker 0)
                resources[f"GPU-{pod_type}-head"] = 1.0
            labels = {
                "gpu-domain-name": slice_name,
                "gpu-pod-type": pod_type,
                pb.GPU_COORD_LABEL: f"0,{h}",  # row-major line topology
            }
            proc, info = node_mod.start_node_daemon(
                self.control_address, self.session_dir,
                resources=resources, labels=labels)
            nodes.append({"proc": proc, "node_id": info["node_id"],
                          "address": info["address"]})
        return {"slice_name": slice_name, "pod_type": pod_type,
                "nodes": nodes}

    def terminate_slice(self, handle: Dict[str, Any]) -> None:
        for n in handle["nodes"]:
            self.terminate_node(n)


@dataclass
class AutoscalingConfig:
    """Reference: autoscaler config (max_workers, idle timeout,
    upscaling_speed). Defaults come from the `autoscaler_*` config flags
    so a cluster-wide override reaches every constructed autoscaler."""

    min_workers: int = 0
    max_workers: int = field(
        default_factory=lambda: GLOBAL_CONFIG.get("autoscaler_max_workers"))
    worker_resources: Dict[str, float] = field(
        default_factory=lambda: {"CPU": 2.0})
    idle_timeout_s: float = field(
        default_factory=lambda: GLOBAL_CONFIG.get("autoscaler_idle_timeout_s"))
    poll_period_s: float = field(
        default_factory=lambda: GLOBAL_CONFIG.get("autoscaler_poll_period_s"))
    # demand-driven mode folds job-plane queue demand and pushed
    # report_demand shapes into scale-up; False = liveness-reactive
    # baseline (heartbeat lease shapes only) — the bench's A/B lever
    demand_driven: bool = field(
        default_factory=lambda: GLOBAL_CONFIG.get("autoscaler_demand_driven"))
    # domain-aware scale-up: pod type -> node-group shape; infeasible
    # GPU-{type}-head demand (pending domain placement groups) provisions
    # whole domains through SliceNodeProvider.create_slice
    slice_types: Dict[str, SliceSpec] = field(default_factory=dict)
    max_slices: int = 4
    # proactive preemption survival: PREEMPTING nodes' committed load is
    # treated as demand NOW (replacements launch during the notice window)
    # and the drain starts only once a replacement registers or the
    # deadline forces it. False = reactive baseline: capacity is replaced
    # only after the node death — the bench_preempt A/B lever
    preempt_proactive: bool = field(
        default_factory=lambda: GLOBAL_CONFIG.get("preempt_proactive"))


class Autoscaler:
    """Reconciler loop (reference: v2/autoscaler.py:51 update())."""

    def __init__(self, provider: NodeProvider, config: AutoscalingConfig,
                 control_address: Optional[str] = None):
        self.provider = provider
        self.config = config
        # standalone mode: own RPC client to this control address instead
        # of riding a driver's core-worker connection
        self.control_address = control_address
        self._client = None
        self._client_loop: Optional[asyncio.AbstractEventLoop] = None
        self._client_thread: Optional[threading.Thread] = None
        self.workers: List[dict] = []  # provider handles for launched nodes
        self.slices: List[dict] = []   # provider handles for launched slices
        self._idle_since: Dict[str, float] = {}
        self._draining: Dict[str, float] = {}
        # delta-maintained node rows (scale plane): each poll asks the
        # control store only for rows whose availability/load CHANGED since
        # the cursor — at 1000 nodes the full row set per poll is the cost
        self._load_rows: Dict[str, dict] = {}
        self._load_cursor = -1
        # proactive preemption tracking: preempting node_id hex -> {
        #   "baseline": alive node ids when its notice first appeared,
        #   "deadline_ts": wall-clock reclaim deadline,
        #   "replacement": node id assigned as its replacement (or None)}
        self._preempt_pending: Dict[str, dict] = {}
        # counters the bench/chaos tests assert on (launches that happened
        # while a notice was outstanding = capacity provisioned BEFORE the
        # death, the whole point of the proactive mode)
        self.preempt_stats = {
            "notices_seen": 0, "launched_during_notice": 0,
            "drains_started": 0,
        }
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- control-plane transport ----------------------------------------

    def _ensure_client(self):
        from ray_tpu_torch.runtime.rpc import RpcClient

        if self._client is not None:
            return
        self._client_loop = asyncio.new_event_loop()
        self._client_thread = threading.Thread(
            target=self._client_loop.run_forever,
            name="autoscaler-rpc", daemon=True)
        self._client_thread.start()

        async def mk():
            c = RpcClient(self.control_address, name="autoscaler->cs")
            await c.connect()
            return c

        self._client = asyncio.run_coroutine_threadsafe(
            mk(), self._client_loop).result(30)

    def _control_call(self, method: str, payload: dict,
                      timeout: float = 30.0) -> dict:
        if self.control_address is not None:
            self._ensure_client()
            return asyncio.run_coroutine_threadsafe(
                self._client.call(method, payload, timeout=timeout),
                self._client_loop).result(timeout + 5)
        from ray_tpu_torch._private.core_worker import get_core_worker

        cw = get_core_worker()
        return cw.run_sync(cw.control.call(method, payload), timeout)

    def _close_client(self):
        if self._client is None:
            return
        client, loop = self._client, self._client_loop
        self._client = None
        try:
            asyncio.run_coroutine_threadsafe(client.close(), loop).result(5)
        except Exception:  # noqa: BLE001 — tearing down anyway
            pass
        loop.call_soon_threadsafe(loop.stop)
        self._client_thread.join(timeout=5)

    # -- one reconciliation step (unit-testable) ------------------------

    def _demand_shapes(self, load: dict) -> List[dict]:
        """Every pending-demand wire shape scale-up should consider. The
        liveness-reactive baseline sees only what daemons already hold
        (heartbeat lease shapes); demand-driven mode adds demand that has
        NOT reached a daemon yet — queued/pending job requests and pushed
        report_demand entries (elastic-train target width) — so capacity
        starts provisioning before the work lands."""
        shapes = list(load.get("pending_resources", ()))
        if self.config.demand_driven:
            shapes += load.get("pending_job_resources", ())
            shapes += load.get("reported_demand", ())
        shapes += self._preempt_demand(load)
        return shapes

    def _preempt_demand(self, load: dict) -> List[dict]:
        """Proactive mode: each PREEMPTING node's committed load (running
        leases, PG bundles, actors) is demand RIGHT NOW — the replacement
        must be booting while the doomed node is still serving, not after
        its death record lands. Shapes are clamped element-wise to one
        worker bin: a committed load bigger than any single replacement
        still provisions a full worker (the drain migrates what fits;
        remaining load re-pends through the normal heartbeat shapes)."""
        if not self.config.preempt_proactive:
            return []
        from ray_tpu_torch._private.protocol import ResourceSet

        # wire units throughout: _demand_shapes output feeds
        # ResourceSet.from_wire, and "committed" arrives wire-scaled
        bin_wire = ResourceSet(self.config.worker_resources).to_wire()
        shapes = []
        for p in load.get("preempting", ()):
            committed = {
                k: min(int(v), int(bin_wire[k]))
                for k, v in (p.get("committed") or {}).items()
                if int(bin_wire.get(k, 0)) > 0 and int(v) > 0
            }
            if not committed:
                # an idle spot node still deserves a replacement bin: the
                # fleet's size is part of its committed posture (elastic
                # gangs re-grow onto it)
                committed = dict(bin_wire)
            shapes.append(committed)
        return shapes

    def _unmet_worker_need(self, load: dict) -> int:
        """Bin-pack pending lease shapes against existing free capacity plus
        already-launching workers; return how many NEW worker nodes the
        remainder needs (reference: v2/scheduler.py:895 demand scheduler)."""
        from ray_tpu_torch._private.protocol import ResourceSet

        demand = [
            ResourceSet.from_wire(w) for w in self._demand_shapes(load)
        ]
        if not demand and load["pending_total"] > 0:
            # shapes got capped out of the heartbeat: assume one worker's
            # worth of generic demand
            demand = [ResourceSet(self.config.worker_resources)]
        free = [
            ResourceSet.from_wire(n["available"])
            for n in load["nodes"] if n.get("state") == "ALIVE"
        ]
        # launched-but-not-yet-registered nodes count as free bins — without
        # this, every poll during node startup launches more nodes
        known = {n["node_id"] for n in load["nodes"]}
        bin_cap = ResourceSet(self.config.worker_resources)
        for w in self.workers:
            if w["node_id"] not in known:
                free.append(bin_cap)
        unmet = []
        for r in demand:
            for i, f in enumerate(free):
                if r.is_subset_of(f):
                    free[i] = f - r
                    break
            else:
                unmet.append(r)
        needed = 0
        current = None
        for r in unmet:
            if not r.is_subset_of(bin_cap):
                continue  # no worker type can ever host this shape
            if current is None or not r.is_subset_of(current):
                needed += 1
                current = bin_cap
            current = current - r
        return needed

    def _gate_demand(self, load: dict) -> int:
        """Demand that should block scale-down/undrain: pending shapes some
        node type (worker bin or an existing ALIVE node) could ever host.
        Permanently-infeasible shapes are excluded — work nothing can run
        must not hold idle nodes alive forever."""
        from ray_tpu_torch._private.protocol import ResourceSet

        shapes = [ResourceSet.from_wire(w) for w in self._demand_shapes(load)]
        bin_cap = ResourceSet(self.config.worker_resources)
        # DRAINING nodes count as capacity here: demand only they can host
        # must keep gating scale-down so the undrain path can rescue them —
        # excluding them would terminate the one node able to run the work
        totals = [
            ResourceSet.from_wire(n["total"])
            for n in load["nodes"]
            if n.get("state") in ("ALIVE", "DRAINING")
        ]
        hostable = sum(
            1 for r in shapes
            if r.is_subset_of(bin_cap)
            or any(r.is_subset_of(t) for t in totals)
        )
        # shapes are capped in heartbeats; assume the uncounted tail is
        # hostable (err toward keeping capacity). Pending placement-group
        # bundles gate scale-down only when SOMETHING could ever host them:
        # an existing node, or (for GPU-{type}-head domain reservations) a
        # domain type this autoscaler can provision — a permanently
        # infeasible PG must not hold idle nodes alive forever
        import re as _re

        pg_hostable = 0
        for b in load.get("pending_pg_bundles", []):
            r = ResourceSet.from_wire(b.get("resources", {}))
            if r.is_subset_of(bin_cap) or any(
                    r.is_subset_of(t) for t in totals):
                pg_hostable += 1
                continue
            head_types = [
                m.group(1) for key in b.get("resources", {})
                if (m := _re.fullmatch(r"GPU-(.+)-head", key))
            ]
            if any(t in self.config.slice_types for t in head_types) and \
                    len(self.slices) < self.config.max_slices:
                pg_hostable += 1
        # the heartbeat tail is measured against the heartbeat shape list
        # alone — job/report shapes ship uncapped, they have no tail
        heartbeat_shapes = len(load.get("pending_resources", ()))
        return (hostable + max(0, load["pending_total"] - heartbeat_shapes)
                + pg_hostable)

    def _slice_need(self, load: dict) -> Dict[str, int]:
        """How many NEW slices each pod type needs: one per pending
        GPU-{type}-head placement-group bundle that no known node (live or
        launching) can host."""
        import re

        # FREE head tokens (available, not total: a token a scheduled PG
        # already holds must not mask new pending demand) plus tokens
        # arriving with launching slices
        capacity: Dict[str, int] = {}
        for n in load["nodes"]:
            for key, v in n.get("available", {}).items():
                m = re.fullmatch(r"GPU-(.+)-head", key)
                if m and v > 0:
                    capacity[m.group(1)] = capacity.get(m.group(1), 0) + 1
        known = {n["node_id"] for n in load["nodes"]}
        for s in self.slices:
            if any(n["node_id"] not in known for n in s["nodes"]):
                capacity[s["pod_type"]] = capacity.get(s["pod_type"], 0) + 1
        need: Dict[str, int] = {}
        for b in load.get("pending_pg_bundles", []):
            for key, v in b.get("resources", {}).items():
                m = re.fullmatch(r"GPU-(.+)-head", key)
                if not m or v <= 0:
                    continue
                t = m.group(1)
                if capacity.get(t, 0) > 0:
                    capacity[t] -= 1
                else:
                    need[t] = need.get(t, 0) + 1
        return need

    def _report_event(self, etype: str, message: str, **meta):
        """Push a structured autoscaler event into the cluster stream
        (reference: autoscaler events in the export pipeline)."""
        try:
            self._control_call("report_event", {
                "source": "autoscaler", "type": etype,
                "message": message, "meta": meta,
            }, 10)
        except Exception:  # noqa: BLE001 — events must never break scaling
            pass

    def reconcile_once(self) -> Dict[str, int]:
        load = self._control_call(
            "get_cluster_load", {"cursor": self._load_cursor}, 30)
        if load.get("delta"):
            for n in load["nodes"]:
                self._load_rows[n["node_id"]] = n
            for hexid in load.get("removed", ()):
                self._load_rows.pop(hexid, None)
        else:
            self._load_rows = {n["node_id"]: n for n in load["nodes"]}
        self._load_cursor = load.get("version", -1)
        # downstream logic sees the merged full row set either way
        load = {**load, "nodes": list(self._load_rows.values())}
        self._match_booted(load["nodes"])
        launched = terminated = 0

        # prune workers/slices whose daemons died out-of-band — a dead
        # slice must not keep counting as launching head-token capacity
        # (it would mask the re-pended PG's demand forever)
        alive_ids = {n["node_id"] for n in load["nodes"]}
        self.workers = [
            w for w in self.workers
            if self.provider.node_alive(w) or w["node_id"] in alive_ids
        ]
        self.slices = [
            sl for sl in self.slices
            if any(self.provider.node_alive(n) or n["node_id"] in alive_ids
                   for n in sl["nodes"])
        ]

        demand = self._gate_demand(load)
        now = time.monotonic()
        by_id = {n["node_id"]: n for n in load["nodes"]}
        for node_id in list(self._idle_since):
            n = by_id.get(node_id)
            if n is None or (not n["idle"] and n.get("state") == "ALIVE"):
                del self._idle_since[node_id]
                self._draining.pop(node_id, None)
        for n in load["nodes"]:
            if n["idle"]:
                self._idle_since.setdefault(n["node_id"], now)

        # undrain BEFORE scale-up: a DRAINING node rejects every lease, so a
        # drain that never reaches termination (demand returned, or
        # min_workers stops the removal) would strand capacity forever —
        # and rescuing existing capacity must win over launching fresh nodes
        # for the same demand (reference: autoscaler v2 cancels drains for
        # nodes it keeps)
        allowed = max(0, len(self.workers) - self.config.min_workers)
        drained = [nid for nid in self._draining if nid in by_id]
        # a domain's drained hosts are held by the domain scale-in below,
        # not by the min_workers floor
        hosts = {n["node_id"] for sl in self.slices for n in sl["nodes"]}
        to_undrain = drained if demand > 0 else [
            nid for nid in drained if nid not in hosts][allowed:]
        undrained = 0
        for nid in to_undrain:
            try:
                self._control_call(
                    "undrain_node", {"node_id": bytes.fromhex(nid)}, 10)
            except Exception:  # noqa: BLE001 — retry next poll
                continue
            self._draining.pop(nid, None)
            self._idle_since.pop(nid, None)
            undrained += 1
            logger.info("autoscaler undrained node %s", nid[:12])

        # proactive preemption: committed load of PREEMPTING nodes is
        # already folded into _demand_shapes (replacements launch below in
        # the same tranche machinery); here we (a) pin the alive-set
        # baseline at notice time, and (b) once a DISTINCT new node has
        # registered for a given preempting node, start its drain with
        # whatever reclaim window remains — overlapping replacement boot
        # with the drain instead of serializing them. Nodes whose notices
        # vanished (TTL-reverted to ALIVE, drained, or dead) are dropped.
        preempting = (load.get("preempting", ())
                      if self.config.preempt_proactive else ())
        alive_now = {n["node_id"] for n in load["nodes"]
                     if n.get("state") == "ALIVE"}
        seen_notices = set()
        for p in preempting:
            nid = p["node_id"]
            seen_notices.add(nid)
            if nid not in self._preempt_pending:
                self._preempt_pending[nid] = {
                    "baseline": set(alive_now),
                    "deadline_ts": p.get("deadline_ts", 0.0),
                    "replacement": None,
                }
                self.preempt_stats["notices_seen"] += 1
                logger.info("autoscaler: preemption notice for %s "
                            "(deadline in %.1fs) — pre-provisioning",
                            nid[:12],
                            max(0.0, p.get("deadline_ts", 0.0) - time.time()))
        for nid in list(self._preempt_pending):
            if nid not in seen_notices:
                del self._preempt_pending[nid]
        # one-to-one replacement assignment (earliest deadline first): a
        # wave of N preempting nodes must see N distinct replacements
        # before all N drains start — one fresh node must not green-light
        # every drain at once
        assigned = {e["replacement"] for e in self._preempt_pending.values()
                    if e["replacement"]}
        for nid, ent in sorted(self._preempt_pending.items(),
                               key=lambda kv: kv[1]["deadline_ts"]):
            if ent["replacement"] is not None:
                continue
            candidates = sorted(
                alive_now - ent["baseline"] - assigned
                - set(self._preempt_pending))
            if not candidates:
                continue
            ent["replacement"] = candidates[0]
            assigned.add(candidates[0])
            remaining = max(0.5, ent["deadline_ts"] - time.time())
            try:
                self._control_call(
                    "drain_node",
                    {"node_id": bytes.fromhex(nid),
                     "reason": "preemption", "deadline_s": remaining}, 10)
            except Exception:  # noqa: BLE001 — retry next poll
                ent["replacement"] = None
                assigned.discard(candidates[0])
                continue
            self.preempt_stats["drains_started"] += 1
            logger.info(
                "autoscaler: replacement %s registered for preempting %s "
                "— draining it (%.1fs left)",
                candidates[0][:12], nid[:12], remaining)
            self._report_event(
                "PREEMPT_DRAIN", nid[:12],
                replacement=candidates[0][:12], deadline_s=remaining)

        # domain-aware scale-up: pending GPU-{type}-head bundles (domain
        # placement-group reservations) that no live or launching node can
        # host provision WHOLE domains (reference: slice-aware node groups
        # against TOPOLOGY_STRICT_PACK demand)
        launched_slices = 0
        if self.config.slice_types and hasattr(self.provider, "create_slice"):
            for pod_type, count in self._slice_need(load).items():
                spec = self.config.slice_types.get(pod_type)
                if spec is None:
                    continue
                room = self.config.max_slices - len(self.slices)
                for _ in range(max(0, min(count, room))):
                    handle = self.provider.create_slice(pod_type, spec)
                    self.slices.append(handle)
                    launched_slices += 1
                    logger.info("autoscaler provisioned slice %s (%d hosts)",
                                handle["slice_name"], len(handle["nodes"]))
                    self._report_event(
                        "SLICE_PROVISIONED", handle["slice_name"],
                        pod_type=pod_type, hosts=len(handle["nodes"]))

        # scale up: only for demand existing+starting capacity can't absorb.
        # An undrain this pass returns capacity the load snapshot couldn't
        # see; re-evaluate next poll instead of double-provisioning.
        need = 0 if undrained else self._unmet_worker_need(load)
        # the min_workers floor is provisioned proactively, demand or not
        need = max(need, self.config.min_workers - len(self.workers))
        to_add = max(0, min(need, self.config.max_workers - len(self.workers)))
        if to_add > 1 and hasattr(self.provider, "create_nodes"):
            # storm path: a provider with a batched launch surface brings
            # up the whole tranche concurrently instead of one blocking
            # create per node (a 500-node scale-up storm in one pass)
            handles = self.provider.create_nodes(
                self.config.worker_resources, to_add)
            self.workers.extend(handles)
            launched += len(handles)
            logger.info("autoscaler launched %d nodes (batched)",
                        len(handles))
            self._report_event("NODE_LAUNCHED", f"batch of {len(handles)}",
                               count=len(handles))
        else:
            for _ in range(to_add):
                handle = self.provider.create_node(
                    self.config.worker_resources)
                self.workers.append(handle)
                launched += 1
                logger.info("autoscaler launched node %s",
                            handle["node_id"][:12])
                self._report_event("NODE_LAUNCHED", handle["node_id"][:12])

        if launched and self._preempt_pending:
            # capacity provisioned while a reclaim notice was outstanding —
            # the bench's proactive-launches-before-death counter
            self.preempt_stats["launched_during_notice"] += launched

        # scale down in two phases (reference: DrainRaylet then terminate):
        # idle past the timeout -> DRAIN (store stops routing to it);
        # still idle on a later poll -> unregister + terminate. The drain
        # closes the race where work lands between a stale idle heartbeat
        # and the SIGTERM.
        if len(self.workers) > self.config.min_workers and demand == 0:
            for w in list(self.workers):
                nid = w["node_id"]
                n = by_id.get(nid)
                since = self._idle_since.get(nid)
                if n is None or since is None:
                    continue
                if nid in self._draining:
                    if n["idle"]:
                        try:
                            # planned removal: the death record must say so
                            # (expected termination — owners fail over, no
                            # lineage storm)
                            self._control_call(
                                "unregister_node",
                                {"node_id": bytes.fromhex(nid),
                                 "expected": True,
                                 "reason": "autoscaler scale-in"}, 10)
                        except Exception:  # noqa: BLE001 — dead already
                            pass
                        self.provider.terminate_node(w)
                        self.workers.remove(w)
                        self._idle_since.pop(nid, None)
                        self._draining.pop(nid, None)
                        terminated += 1
                        logger.info("autoscaler terminated drained node %s",
                                    nid[:12])
                        if len(self.workers) <= self.config.min_workers:
                            break
                elif (now - since >= self.config.idle_timeout_s
                      and len(self._draining) < allowed):
                    try:
                        # reversible idle-drain (no deadline): the daemon
                        # gates leases but keeps running so a later poll can
                        # undrain it if demand returns
                        self._control_call(
                            "drain_node",
                            {"node_id": bytes.fromhex(nid),
                             "reason": "autoscaler"}, 10)
                        self._draining[nid] = now
                        logger.info("autoscaler draining idle node %s",
                                    nid[:12])
                    except Exception:  # noqa: BLE001
                        pass
        if demand == 0:
            terminated += self._scale_in_domains(by_id, now)
        return {"launched": launched, "terminated": terminated,
                "workers": len(self.workers), "demand": demand,
                "slices": len(self.slices),
                "launched_slices": launched_slices,
                "preempting": len(self._preempt_pending)}

    def _match_booted(self, rows: List[dict]) -> None:
        """Give each handle with ``match_labels`` the node id of the row
        whose labels hold them: a cloud machine's daemon registers under an
        id of its own, which the handle learns here. A handle with no such
        row (still booting, or its daemon gone) keeps its last id."""
        handles = [h for h in self.workers + [
            n for sl in self.slices for n in sl["nodes"]]
            if h.get("match_labels")]
        if not handles:
            return
        index: Dict[tuple, set] = {}
        for row in rows:
            for item in (row.get("labels") or {}).items():
                index.setdefault(item, set()).add(row["node_id"])
        for h in handles:
            ids = set.intersection(*(index.get(item, set())
                                     for item in h["match_labels"].items()))
            if ids:
                h["node_id"] = min(ids)

    def _scale_in_domains(self, by_id: Dict[str, dict], now: float) -> int:
        """Scale in matched domains whole, in the workers' two phases: every
        host idle past the timeout -> drain each; every host still idle on a
        later poll -> unregister each and ``terminate_slice``. Only domains
        whose hosts all carry ``match_labels`` (cloud domains): a local
        provider's domains keep JAX's decisions, which never scale them in.
        Returns the hosts terminated."""
        terminated = 0
        for sl in list(self.slices):
            hosts = sl["nodes"]
            if not all(h.get("match_labels") for h in hosts):
                continue
            ids = [h["node_id"] for h in hosts]
            rows = [by_id.get(nid) for nid in ids]
            since = [self._idle_since.get(nid) for nid in ids]
            if None in rows or None in since:
                continue
            if all(nid in self._draining for nid in ids):
                if not all(r["idle"] for r in rows):
                    continue
                for nid in ids:
                    try:
                        self._control_call(
                            "unregister_node",
                            {"node_id": bytes.fromhex(nid), "expected": True,
                             "reason": "autoscaler scale-in"}, 10)
                    except Exception:  # noqa: BLE001 — dead already
                        pass
                    self._idle_since.pop(nid, None)
                    self._draining.pop(nid, None)
                self.provider.terminate_slice(sl)
                self.slices.remove(sl)
                terminated += len(ids)
                logger.info("autoscaler terminated drained domain %s",
                            sl["slice_name"])
                self._report_event("SLICE_TERMINATED", sl["slice_name"],
                                   hosts=len(ids))
            elif all(now - t >= self.config.idle_timeout_s for t in since):
                for nid in ids:
                    if nid in self._draining:
                        continue
                    try:
                        self._control_call(
                            "drain_node",
                            {"node_id": bytes.fromhex(nid),
                             "reason": "autoscaler"}, 10)
                        self._draining[nid] = now
                    except Exception:  # noqa: BLE001 — retry next poll
                        pass
                logger.info("autoscaler draining idle domain %s",
                            sl["slice_name"])
        return terminated

    # -- background loop -------------------------------------------------

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.reconcile_once()
            except Exception:  # noqa: BLE001 — keep reconciling
                logger.exception("autoscaler reconcile failed")
            self._stop.wait(self.config.poll_period_s)

    def _drain_before_terminate(self, node_ids):
        """cluster_down path: drain every node we are about to terminate so
        their deaths are recorded as EXPECTED (reference: the autoscaler
        drains before it terminates — teardown must not look like a mass
        node failure to any driver still attached)."""
        for nid in node_ids:
            try:
                self._control_call(
                    "drain_node",
                    {"node_id": bytes.fromhex(nid),
                     "reason": "autoscaler"}, 5)
                self._control_call(
                    "unregister_node",
                    {"node_id": bytes.fromhex(nid), "expected": True,
                     "reason": "autoscaler cluster teardown"}, 5)
            except Exception:  # noqa: BLE001 — control store may be gone
                pass

    def stop(self, terminate_workers: bool = True):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        if terminate_workers:
            self._drain_before_terminate(
                [w["node_id"] for w in self.workers]
                + [n["node_id"] for sl in self.slices for n in sl["nodes"]])
            for w in self.workers:
                try:
                    self.provider.terminate_node(w)
                except Exception:  # noqa: BLE001
                    pass
            self.workers.clear()
            for sl in self.slices:
                try:
                    self.provider.terminate_slice(sl)
                except Exception:  # noqa: BLE001
                    pass
            self.slices.clear()
        self._close_client()


__all__ = [
    "Autoscaler",
    "AutoscalingConfig",
    "LocalNodeProvider",
    "NodeProvider",
    "SliceNodeProvider",
    "SliceSpec",
]
