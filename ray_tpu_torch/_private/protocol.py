"""Control-plane message schemas: task/actor specs, resources, node info.

Capability parity with the reference's wire schema (reference:
src/ray/protobuf/common.proto:510 `TaskSpec`, :482 `LeaseSpec`, :112
`SchedulingStrategy`, :684 `Bundle`; src/ray/common/task/task_spec.h:82),
redesigned as msgpack-able plain dicts wrapped in typed dataclasses — the
transport (runtime/rpc.py) frames msgpack, so specs round-trip with no
separate IDL compile step.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.ids import (
    ActorID,
    JobID,
    NodeID,
    ObjectID,
    PlacementGroupID,
    TaskID,
    WorkerID,
)

# ---------------------------------------------------------------------------
# Resources
# ---------------------------------------------------------------------------

# Resource quantities are fixed-point integers scaled by 10^4, mirroring the
# reference's FixedPoint resource arithmetic (src/ray/common/scheduling/
# fixed_point.h:26) so fractional resources never accumulate float error.
RESOURCE_SCALE = 10_000


def to_fixed(value: float) -> int:
    return round(value * RESOURCE_SCALE)


def from_fixed(value: int) -> float:
    return value / RESOURCE_SCALE


class ResourceSet:
    """A bag of named resource quantities (fixed-point ints internally).

    Reference: src/ray/common/scheduling/resource_set.h:33.
    """

    __slots__ = ("_amounts",)

    def __init__(self, amounts: Optional[Dict[str, float]] = None, *, _fixed=None):
        if _fixed is not None:
            self._amounts = {k: v for k, v in _fixed.items() if v != 0}
        else:
            self._amounts = {
                k: to_fixed(v) for k, v in (amounts or {}).items() if v != 0
            }

    def to_dict(self) -> Dict[str, float]:
        return {k: from_fixed(v) for k, v in self._amounts.items()}

    def to_wire(self) -> Dict[str, int]:
        return dict(self._amounts)

    @classmethod
    def from_wire(cls, wire: Dict[str, int]) -> "ResourceSet":
        return cls(_fixed=wire)

    def get(self, name: str) -> float:
        return from_fixed(self._amounts.get(name, 0))

    def is_empty(self) -> bool:
        return not self._amounts

    def names(self):
        return self._amounts.keys()

    def is_subset_of(self, other: "ResourceSet") -> bool:
        return all(v <= other._amounts.get(k, 0) for k, v in self._amounts.items())

    def __add__(self, other: "ResourceSet") -> "ResourceSet":
        out = dict(self._amounts)
        for k, v in other._amounts.items():
            out[k] = out.get(k, 0) + v
        return ResourceSet(_fixed=out)

    def __sub__(self, other: "ResourceSet") -> "ResourceSet":
        out = dict(self._amounts)
        for k, v in other._amounts.items():
            out[k] = out.get(k, 0) - v
        return ResourceSet(_fixed=out)

    def __eq__(self, other) -> bool:
        return isinstance(other, ResourceSet) and self._amounts == other._amounts

    def __repr__(self) -> str:
        return f"ResourceSet({self.to_dict()})"


# ---------------------------------------------------------------------------
# Scheduling strategies (reference: common.proto:112 SchedulingStrategy)
# ---------------------------------------------------------------------------

STRATEGY_DEFAULT = "DEFAULT"  # hybrid pack-then-spread
STRATEGY_SPREAD = "SPREAD"
STRATEGY_NODE_AFFINITY = "NODE_AFFINITY"
STRATEGY_PLACEMENT_GROUP = "PLACEMENT_GROUP"


def labels_match(labels: Optional[Dict[str, str]],
                 selector: Optional[Dict[str, str]]) -> bool:
    """ONE definition of label-selector matching for every scheduling
    decision (choose/grant/spill/feasibility/PG bin-pack) — reference:
    node_label_scheduling_policy.h + scheduling/label_selector.h's `!`
    operator. A selector value of "!v" matches nodes whose label is
    ABSENT or different — the anti-affinity form used to keep
    coordination actors off spot/preemptible capacity."""
    if not selector:
        return True
    labels = labels or {}
    for k, v in selector.items():
        if v.startswith("!"):
            if labels.get(k) == v[1:]:
                return False
        elif labels.get(k) != v:
            return False
    return True


SIM_NODE_LABEL = "simnode"


def is_sim_node(labels: Optional[Dict[str, str]]) -> bool:
    """Simulated nodes (the scale harness, _private/simnode.py) are
    control-plane-only: they register/heartbeat/drain like real daemons
    but script their lease grants — REAL work must never land on one, so
    every placement decision (daemon choose/spill/feasibility, store actor
    scheduling, PG bin-pack) excludes them by this label."""
    return bool(labels) and labels.get(SIM_NODE_LABEL) == "true"


@dataclass
class SchedulingStrategy:
    kind: str = STRATEGY_DEFAULT
    # NODE_AFFINITY
    node_id: Optional[str] = None  # hex
    soft: bool = False
    # PLACEMENT_GROUP
    placement_group_id: Optional[str] = None  # hex
    bundle_index: int = -1
    # label selector (reference: scheduling/label_selector.h:73)
    label_selector: Dict[str, str] = field(default_factory=dict)

    def to_wire(self) -> dict:
        return {
            "kind": self.kind,
            "node_id": self.node_id,
            "soft": self.soft,
            "pg_id": self.placement_group_id,
            "bundle_index": self.bundle_index,
            "labels": self.label_selector,
        }

    @classmethod
    def from_wire(cls, w: Optional[dict]) -> "SchedulingStrategy":
        if not w:
            return cls()
        return cls(
            kind=w.get("kind", STRATEGY_DEFAULT),
            node_id=w.get("node_id"),
            soft=w.get("soft", False),
            placement_group_id=w.get("pg_id"),
            bundle_index=w.get("bundle_index", -1),
            label_selector=w.get("labels") or {},
        )


# ---------------------------------------------------------------------------
# Task spec
# ---------------------------------------------------------------------------

TASK_KIND_NORMAL = 0
TASK_KIND_ACTOR_CREATION = 1
TASK_KIND_ACTOR_TASK = 2

# Sentinel num_returns for `num_returns="streaming"` tasks (reference:
# python/ray/_raylet.pyx streaming generator protocol).
NUM_RETURNS_STREAMING = -2


@dataclass
class TaskSpec:
    """Everything a worker needs to execute one task.

    Reference: src/ray/common/task/task_spec.h:82 and common.proto:510.
    Args are pre-serialized by the caller: each entry is either
    {"ref": object_id_bytes, "owner": owner_addr} (a pass-by-reference arg)
    or {"inline": bytes} (serialized value).
    """

    task_id: TaskID
    job_id: JobID
    kind: int = TASK_KIND_NORMAL
    function_key: str = ""  # KV key of the exported function/actor class
    method_name: str = ""  # for actor tasks
    args: List[dict] = field(default_factory=list)
    num_returns: int = 1
    resources: ResourceSet = field(default_factory=ResourceSet)
    strategy: SchedulingStrategy = field(default_factory=SchedulingStrategy)
    max_retries: int = 3
    retry_exceptions: bool = False
    # ownership: the address of the worker that owns the returned objects
    owner_worker_id: bytes = b""
    owner_address: str = ""
    # actor fields
    actor_id: Optional[ActorID] = None
    seq_no: int = -1  # actor-task ordering
    # caller-observed actor incarnation: seq_no ordering holds within one
    # incarnation; retries carrying an older incarnation than the executor has
    # seen run unordered (order across a crash is unknowable — reference:
    # actor_task_submitter.h restart epoch semantics)
    incarnation: int = 0
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    is_async_actor: bool = False
    # named concurrency groups (reference: core_worker/task_execution/
    # concurrency_group_manager.h): creation spec carries {group: max},
    # each actor task carries the group its method is assigned to
    concurrency_groups: Dict[str, int] = field(default_factory=dict)
    concurrency_group: str = ""
    # @method declarations (num_returns / concurrency_group per method) —
    # carried on the creation spec so get_actor handles rebuild the same
    # call behavior the original handle had
    method_meta: Dict[str, dict] = field(default_factory=dict)
    runtime_env: dict = field(default_factory=dict)
    name: str = ""
    # streaming generators: num_returns == NUM_RETURNS_STREAMING; executor
    # reports each yielded item to the owner and pauses when more than
    # `stream_backpressure` items are unconsumed (-1 = unbounded). Reference:
    # _generator_backpressure_num_objects in common.proto:510.
    stream_backpressure: int = -1
    # tombstone: an ordered actor task cancelled before delivery is still
    # pushed (with this flag) so its sequence slot advances on the executor
    # instead of leaving a hole that stalls successors.
    cancelled: bool = False
    # opt-in distributed tracing: {"trace_id", "parent_span_id"} injected at
    # submission and extracted around execution so spans chain across
    # processes (reference: util/tracing/tracing_helper.py:181
    # _DictPropagator.inject into TaskSpec)
    trace_ctx: Optional[dict] = None
    # actors only: the OWNER coordinates this actor's planned-removal
    # handling (e.g. the elastic train controller live-resizing its gang
    # inside the drain window) — the control store's drain migration must
    # neither kill nor migrate it; it rides the node to the deadline
    # unless its owner releases it first
    drain_cooperative: bool = False

    @property
    def is_streaming(self) -> bool:
        return self.num_returns == NUM_RETURNS_STREAMING

    def return_ids(self) -> List[ObjectID]:
        # memoized: blake2b-derived per return id, and callers (submission
        # tracking, reply recording, lineage) ask several times per task
        cached = getattr(self, "_return_ids", None)
        if cached is not None:
            return cached
        if self.is_streaming:
            ids: List[ObjectID] = []
        else:
            ids = [
                ObjectID.for_task_return(self.task_id, i)
                for i in range(self.num_returns)
            ]
        object.__setattr__(self, "_return_ids", ids)
        return ids

    def to_wire(self) -> dict:
        return {
            "task_id": self.task_id.binary(),
            "job_id": self.job_id.binary(),
            "kind": self.kind,
            "function_key": self.function_key,
            "method_name": self.method_name,
            "args": self.args,
            "num_returns": self.num_returns,
            "resources": self.resources.to_wire(),
            "strategy": self.strategy.to_wire(),
            "max_retries": self.max_retries,
            "retry_exceptions": self.retry_exceptions,
            "owner_worker_id": self.owner_worker_id,
            "owner_address": self.owner_address,
            "actor_id": self.actor_id.binary() if self.actor_id else b"",
            "seq_no": self.seq_no,
            "incarnation": self.incarnation,
            "max_restarts": self.max_restarts,
            "max_task_retries": self.max_task_retries,
            "max_concurrency": self.max_concurrency,
            "is_async_actor": self.is_async_actor,
            "concurrency_groups": self.concurrency_groups,
            "concurrency_group": self.concurrency_group,
            "method_meta": self.method_meta,
            "runtime_env": self.runtime_env,
            "name": self.name,
            "stream_backpressure": self.stream_backpressure,
            "cancelled": self.cancelled,
            "trace_ctx": self.trace_ctx,
            "drain_cooperative": self.drain_cooperative,
        }

    @classmethod
    def from_wire(cls, w: dict) -> "TaskSpec":
        return cls(
            task_id=TaskID(w["task_id"]),
            job_id=JobID(w["job_id"]),
            kind=w["kind"],
            function_key=w["function_key"],
            method_name=w["method_name"],
            args=w["args"],
            num_returns=w["num_returns"],
            resources=ResourceSet.from_wire(w["resources"]),
            strategy=SchedulingStrategy.from_wire(w["strategy"]),
            max_retries=w["max_retries"],
            retry_exceptions=w["retry_exceptions"],
            owner_worker_id=w["owner_worker_id"],
            owner_address=w["owner_address"],
            actor_id=ActorID(w["actor_id"]) if w["actor_id"] else None,
            seq_no=w["seq_no"],
            incarnation=w.get("incarnation", 0),
            max_restarts=w.get("max_restarts", 0),
            max_task_retries=w.get("max_task_retries", 0),
            max_concurrency=w.get("max_concurrency", 1),
            is_async_actor=w.get("is_async_actor", False),
            concurrency_groups=w.get("concurrency_groups") or {},
            concurrency_group=w.get("concurrency_group", ""),
            method_meta=w.get("method_meta") or {},
            runtime_env=w.get("runtime_env") or {},
            name=w.get("name", ""),
            stream_backpressure=w.get("stream_backpressure", -1),
            cancelled=w.get("cancelled", False),
            trace_ctx=w.get("trace_ctx"),
            drain_cooperative=w.get("drain_cooperative", False),
        )


# ---------------------------------------------------------------------------
# Node info (reference: gcs_service.proto NodeInfo / GcsNodeInfo)
# ---------------------------------------------------------------------------

NODE_ALIVE = "ALIVE"
NODE_DEAD = "DEAD"
NODE_DRAINING = "DRAINING"
# a cloud maintenance/spot-reclaim notice was reported for the node: it is
# still ALIVE for scheduling purposes (leases keep running) but the
# reconciler should treat its committed load as demand NOW and pre-provision
# replacement capacity before the drain begins (reference: autoscaler.proto
# DrainNodeReason_PREEMPTION + the GCE maintenance-event warning window)
NODE_PREEMPTING = "PREEMPTING"

# drain reasons (reference: autoscaler.proto DrainNodeReason — the protocol
# distinguishes WHY a node is being removed so downstream layers can react
# appropriately: preemption gets the full deadline orchestration, an
# autoscaler idle-drain stays reversible until termination)
DRAIN_REASON_PREEMPTION = "preemption"
DRAIN_REASON_AUTOSCALER = "autoscaler"
DRAIN_REASON_MANUAL = "manual"


@dataclass
class NodeDeathInfo:
    """Why a node left the cluster (reference: gcs.proto NodeDeathInfo —
    expected termination vs unexpected failure drives whether owners run
    replica failover or lineage reconstruction)."""

    expected: bool = False
    reason: str = ""
    ts: float = 0.0  # unix time the death was recorded

    def to_wire(self) -> dict:
        return {"expected": self.expected, "reason": self.reason,
                "ts": self.ts}

    @classmethod
    def from_wire(cls, w: Optional[dict]) -> Optional["NodeDeathInfo"]:
        if not w:
            return None
        return cls(expected=w.get("expected", False),
                   reason=w.get("reason", ""),
                   ts=w.get("ts", 0.0))


@dataclass
class NodeInfo:
    node_id: NodeID
    address: str  # daemon RPC address
    object_store_name: str  # shm segment name
    resources: ResourceSet
    labels: Dict[str, str] = field(default_factory=dict)
    state: str = NODE_ALIVE
    object_transfer_address: str = ""
    # planned-removal protocol (reference: DrainNode RPC carrying reason +
    # deadline; NodeDeathInfo recording expected vs unexpected termination)
    drain_reason: str = ""
    drain_deadline: float = 0.0  # absolute unix time; 0 = no deadline
    death: Optional[NodeDeathInfo] = None

    def to_wire(self) -> dict:
        return {
            "node_id": self.node_id.binary(),
            "address": self.address,
            "object_store_name": self.object_store_name,
            "resources": self.resources.to_wire(),
            "labels": self.labels,
            "state": self.state,
            "object_transfer_address": self.object_transfer_address,
            "drain_reason": self.drain_reason,
            "drain_deadline": self.drain_deadline,
            "death": self.death.to_wire() if self.death else None,
        }

    @classmethod
    def from_wire(cls, w: dict) -> "NodeInfo":
        return cls(
            node_id=NodeID(w["node_id"]),
            address=w["address"],
            object_store_name=w["object_store_name"],
            resources=ResourceSet.from_wire(w["resources"]),
            labels=w.get("labels") or {},
            state=w.get("state", NODE_ALIVE),
            object_transfer_address=w.get("object_transfer_address", ""),
            drain_reason=w.get("drain_reason", ""),
            drain_deadline=w.get("drain_deadline", 0.0),
            death=NodeDeathInfo.from_wire(w.get("death")),
        )


# ---------------------------------------------------------------------------
# Actor state machine (reference: gcs_service.proto ActorTableData states)
# ---------------------------------------------------------------------------

ACTOR_PENDING = "PENDING_CREATION"
ACTOR_ALIVE = "ALIVE"
ACTOR_RESTARTING = "RESTARTING"
ACTOR_DEAD = "DEAD"


@dataclass
class Bundle:
    """One placement-group resource bundle (reference: common.proto:684)."""

    index: int
    resources: ResourceSet

    def to_wire(self) -> dict:
        return {"index": self.index, "resources": self.resources.to_wire()}

    @classmethod
    def from_wire(cls, w: dict) -> "Bundle":
        return cls(index=w["index"], resources=ResourceSet.from_wire(w["resources"]))


# PG strategies (reference: bundle_scheduling_policy.h:74-101)
PG_PACK = "PACK"
PG_SPREAD = "SPREAD"
PG_STRICT_PACK = "STRICT_PACK"
PG_STRICT_SPREAD = "STRICT_SPREAD"
# Topology-aware gang placement (reference: raylet/scheduling/policy/
# topology_bundle_scheduling_policy.h:89 TopologyStrictPackSchedulingPolicy):
# one bundle per host, hosts chosen to form the tightest contiguous block of
# one NVLink domain (labels carry per-host coordinates; see control_store
# _place_bundles). Bundle index order follows row-major coordinate order so
# gang ranks map onto adjacent hosts.
PG_TOPOLOGY_STRICT_PACK = "TOPOLOGY_STRICT_PACK"
# node label carrying the host's coordinates inside its NVLink domain,
# "x,y[,z]" (the JAX package's TPU_COORD_LABEL, "rt.tpu.coord")
GPU_COORD_LABEL = "rt.gpu.coord"

PG_PENDING = "PENDING"
PG_CREATED = "CREATED"
PG_REMOVED = "REMOVED"
