"""State API: introspect live cluster state.

Reference surface: python/ray/util/state/api.py (list_actors, list_nodes,
list_tasks, list_placement_groups, list_jobs, list_workers, summarize_*) and
state_cli.py (`ray list ...`). Queries go straight to the control store's
tables (the reference's StateAPIManager also reads GCS state).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional


def _control_call(method: str, payload: Optional[dict] = None) -> dict:
    from ray_tpu_torch._private.core_worker import get_core_worker

    cw = get_core_worker()
    return cw.run_sync(cw.control.call(method, payload or {}), 30)


def list_nodes() -> List[Dict[str, Any]]:
    from ray_tpu_torch._private.protocol import NodeInfo

    reply = _control_call("get_all_nodes")
    out = []
    for n in reply["nodes"]:
        info = NodeInfo.from_wire(n)
        out.append({
            "node_id": info.node_id.hex(),
            "address": info.address,
            "state": info.state,
            "resources": info.resources.to_dict(),
            "labels": info.labels,
        })
    return out


def list_actors(detail: bool = False) -> List[Dict[str, Any]]:
    reply = _control_call("list_actors")
    out = []
    for a in reply["actors"]:
        row = {
            "actor_id": a["actor_id"].hex(),
            "state": a["state"],
            "name": a.get("name", ""),
            "node_id": (a.get("node_id") or b"").hex(),
        }
        if detail:
            row.update({
                "worker_address": a.get("worker_address", ""),
                "num_restarts": a.get("num_restarts", 0),
                "death_cause": a.get("death_cause", ""),
            })
        out.append(row)
    return out


def list_placement_groups() -> List[Dict[str, Any]]:
    reply = _control_call("list_placement_groups")
    out = []
    for pg in reply["pgs"]:
        out.append({
            "placement_group_id": pg["pg_id"].hex(),
            "state": pg["state"],
            "name": pg.get("name", ""),
            "bundles": len(pg.get("bundles", [])),
        })
    return out


def list_jobs() -> List[Dict[str, Any]]:
    reply = _control_call("get_all_jobs")
    return [
        {
            "job_id": j["job_id"].hex(),
            "finished": j.get("finished", False),
            "driver_address": j.get("driver_address", ""),
            "start_time": j.get("start_time"),
        }
        for j in reply["jobs"]
    ]


def list_tasks(limit: int = 1000) -> List[Dict[str, Any]]:
    """Latest execution record per task from the task-event history."""
    reply = _control_call("list_task_events", {"limit": limit * 4})
    latest: Dict[bytes, dict] = {}
    for ev in reply["events"]:
        # SPAN records (execution/hop/serve spans) are trace annotations,
        # not task STATE — a traced task's hop spans land after FINISHED
        # and must not masquerade as its latest execution state
        if ev.get("event") == "SPAN":
            continue
        latest[ev["task_id"]] = ev
    out = [
        {
            "task_id": ev["task_id"].hex(),
            "name": ev["name"],
            "kind": ev["kind"],
            "state": ev["event"],
            "node_id": ev["node_id"],
            "worker_id": ev["worker_id"].hex(),
            "duration_s": ev.get("duration_s"),
        }
        for ev in latest.values()
    ]
    return out[-limit:]


def summarize_tasks() -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for t in list_tasks():
        counts[t["state"]] = counts.get(t["state"], 0) + 1
    return counts


def summarize_objects() -> List[Dict[str, Any]]:
    """Per-node shm store occupancy (reference: `ray summary objects`)."""
    from ray_tpu_torch._private.core_worker import get_core_worker
    from ray_tpu_torch._private.protocol import NodeInfo

    cw = get_core_worker()
    nodes = _control_call("get_all_nodes")["nodes"]
    out = []
    for n in nodes:
        info = NodeInfo.from_wire(n)
        if info.state != "ALIVE":
            continue
        try:
            stats = cw.run_sync(cw.daemon.call("store_stats", {}), 10)
        except Exception:  # noqa: BLE001 — node unreachable
            stats = {}
        out.append({"node_id": info.node_id.hex(), **stats})
    return out


def timeline(filename: Optional[str] = None) -> Any:
    """Chrome-trace JSON of task execution spans (reference: `ray timeline`,
    python/ray/_private/state.py:1017). Open in chrome://tracing or
    ui.perfetto.dev."""
    from ray_tpu_torch._private.task_events import to_chrome_trace

    reply = _control_call("list_task_events", {"limit": 0})
    trace = to_chrome_trace(reply["events"])
    if filename:
        with open(filename, "w") as f:
            json.dump(trace, f)
        return filename
    return trace


def dump_flight_recorder(dest_dir: Optional[str] = None) -> Dict[str, Any]:
    """Pull every process's flight-recorder ring: this driver's, the
    control store's, and — per live node — the daemon's plus its workers'
    (collected daemon-side in one hop). With `dest_dir`, each ring is also
    written as `<dest_dir>/<process>.jsonl` and the returned dicts carry a
    "path" key. Unreachable processes appear with an "error" key instead of
    failing the whole dump — this runs exactly when things are broken (the
    chaos harness invokes it on scenario failure; see tests/conftest.py)."""
    import json as _json
    import os

    from ray_tpu_torch._private import flight_recorder
    from ray_tpu_torch._private.core_worker import get_core_worker
    from ray_tpu_torch._private.protocol import NodeInfo
    from ray_tpu_torch.runtime.rpc import RpcClient

    cw = get_core_worker()
    out: Dict[str, Any] = {"driver": flight_recorder.dump()}
    try:
        out["control_store"] = cw.run_sync(
            cw.control.call("dump_flight_recorder", {}, timeout=10), 15)
    except Exception as e:  # noqa: BLE001 — store down: dump what we can
        out["control_store"] = {"error": str(e)}
    try:
        nodes = cw.run_sync(cw.control.call("get_all_nodes", {}), 15)["nodes"]
    except Exception as e:  # noqa: BLE001
        nodes = []
        out["nodes_error"] = str(e)
    for n in nodes:
        info = NodeInfo.from_wire(n)
        if info.state == "DEAD":
            continue
        key = f"node_{info.node_id.hex()[:12]}"

        async def pull(address=info.address):
            client = RpcClient(address, name="fr-dump", retries=1)
            await client.connect()
            try:
                return await client.call(
                    "collect_flight_recorders", {}, timeout=15)
            finally:
                await client.close()

        try:
            reply = cw.run_sync(pull(), 20)
        except Exception as e:  # noqa: BLE001 — dead/partitioned daemon
            out[key] = {"error": str(e)}
            continue
        out[key] = reply["daemon"]
        for wid, ring in reply.get("workers", {}).items():
            out[f"{key}_worker_{wid[:12]}"] = ring
    if dest_dir:
        os.makedirs(dest_dir, exist_ok=True)
        for name, ring in out.items():
            if not isinstance(ring, dict):
                continue
            path = os.path.join(dest_dir, f"{name}.jsonl")
            with open(path, "w") as f:
                header = {k: v for k, v in ring.items() if k != "events"}
                f.write(_json.dumps(header, default=str) + "\n")
                for ev in ring.get("events", []):
                    f.write(_json.dumps(ev, default=str) + "\n")
            ring["path"] = path
    return out


def list_cluster_events(source: str = None, type: str = None,
                        limit: int = 1000):
    """Structured cluster events (node/actor/job/pg/autoscaler lifecycle;
    reference: the export-event pipeline's aggregator feed)."""
    payload = {"limit": limit}
    if source:
        payload["source"] = source
    if type:
        payload["type"] = type
    return _control_call("list_events", payload)["events"]


def export_cluster_events(dest_uri: str, limit: int = 10000) -> int:
    """Dump the event stream as JSONL to any storage URI (file path,
    memory://, gs://... — reference: aggregator_agent.py export sinks).
    Returns the number of events written."""
    import json as _json

    from ray_tpu_torch.train._storage import get_storage

    events = list_cluster_events(limit=limit)
    storage = get_storage(dest_uri)
    payload = "\n".join(_json.dumps(e, default=str) for e in events)
    storage.write_bytes(dest_uri, payload.encode())
    return len(events)


def list_dataset_stats() -> List[Dict[str, Any]]:
    """Per-op stats of streaming Dataset executions, cluster-visible via the
    control store KV (reference: the data dashboard's StatsManager feed)."""
    import json

    reply = _control_call("kv_keys", {"ns": "data_stats", "prefix": b""})
    out = []
    for key in reply["keys"]:
        val = _control_call("kv_get", {"ns": "data_stats", "key": key})["value"]
        if val is not None:
            rec = json.loads(val)
            rec["dataset"] = key.decode() if isinstance(key, bytes) else key
            out.append(rec)
    return out


__all__ = [
    "dump_flight_recorder",
    "export_cluster_events",
    "list_actors",
    "list_cluster_events",
    "list_dataset_stats",
    "list_jobs",
    "list_nodes",
    "list_placement_groups",
    "list_tasks",
    "summarize_objects",
    "summarize_tasks",
    "timeline",
]
