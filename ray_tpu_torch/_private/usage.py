"""Usage telemetry — cluster metadata + library-usage records. The port's
copy of ``ray_tpu/_private/usage.py``: the metadata names torch's version
where JAX's names jax's.

Reference surface: python/ray/_common/usage/ (usage_lib: cluster metadata,
library usage tags, opt-out via RAY_USAGE_STATS_ENABLED). Zero-egress
redesign: records aggregate in the control store's KV (ns "usage") and are
written to `<session>/usage_stats.json` on the head — operators export them
themselves; nothing ever leaves the cluster. Opt out with
RAY_TPU_usage_stats_enabled=0 (config flag, env-overridable like all
flags)."""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, Set

KV_NS = "usage"

# libraries recorded before init: flushed when the cluster connection exists
_pending: Set[str] = set()
_recorded: Set[str] = set()


def _enabled() -> bool:
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    return bool(GLOBAL_CONFIG.get("usage_stats_enabled"))


def record_library_usage(library: str) -> None:
    """Tag a library as used (reference: usage_lib.record_library_usage).
    Callable before OR after init; records de-duplicate cluster-wide."""
    if not _enabled() or library in _recorded:
        return
    _recorded.add(library)
    try:
        from ray_tpu_torch._private.core_worker import get_core_worker

        cw = get_core_worker()
    except Exception:  # noqa: BLE001 — not connected yet
        _pending.add(library)
        return
    _flush_one(cw, library)


def _flush_one(cw, library: str) -> None:
    async def put():
        try:
            await cw.control.call("kv_put", {
                "ns": KV_NS, "key": f"lib:{library}".encode(),
                "value": b"1", "overwrite": True,
            })
        except Exception:  # noqa: BLE001 — telemetry is best-effort
            pass

    cw.schedule(put())


def flush_pending(cw) -> None:
    """Called from init(): ship pre-init records + cluster metadata."""
    if not _enabled():
        return
    for lib in list(_pending):
        _flush_one(cw, lib)
    _pending.clear()

    async def put_meta():
        try:
            meta = {
                "python": sys.version.split()[0],
                "started_at": time.time(),
            }
            try:
                # the installed version, read without importing torch
                from importlib.metadata import version

                meta["torch"] = version("torch")
            except Exception:  # noqa: BLE001
                pass
            await cw.control.call("kv_put", {
                "ns": KV_NS, "key": b"cluster_metadata",
                "value": json.dumps(meta).encode(), "overwrite": True,
            })
        except Exception:  # noqa: BLE001 — best-effort
            pass

    cw.schedule(put_meta())


async def usage_report(cw) -> Dict[str, Any]:
    """Aggregate the cluster's usage records (reference: usage_lib's
    generated report; consumed by the dashboard and the session-dir file)."""
    reply = await cw.control.call("kv_keys", {"ns": KV_NS})
    libs = []
    meta: Dict[str, Any] = {}
    for key in reply.get("keys", []):
        name = key.decode() if isinstance(key, bytes) else key
        if name.startswith("lib:"):
            libs.append(name[4:])
        elif name == "cluster_metadata":
            got = await cw.control.call(
                "kv_get", {"ns": KV_NS, "key": b"cluster_metadata"})
            if got.get("value"):
                meta = json.loads(got["value"])
    nodes = await cw.control.call("get_all_nodes", {})
    return {
        "usage_stats_enabled": _enabled(),
        "libraries": sorted(libs),
        "num_nodes": sum(1 for n in nodes["nodes"]
                         if n["state"] == "ALIVE"),
        **meta,
    }
