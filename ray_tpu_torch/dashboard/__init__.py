"""Dashboard: HTTP JSON API + overview page for cluster state.

The port's counterpart of ``ray_tpu/dashboard/__init__.py``: the same
routes, replies, status codes and scrape body on the port's runtime. Its
one device route keeps JAX's path, ``/api/jax_profile``, so a client of
either package asks the same URL; here it records a ``torch.profiler``
chrome trace through ``gpu/profiler.py::node_capture_task``.

Reference surface: python/ray/dashboard/ (DashboardHead head.py:49 serving
/api/... routes + the React frontend; per-node agents feed it). Here one
detached async actor serves the API straight from the control store's
tables — nodes, actors, jobs, tasks, placement groups, Prometheus metrics
— plus a single-file HTML overview.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Any, Dict

import ray_tpu_torch


def _read_text(path: str) -> str:
    """Whole-file read for asyncio.to_thread (the handler itself must not
    touch disk on the event loop)."""
    with open(path, encoding="utf-8") as f:
        return f.read()


DASHBOARD_NAME = "dashboard"
DASH_NAMESPACE = "_dashboard"

_PAGE = """<!doctype html>
<html><head><title>ray_tpu_torch dashboard</title>
<style>
 body { font-family: monospace; margin: 2em; background: #111; color: #eee; }
 h1 { color: #7fdbca; } h2 { color: #82aaff; margin-top: 1.5em; }
 table { border-collapse: collapse; }
 td, th { border: 1px solid #444; padding: 4px 10px; text-align: left; }
 th { background: #222; }
</style></head>
<body>
<h1>ray_tpu_torch dashboard</h1>
<div id="content">loading…</div>
<script>
async function refresh() {
  let [nodes, actors, jobs, tasks] = await Promise.all(
    ["nodes?limit=1000", "actors", "jobs", "task_summary"].map(
      p => fetch("/api/" + p).then(r => r.json())));
  nodes = nodes.nodes || nodes;
  jobs = jobs.jobs || jobs;
  const esc = (s) => String(s).replace(/[&<>"']/g,
    ch => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;","'":"&#39;"}[ch]));
  const table = (rows) => {
    if (!rows.length) return "<i>(none)</i>";
    const cols = Object.keys(rows[0]);
    return "<table><tr>" + cols.map(c => `<th>${esc(c)}</th>`).join("") +
      "</tr>" + rows.map(r => "<tr>" + cols.map(
        c => `<td>${esc(JSON.stringify(r[c]))}</td>`).join("") +
      "</tr>").join("") + "</table>";
  };
  document.getElementById("content").innerHTML =
    "<h2>Nodes</h2>" + table(nodes) +
    "<h2>Actors</h2>" + table(actors) +
    "<h2>Jobs</h2>" + table(jobs) +
    "<h2>Tasks</h2><pre>" + JSON.stringify(tasks, null, 1) + "</pre>";
}
refresh(); setInterval(refresh, 3000);
</script></body></html>
"""


@ray_tpu_torch.remote
class DashboardActor:
    """Async actor hosting the aiohttp app (same pattern as the serve
    ingress proxy — the server starts lazily on the core event loop)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8265):
        self.host = host
        self.port = port
        self._started = None
        self._runner = None
        # aggregated node table maintained from the control store's delta
        # cursor: each poll transfers only the mutations since the last one
        # instead of serializing the full 1000-node table per request
        self._nodes_cache: dict = {}
        self._nodes_cursor = -1

    async def _node_table(self) -> list:
        """The aggregated node table, refreshed via get_nodes_delta. Falls
        back to a full read when delta sync is off or the cursor expired."""
        reply = await self._control(
            "get_nodes_delta", {"cursor": self._nodes_cursor})
        if reply.get("full") or "updates" not in reply:
            self._nodes_cache = {
                n["node_id"]: n for n in reply.get("nodes", [])
            }
        else:
            for n in reply["updates"]:
                self._nodes_cache[n["node_id"]] = n
            if len(self._nodes_cache) > 4096:
                # deltas only ever ADD rows; under heavy churn re-anchor on
                # a full read so the store's dead-node retention (which
                # prunes) bounds this cache too
                self._nodes_cursor = -1
                return await self._node_table()
        self._nodes_cursor = reply.get("version", self._nodes_cursor)
        return list(self._nodes_cache.values())

    async def _control(self, method: str, payload: dict = None):
        from ray_tpu_torch._private.core_worker import get_core_worker

        cw = get_core_worker()
        return await cw.control.call(method, payload or {})

    async def _start(self):
        from aiohttp import web

        app = web.Application()
        app.router.add_get("/", self._index)
        app.router.add_get("/api/nodes", self._nodes)
        app.router.add_get("/api/actors", self._actors)
        app.router.add_get("/api/jobs", self._jobs)
        app.router.add_get("/api/driver_jobs", self._driver_jobs)
        app.router.add_get("/api/tasks", self._tasks)
        app.router.add_get("/api/task_summary", self._task_summary)
        app.router.add_get("/api/placement_groups", self._pgs)
        app.router.add_get("/api/cluster_load", self._cluster_load)
        app.router.add_get("/api/events", self._events)
        app.router.add_get("/api/node_stats", self._node_stats)
        app.router.add_get("/api/workers", self._workers)
        app.router.add_get("/api/profile", self._profile)
        app.router.add_get("/api/jax_profile", self._jax_profile)
        app.router.add_get("/api/flight_recorder", self._flight_recorder)
        app.router.add_get("/metrics", self._metrics)
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        if self.port == 0:
            # port 0: the one the system chose, so ready() names it
            self.port = self._runner.addresses[0][1]

    async def ready(self) -> str:
        if self._started is None:
            self._started = asyncio.ensure_future(self._start())
        try:
            await self._started
        except BaseException:
            # a transient bind failure must not brick the detached actor:
            # the next ready() retries the startup
            self._started = None
            raise
        return f"http://{self.host}:{self.port}"

    async def _index(self, request):
        from aiohttp import web

        import os

        page = getattr(self, "_index_page", None)
        if page is None:
            path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "static", "index.html")
            try:
                page = await asyncio.to_thread(_read_text, path)
            except OSError:  # packaged without assets: minimal inline fallback
                page = _PAGE
            self._index_page = page  # static asset: read once, serve cached
        return web.Response(text=page, content_type="text/html")

    async def _resolve_node(self, node_hex: str) -> dict:
        """Find a LIVE node by full id or unique prefix (>= 8 chars)."""
        nodes = await self._node_table()
        matches = [
            n for n in nodes
            if n["node_id"].hex() == node_hex
            or (len(node_hex) >= 8 and n["node_id"].hex().startswith(node_hex))
        ]
        if not matches:
            raise ValueError(f"unknown node {node_hex}")
        if len(matches) > 1:
            raise ValueError(f"ambiguous node prefix {node_hex}")
        if matches[0]["state"] == "DEAD":
            raise ValueError(f"node {node_hex} is dead")
        return matches[0]

    async def _daemon_call(self, node_hex: str, method: str, payload: dict):
        """RPC a specific node's daemon (resolved through the control
        store's node table)."""
        from ray_tpu_torch.runtime.rpc import RpcClient

        n = await self._resolve_node(node_hex)
        client = RpcClient(n["address"], name="dash->daemon", retries=1)
        await client.connect()
        try:
            return await client.call(method, payload, timeout=60)
        finally:
            await client.close()

    async def _node_stats(self, request):
        """Per-node psutil/store stats sampled by daemons into the control
        store (reference: dashboard reporter agents)."""
        from aiohttp import web

        reply = await self._control("get_node_stats")
        return web.json_response(reply["stats"])

    async def _workers(self, request):
        """?node=<hex>: live workers on that node."""
        from aiohttp import web

        from ray_tpu_torch.runtime.rpc import RpcError

        node = request.query.get("node", "")
        try:
            reply = await self._daemon_call(node, "list_workers", {})
        except ValueError as e:
            return web.json_response({"error": str(e)}, status=404)
        except (RpcError, ConnectionError, OSError) as e:
            return web.json_response(
                {"error": f"daemon unreachable: {e}"}, status=502)
        return web.json_response(reply["workers"])

    async def _profile(self, request):
        """?node=<hex>&worker=<hex>[&kind=threads|tasks]: on-demand stack
        sample of a live worker (reference: the dashboard's py-spy
        profiling endpoint, reporter/profile_manager.py:60-102)."""
        from aiohttp import web

        from ray_tpu_torch.runtime.rpc import RpcError

        node = request.query.get("node", "")
        worker = request.query.get("worker", "")
        kind = request.query.get("kind", "threads")
        try:
            bytes.fromhex(worker)
        except ValueError:
            return web.json_response(
                {"error": f"bad worker id {worker!r}"}, status=400)
        try:
            reply = await self._daemon_call(
                node, "profile_worker", {"worker_id": worker, "kind": kind})
        except ValueError as e:
            return web.json_response({"error": str(e)}, status=404)
        except (RpcError, ConnectionError, OSError) as e:
            return web.json_response(
                {"error": f"daemon unreachable: {e}"}, status=502)
        status = 200 if reply.get("ok") else 400
        return web.json_response(reply, status=status)

    async def _jax_profile(self, request):
        """?node=<hex>&duration=2[&logdir=...]: capture a torch.profiler
        chrome trace on that node via a pinned task, of the task's own
        worker (reference: the dashboard's JAX profiler capture,
        reporter/jax_profile_manager.py:11; the path is JAX's). The trace
        dir is created ON THE TARGET node (default: its temp dir)."""
        from aiohttp import web

        node = request.query.get("node", "")
        try:
            duration = float(request.query.get("duration", "2"))
        except ValueError:
            return web.json_response(
                {"error": "duration must be a number"}, status=400)
        logdir = request.query.get("logdir")
        try:
            n = await self._resolve_node(node)
        except ValueError as e:
            return web.json_response({"error": str(e)}, status=404)
        from ray_tpu_torch._private.core_worker import get_core_worker
        from ray_tpu_torch.gpu.profiler import node_capture_task

        cw = get_core_worker()
        ref = node_capture_task(n["node_id"].hex()).remote(logdir, duration)
        out_dir, files = await cw.get_async(ref, timeout=duration + 120)
        return web.json_response(
            {"node": n["node_id"].hex(), "logdir": out_dir, "files": files})

    async def _nodes(self, request):
        """Paginated node listing served from the delta-maintained
        aggregate (`?offset=&limit=`, default limit 100): a poll against a
        1000-node cluster transfers one page + the table's recent deltas,
        never the full table per request."""
        from aiohttp import web

        from ray_tpu_torch._private.protocol import NodeInfo

        try:
            offset = max(0, int(request.query.get("offset", 0)))
            limit = max(1, min(1000, int(request.query.get("limit", 100))))
        except ValueError:
            return web.json_response({"error": "bad offset/limit"},
                                     status=400)
        nodes = await self._node_table()
        # live first, then draining, then dead — stable within groups so
        # pages don't shuffle between polls
        order = {"ALIVE": 0, "DRAINING": 1}
        nodes.sort(key=lambda n: (order.get(n["state"], 2),
                                  n["node_id"]))
        page = nodes[offset:offset + limit]
        return web.json_response({
            "total": len(nodes),
            "offset": offset,
            "limit": limit,
            "nodes": [
                {
                    # FULL hex: these ids feed /api/workers, /api/profile
                    # and /api/jax_profile, which resolve nodes by exact id
                    "node_id": NodeInfo.from_wire(n).node_id.hex(),
                    "state": n["state"],
                    "address": n["address"],
                    "resources": NodeInfo.from_wire(n).resources.to_dict(),
                }
                for n in page
            ],
        })

    async def _actors(self, request):
        from aiohttp import web

        reply = await self._control("list_actors")
        return web.json_response([
            {
                "actor_id": a["actor_id"].hex()[:12],
                "state": a["state"],
                "name": a.get("name", ""),
                "restarts": a.get("num_restarts", 0),
            }
            for a in reply["actors"]
        ])

    async def _jobs(self, request):
        """Paginated SUBMITTED-job listing from the durable job table
        (`?offset=&limit=&tenant=&status=`, default limit 100) — the job
        plane's table, not the internal driver-job registry (that one
        lives at /api/driver_jobs)."""
        from aiohttp import web

        try:
            offset = max(0, int(request.query.get("offset", 0)))
            limit = max(1, min(1000, int(request.query.get("limit", 100))))
        except ValueError:
            return web.json_response({"error": "bad offset/limit"},
                                     status=400)
        payload = {"offset": offset, "limit": limit}
        if request.query.get("tenant"):
            payload["tenant"] = request.query["tenant"]
        if request.query.get("status"):
            payload["status"] = request.query["status"]
        reply = await self._control("job_list", payload)
        return web.json_response({
            "total": reply.get("total", 0),
            "offset": offset,
            "limit": limit,
            "jobs": [
                {
                    "submission_id": j["submission_id"],
                    "status": j.get("status", ""),
                    "tenant": j.get("tenant", ""),
                    "entrypoint": j.get("entrypoint", ""),
                    "message": j.get("message", ""),
                    "submit_time": j.get("submit_time"),
                    "start_time": j.get("start_time"),
                    "end_time": j.get("end_time"),
                }
                for j in reply.get("jobs", [])
            ],
        })

    async def _driver_jobs(self, request):
        """Internal driver-job registry (one row per attached driver)."""
        from aiohttp import web

        reply = await self._control("get_all_jobs")
        return web.json_response([
            {
                "job_id": j["job_id"].hex(),
                "finished": j.get("finished", False),
                "age_s": round(time.time() - j.get("start_time", time.time())),
            }
            for j in reply["jobs"]
        ])

    async def _tasks(self, request):
        from aiohttp import web

        reply = await self._control("list_task_events", {"limit": 200})
        return web.json_response([
            {
                "task_id": ev["task_id"].hex()[:12],
                "name": ev["name"],
                "state": ev["event"],
                "duration_s": round(ev.get("duration_s", 0), 4),
            }
            for ev in reply["events"]
        ])

    async def _task_summary(self, request):
        from aiohttp import web

        reply = await self._control("list_task_events", {"limit": 0})
        counts: Dict[str, int] = {}
        latest: Dict[bytes, str] = {}
        for ev in reply["events"]:
            if ev.get("event") == "SPAN":
                continue  # trace annotations, not task state
            latest[ev["task_id"]] = ev["event"]
        for st in latest.values():
            counts[st] = counts.get(st, 0) + 1
        return web.json_response(counts)

    async def _pgs(self, request):
        from aiohttp import web

        reply = await self._control("list_placement_groups")
        return web.json_response([
            {
                "pg_id": pg["pg_id"].hex()[:12],
                "state": pg["state"],
                "bundles": len(pg.get("bundles", [])),
            }
            for pg in reply["pgs"]
        ])

    async def _events(self, request):
        """Structured cluster event stream (reference: the aggregator
        agent's export feed). Query params: source, type, limit."""
        from aiohttp import web as _web

        try:
            payload = {"limit": int(request.query.get("limit", 1000))}
        except ValueError:
            return _web.json_response({"error": "limit must be an int"},
                                      status=400)
        for key in ("source", "type"):
            if request.query.get(key):
                payload[key] = request.query[key]
        from aiohttp import web

        reply = await self._control("list_events", payload)
        return web.json_response(reply["events"])

    async def _cluster_load(self, request):
        from aiohttp import web

        return web.json_response(await self._control("get_cluster_load"))

    async def _flight_recorder(self, request):
        """?node=<hex>: that node's flight-recorder rings (daemon + its
        workers, collected daemon-side); without ?node, the control store's
        ring — the on-demand post-mortem pull (see
        ray_tpu_torch.util.state.dump_flight_recorder for the cluster-wide
        CLI form)."""
        from aiohttp import web

        from ray_tpu_torch.runtime.rpc import RpcError

        node = request.query.get("node", "")
        if not node:
            reply = await self._control("dump_flight_recorder")
            return web.json_response({"control_store": reply})
        try:
            reply = await self._daemon_call(
                node, "collect_flight_recorders", {})
        except ValueError as e:
            return web.json_response({"error": str(e)}, status=404)
        except (RpcError, ConnectionError, OSError) as e:
            return web.json_response(
                {"error": f"daemon unreachable: {e}"}, status=502)
        return web.json_response(reply)

    async def _metrics(self, request):
        """User metrics + built-in system series (rt_node_*, rt_tasks_*,
        rt_actors_*) in one Prometheus exposition — the scrape target the
        bundled Grafana dashboard reads (reference: dashboard/modules/
        metrics/ ships Prometheus+Grafana configs the same way)."""
        from aiohttp import web

        text = await render_metrics_text(self._control)
        return web.Response(text=text, content_type="text/plain")

    async def stop(self) -> bool:
        if self._runner is not None:
            await self._runner.cleanup()
        return True


async def render_metrics_text(control) -> str:
    """The /metrics scrape body, given an async `control(method, payload)`
    callable. Module-level (not actor state) so the outage/malformed-data
    resilience is directly testable: a dead control store or a malformed
    worker snapshot must degrade the scrape, never 500 it."""
    from ray_tpu_torch.util.metrics import render_prometheus

    try:
        reply = await control("get_metrics")
        workers = reply["workers"]
    except Exception:  # noqa: BLE001 — store outage: system series may
        # still answer from a recovering store below; user metrics resume
        # on the next scrape
        workers = {}
    lines = [render_prometheus(workers).rstrip()]

    # system series are best-effort: a transient control-store error on
    # any of them must not 500 the scrape and drop the user metrics
    async def _system_series():
        out = []
        try:
            stats = (await control("get_node_stats"))["stats"]
        except Exception:  # noqa: BLE001
            stats = {}
        gauges = {"cpu_percent": "rt_node_cpu_percent",
                  "mem_percent": "rt_node_mem_percent",
                  "store_bytes": "rt_node_store_bytes"}
        for skey, mname in gauges.items():
            rows = [(n, s[skey]) for n, s in stats.items() if skey in s]
            if not rows:
                continue
            out.append(f"# TYPE {mname} gauge")
            for node, val in sorted(rows):
                out.append(f'{mname}{{node="{node[:12]}"}} {val}')

        nodes = (await control("get_all_nodes"))["nodes"]
        alive = sum(1 for n in nodes if n["state"] == "ALIVE")
        out.append("# TYPE rt_nodes_alive gauge")
        out.append(f"rt_nodes_alive {alive}")

        actors = (await control("list_actors"))["actors"]
        acounts: Dict[str, int] = {}
        for a in actors:
            acounts[str(a["state"])] = acounts.get(str(a["state"]), 0) + 1
        out.append("# TYPE rt_actors_total gauge")
        for st, n in sorted(acounts.items()):
            out.append(f'rt_actors_total{{state="{st}"}} {n}')

        evs = await control("list_task_events", {"limit": 0})
        latest: Dict[bytes, str] = {}
        for ev in evs["events"]:
            if ev.get("event") == "SPAN":
                continue  # trace annotations, not task state
            latest[ev["task_id"]] = ev["event"]
        tcounts: Dict[str, int] = {}
        for st in latest.values():
            tcounts[st] = tcounts.get(st, 0) + 1
        out.append("# TYPE rt_tasks_total gauge")
        for st, n in sorted(tcounts.items()):
            out.append(f'rt_tasks_total{{state="{st}"}} {n}')
        # task-event loss accounting (store-side view; the per-process
        # counter rides the user-metric plane as
        # rt_task_events_dropped_total)
        out.append("# TYPE rt_task_events_store_dropped_total counter")
        out.append(
            f"rt_task_events_store_dropped_total {evs.get('dropped', 0)}")
        return out

    try:
        lines.extend(await _system_series())
    except Exception:  # noqa: BLE001 — user metrics still render
        pass

    return "\n".join(lines) + "\n"


def start_dashboard(host: str = "127.0.0.1", port: int = 8265) -> str:
    """Start (or reuse) the dashboard; returns its URL (reference: the
    dashboard head process started by `ray start --head`)."""
    try:
        actor = ray_tpu_torch.get_actor(DASHBOARD_NAME,
                                        namespace=DASH_NAMESPACE)
    except ValueError:
        actor = DashboardActor.options(
            name=DASHBOARD_NAME, namespace=DASH_NAMESPACE,
            lifetime="detached", max_concurrency=64,
        ).remote(host=host, port=port)
    return ray_tpu_torch.get(actor.ready.remote(), timeout=60)


def stop_dashboard():
    try:
        actor = ray_tpu_torch.get_actor(DASHBOARD_NAME,
                                        namespace=DASH_NAMESPACE)
    except ValueError:
        return
    try:
        ray_tpu_torch.get(actor.stop.remote(), timeout=30)
    except Exception:  # noqa: BLE001
        pass
    ray_tpu_torch.kill(actor)


__all__ = ["DASHBOARD_NAME", "DASH_NAMESPACE", "DashboardActor",
           "render_metrics_text", "start_dashboard", "stop_dashboard"]
