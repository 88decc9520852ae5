"""The port's dashboard (``ray_tpu_torch/dashboard``) against the JAX
package's: ``tests/test_dashboard.py``'s five cases and
``tests/test_node_observability.py``'s three on one port cluster, its
``/api/jax_profile`` capture (a ``torch.profiler`` chrome trace) and its
refusals, every route of JAX's router, and the ``/metrics`` body of both
packages' ``render_metrics_text`` on the same scripted control replies.

The cluster and its dashboard run in the ``_port_proc`` child (the
capture's worker imports torch there); HTTP goes from the pytest worker to
the port the dashboard bound (port 0: the system picks it). The scrape
cases need no cluster, in either package.
"""

import asyncio
import json
import os
import re
import time

import pytest

import _port_proc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dash():
    with _port_proc.spawn(timeout=120) as call:
        info = call("dash_start", 4)
        yield dict(info, call=call)
        call("dash_stop")


def _get(dash, path, **kw):
    import httpx

    return httpx.get(f"{dash['url']}{path}", timeout=60, **kw)


def _poll(fn, ok, timeout):
    deadline = time.time() + timeout
    got = fn()
    while not ok(got) and time.time() < deadline:
        time.sleep(0.5)
        got = fn()
    return got


def test_dashboard_endpoints(dash):
    """``test_dashboard.py::test_dashboard_endpoints``."""
    call = dash["call"]
    assert dash["again"] == dash["url"]  # a second start reuses the actor
    assert call("dash_workload") == ("pong", 1)

    page = _get(dash, "/")
    assert page.status_code == 200 and "ray_tpu_torch dashboard" in page.text

    # /api/nodes is paginated and served from the delta-maintained cache
    page1 = _get(dash, "/api/nodes").json()
    assert page1["total"] == 1 and page1["offset"] == 0
    nodes = page1["nodes"]
    assert len(nodes) == 1 and nodes[0]["state"] == "ALIVE"
    assert nodes[0]["node_id"] == dash["node"]
    empty = _get(dash, "/api/nodes?offset=5&limit=2").json()
    assert empty["total"] == 1 and empty["nodes"] == []
    assert _get(dash, "/api/nodes?offset=x").status_code == 400

    actors = _get(dash, "/api/actors").json()
    assert any(x["name"] == "dash-actor" for x in actors)

    # the submitted-job table (nothing submitted) and the driver registry
    jobs = _get(dash, "/api/jobs").json()
    assert jobs["total"] == 0 and jobs["jobs"] == []
    assert _get(dash, "/api/jobs?offset=x").status_code == 400
    assert len(_get(dash, "/api/driver_jobs").json()) >= 1

    tasks = _poll(lambda: _get(dash, "/api/tasks").json(),
                  lambda ts: any("traced" in t["name"] for t in ts), 15)
    assert any("traced" in t["name"] for t in tasks)

    summary = _get(dash, "/api/task_summary").json()
    assert summary.get("FINISHED", 0) >= 1

    metrics = _poll(lambda: _get(dash, "/metrics").text,
                    lambda m: "dash_test_counter" in m, 15)
    assert "dash_test_counter" in metrics

    load = _get(dash, "/api/cluster_load").json()
    assert "pending_total" in load and len(load["nodes"]) == 1
    call("dash_kill_actor")


def test_web_frontend_and_metrics_export(dash):
    """``test_dashboard.py::test_web_frontend_and_metrics_export``: the
    page's views and every ``/api`` path it fetches, the ``rt_*`` series,
    and the port's Grafana and Prometheus assets."""
    assert dash["call"]("dash_series") == 1

    page = _get(dash, "/").text
    for view in ("overview", "nodes", "actors", "jobs", "tasks",
                 "placement_groups", "events"):
        assert re.search(rf'"{view}"|async {view}\(', page), view
    assert 'id="nav"' in page and 'id="main"' in page

    # every /api path the page references answers with parseable JSON
    paths = set(re.findall(r'get\("([a-z_]+)"\)', page))
    assert paths
    for path in paths:
        r = _get(dash, f"/api/{path}")
        assert r.status_code == 200, (path, r.status_code)
        r.json()

    want = ("rt_task_hop_seconds_bucket", "rt_task_events_dropped_total",
            "rt_metrics_series_dropped_total", "rt_llm_kv_blocks_in_use")
    metrics = _poll(lambda: _get(dash, "/metrics").text,
                    lambda m: all(w in m for w in want), 20)
    assert "rt_nodes_alive 1" in metrics
    assert "rt_tasks_total{" in metrics
    assert "rt_actors_total{" in metrics
    assert "rt_task_hop_seconds_bucket" in metrics
    assert "rt_task_events_store_dropped_total" in metrics
    assert "rt_llm_kv_blocks_in_use 3" in metrics
    assert "rt_llm_batch_occupancy 0.5" in metrics
    assert "rt_llm_prefix_hits_total 4" in metrics
    assert 'rt_serve_target_replicas{deployment="dash-d"} 2' in metrics

    # the port's Grafana dashboard parses and its panels query only series
    # the endpoint exports
    root = os.path.join(ROOT, "ray_tpu_torch", "dashboard", "metrics_export")
    with open(os.path.join(root, "grafana_dashboard.json")) as f:
        board = json.load(f)
    exported = set(re.findall(r"^(rt_\w+)", metrics, re.M))
    for panel in board["panels"]:
        for target in panel.get("targets", []):
            series = re.findall(r"(rt_\w+)", target["expr"])
            assert series, target
            for s in series:
                assert s in exported or s.startswith("rt_node_"), s
    with open(os.path.join(root, "prometheus.yml")) as f:
        assert "metrics_path: /metrics" in f.read()


def test_node_stats_flow_through_heartbeats(dash):
    """``test_node_observability.py``'s
    ``test_node_stats_flow_through_heartbeats``."""
    node = dash["node"]
    stats = _poll(lambda: _get(dash, "/api/node_stats").json(),
                  lambda s: s and s.get(node, {}).get("workers", 0) >= 1, 20)
    assert stats, "no node stats arrived via heartbeats"
    row = stats[node]
    assert row["workers"] >= 1
    assert "cpu_percent" in row and "mem_percent" in row
    assert row["store_heap_size"] > 0


def test_worker_listing_and_stack_profile(dash):
    """``test_node_observability.py::test_worker_listing_and_stack_profile``:
    a leased worker's thread stacks and asyncio tasks."""
    call, node = dash["call"], dash["node"]
    call("dash_long_task", 6)
    time.sleep(1.0)
    workers = _get(dash, f"/api/workers?node={node}").json()
    assert workers and all("pid" in w for w in workers)
    leased = [w for w in workers if w["state"] == "LEASED"]
    assert leased, workers
    prof = _get(dash, f"/api/profile?node={node}"
                      f"&worker={leased[0]['worker_id']}").json()
    assert prof["ok"], prof
    assert "Thread" in prof["dump"] or "File" in prof["dump"], prof["dump"]
    prof2 = _get(dash, f"/api/profile?node={node}"
                       f"&worker={leased[0]['worker_id']}&kind=tasks").json()
    assert prof2["ok"], prof2
    assert call("dash_long_result") == 1


def test_profile_unknown_worker_404s(dash):
    """``test_node_observability.py::test_profile_unknown_worker_404s``."""
    out = _get(dash, f"/api/profile?node={dash['node']}&worker={'0' * 28}")
    assert out.status_code == 400
    assert _get(dash, "/api/workers?node=beef").status_code == 404


def test_jax_profile_captures_a_chrome_trace(dash, tmp_path):
    """JAX's path, the port's trace: a capture task pinned to the node
    writes ``torch.profiler`` chrome traces into the logdir asked for."""
    node = dash["node"]
    logdir = str(tmp_path / "trace")
    r = _get(dash, "/api/jax_profile",
             params={"node": node[:12], "duration": "0.5",
                     "logdir": logdir})
    assert r.status_code == 200, r.text
    got = r.json()
    assert got["node"] == node and got["logdir"] == logdir
    assert got["files"] and all(f.startswith(logdir) for f in got["files"])
    for path in got["files"]:
        with open(path) as f:
            assert isinstance(json.load(f)["traceEvents"], list)


@pytest.mark.parametrize("query,status", [
    ("node={node}&duration=x", 400), ("node=beef", 404), ("", 404)],
    ids=["bad_duration", "unknown_node", "no_node"])
def test_jax_profile_refusals(dash, query, status):
    """JAX's refusals of the capture route: a duration that is no number,
    and a node that resolves to none."""
    r = _get(dash, "/api/jax_profile?" + query.format(node=dash["node"]))
    assert r.status_code == status, r.text
    assert "error" in r.json()


def _routes(path):
    with open(os.path.join(ROOT, path)) as f:
        return re.findall(r'add_get\("([^"]+)"', f.read())


def test_every_jax_route_is_served(dash):
    """The port's router is JAX's (``ray_tpu/dashboard/__init__.py:117-132``),
    and the routes no mirrored case reads answer too: the event stream and
    its 400, the flight recorders of the store and of the node (404 for an
    unknown node), the placement groups and the driver registry."""
    jax = _routes("ray_tpu/dashboard/__init__.py")
    assert len(jax) == 16
    assert _routes("ray_tpu_torch/dashboard/__init__.py") == jax
    node = dash["node"]
    events = _get(dash, "/api/events?limit=50")
    assert events.status_code == 200 and isinstance(events.json(), list)
    assert _get(dash, "/api/events?limit=x").status_code == 400
    fr = _get(dash, "/api/flight_recorder")
    assert fr.status_code == 200 and "control_store" in fr.json()
    assert _get(dash, f"/api/flight_recorder?node={node}").status_code == 200
    assert _get(dash, "/api/flight_recorder?node=beef").status_code == 404
    assert isinstance(_get(dash, "/api/placement_groups").json(), list)
    assert _get(dash, "/api/driver_jobs").status_code == 200


# ---------------------------------------------------------------------------
# scrape resilience and parity (no cluster needed)
# ---------------------------------------------------------------------------


def _scrape(render, control):
    return asyncio.run(render(control))


def _port_render():
    from ray_tpu_torch.dashboard import render_metrics_text

    return render_metrics_text


def test_metrics_scrape_survives_dead_control_store():
    async def dead_control(method, payload=None):
        raise ConnectionError("control store is down")

    text = _scrape(_port_render(), dead_control)
    assert text.endswith("\n")
    assert "Traceback" not in text


_GOOD_COUNTER = {"name": "rt_good_total", "type": "counter",
                 "tags": {"k": "v"}, "value": 3.0, "help": "good"}
_GOOD_HIST = {"name": "rt_good_seconds", "type": "histogram",
              "tags": {}, "boundaries": [0.1, 1.0],
              "counts": [1, 2, 3], "sum": 4.5, "help": "hist"}
_UNTYPED = {"name": "rt_untyped_thing", "type": "untyped",
            "tags": {}, "value": 7.0, "help": ""}
_MALFORMED = {
    b"good": {"metrics": [_GOOD_COUNTER, _GOOD_HIST, _UNTYPED]},
    b"missing-keys": {"metrics": [{"name": "rt_broken"},
                                  {"type": "counter"}, 42, None]},
    b"bad-shape": {"metrics": "not-a-list"},
    b"no-metrics": {"ts": 0},
    b"bad-hist": {"metrics": [{"name": "rt_good_seconds",
                               "type": "histogram", "tags": {},
                               "counts": None, "sum": None,
                               "boundaries": None}]},
}


def test_metrics_scrape_survives_malformed_worker_snapshot():
    async def control(method, payload=None):
        if method == "get_metrics":
            return {"workers": _MALFORMED}
        raise ConnectionError("rest of the store is down")

    text = _scrape(_port_render(), control)
    assert 'rt_good_total{k="v"} 3.0' in text
    assert 'rt_good_seconds_bucket{le="0.1"} 1' in text
    assert 'rt_good_seconds_bucket{le="+Inf"} 6' in text
    assert "rt_good_seconds_sum 4.5" in text
    assert "rt_good_seconds_count 6" in text
    assert "rt_untyped_thing 7.0" in text
    assert "# TYPE rt_untyped_thing untyped" in text


def test_render_prometheus_merges_histograms_across_processes():
    from ray_tpu_torch.util.metrics import render_prometheus

    def hist(counts, s):
        return {"name": "rt_m_seconds", "type": "histogram", "tags": {},
                "boundaries": [0.5], "counts": counts, "sum": s, "help": ""}

    text = render_prometheus({
        b"w1": {"metrics": [hist([1, 2], 1.0)]},
        b"w2": {"metrics": [hist([3, 4], 2.5)]},
    })
    assert 'rt_m_seconds_bucket{le="0.5"} 4' in text
    assert 'rt_m_seconds_bucket{le="+Inf"} 10' in text
    assert "rt_m_seconds_sum 3.5" in text


# a cluster's control replies: two workers' series, a daemon's stats and a
# SimNode's (the only reporter of "store_bytes"), live and dead nodes,
# actors and task events in several states, a trace span, dropped events
_DAEMON, _SIMNODE = "a1" * 16, "b2" * 16
_CLUSTER = {
    "get_metrics": {"workers": {
        b"w1": {"metrics": [
            _GOOD_COUNTER,
            {"name": "rt_llm_kv_blocks_in_use", "type": "gauge", "tags": {},
             "value": 12.0, "help": "blocks"},
            {"name": "rt_task_hop_seconds", "type": "histogram",
             "tags": {"hop": "grant"}, "boundaries": [0.01, 0.1],
             "counts": [4, 1, 0], "sum": 0.07, "help": "hops"}]},
        b"w2": {"metrics": [
            dict(_GOOD_COUNTER, value=5.0),
            {"name": "rt_task_hop_seconds", "type": "histogram",
             "tags": {"hop": "grant"}, "boundaries": [0.01, 0.1],
             "counts": [1, 1, 1], "sum": 0.3, "help": "hops"}]}}},
    "get_node_stats": {"stats": {
        _DAEMON: {"workers": 3, "cpu_percent": 12.5, "mem_percent": 40.25,
                  "store_bytes_in_use": 4096, "store_heap_size": 1 << 20},
        _SIMNODE: {"cpu_percent": 3.0, "mem_percent": 10.0,
                   "store_bytes": 2048}}},
    "get_all_nodes": {"nodes": [{"state": "ALIVE"}, {"state": "ALIVE"},
                                {"state": "DEAD"}]},
    "list_actors": {"actors": [{"state": 2}, {"state": 2}, {"state": 4},
                               {"state": "DEAD"}]},
    "list_task_events": {"events": [
        {"task_id": b"t1", "event": "SUBMITTED"},
        {"task_id": b"t1", "event": "RUNNING"},
        {"task_id": b"t1", "event": "FINISHED"},
        {"task_id": b"t2", "event": "RUNNING"},
        {"task_id": b"t3", "event": "SPAN"},
        {"task_id": b"t4", "event": "FAILED"}], "dropped": 3},
}


def _cluster_control(method, payload=None):
    return _CLUSTER[method]


def _dead_control(method, payload=None):
    raise ConnectionError("control store is down")


def _malformed_control(method, payload=None):
    if method == "get_metrics":
        return {"workers": _MALFORMED}
    raise ConnectionError("rest of the store is down")


@pytest.mark.parametrize("replies", [_cluster_control, _dead_control,
                                     _malformed_control],
                         ids=["cluster", "dead_store", "malformed_worker"])
def test_render_metrics_text_matches_jax(replies):
    """Both packages' scrape bodies, byte for byte, on the same replies.
    The reference's reading of ``store_bytes`` is kept: only the SimNode's
    row shows in ``rt_node_store_bytes``, never the daemon's
    ``store_bytes_in_use``."""
    from ray_tpu.dashboard import render_metrics_text as jax_render

    async def control(method, payload=None):
        return replies(method, payload)

    port = _scrape(_port_render(), control)
    assert port == _scrape(jax_render, control)
    if replies is _cluster_control:
        assert f'rt_node_store_bytes{{node="{_SIMNODE[:12]}"}} 2048' in port
        assert _DAEMON[:12] not in re.findall(
            r'rt_node_store_bytes\{node="(\w+)"\}', port)
        assert "rt_nodes_alive 2" in port
        assert 'rt_tasks_total{state="FINISHED"} 1' in port
        assert "rt_task_events_store_dropped_total 3" in port
