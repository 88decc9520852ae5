"""Serve controller actor: owns deployment state and drives replicas.

Reference: python/ray/serve/_private/controller.py:130 (ServeController) +
deployment_state.py:2877 (replica lifecycle) + autoscaling_policy.py. One
detached controller per cluster reconciles target vs running replicas and
autoscales on the replicas' reported in-flight request counts.
"""

from __future__ import annotations

import asyncio
from typing import Dict, Optional

import ray_tpu_torch

CONTROLLER_NAME = "serve-controller"
SERVE_NAMESPACE = "_serve"


@ray_tpu_torch.remote
class ServeController:
    """Async actor reconciling deployments (reference: controller.py:130)."""

    def __init__(self):
        # name -> {"config": {...}, "replicas": [handles], "target": int}
        self.deployments: Dict[str, dict] = {}
        # tombstones: deletion must stay distinguishable from "this
        # controller never heard of it" (an amnesiac auto-recreated
        # controller) — handles honor a deleted deployment's empty set
        # but keep serving a last-known set through an amnesiac one
        self._deleted: set = set()
        self._reconcile_task = None
        self._running = True
        # All replica-set mutations interleave on the actor's event loop
        # (deploy / delete / reconcile are concurrent method calls); without
        # mutual exclusion a reconcile resuming from an await can re-create
        # replicas of a deployment a concurrent delete just tore down,
        # leaking detached actors that pin node resources forever.
        self._scale_lock = asyncio.Lock()
        # per-node proxy fleet (None = single-proxy dev mode)
        self._proxy_cfg: Optional[dict] = None
        self._proxies: Dict[str, dict] = {}  # node hex -> {actor, url}
        # ensure_proxies and the reconcile tick both mutate the fleet; two
        # interleaved creates for one node would race on the named actor
        self._proxy_lock = asyncio.Lock()

    async def _ensure_loop(self):
        t = self._reconcile_task
        if t is not None and t.done():
            # a crashed loop must not stay dead silently (its exception was
            # never awaited) — log and restart
            exc = t.exception() if not t.cancelled() else None
            if exc is not None:
                import logging

                logging.getLogger(__name__).error(
                    "serve reconcile loop crashed: %r — restarting", exc)
            t = None
        if t is None:
            self._reconcile_task = asyncio.ensure_future(self._reconcile_loop())

    # -- deployment API -------------------------------------------------

    @staticmethod
    def _config_matches(old_cfg: dict, new_cfg: dict) -> Optional[str]:
        """None if the new config is the same logical deployment (in-place
        rescale is safe); else the name of the first differing field.

        Identity is the explicitly-passed options plus, for the code blobs,
        the user-supplied `version` when one is given — cloudpickle bytes
        are not guaranteed deterministic across calls for the same logical
        callable, so a byte mismatch alone must not force a roll when the
        user pinned a version (reference: serve deployment `version=` and
        the lightweight-config-update path in deployment_state.py)."""
        for k in ("autoscaling", "actor_options", "max_concurrent",
                  "max_queued"):
            if old_cfg.get(k) != new_cfg.get(k):
                return k
        if old_cfg.get("version") is not None \
                and old_cfg.get("version") == new_cfg.get("version"):
            return None
        if old_cfg.get("version") != new_cfg.get("version"):
            return "version"
        # no version pinned on either side: fall back to blob bytes
        for k in ("callable_blob", "init_args_blob"):
            if old_cfg[k] != new_cfg[k]:
                return k
        return None

    async def deploy(self, name: str, callable_blob: bytes,
                     init_args_blob: bytes, num_replicas: int,
                     autoscaling: Optional[dict] = None,
                     actor_options: Optional[dict] = None,
                     max_concurrent: int = 100,
                     version: Optional[str] = None,
                     max_queued: Optional[int] = None) -> bool:
        await self._ensure_loop()
        if max_queued is None:
            from ray_tpu_torch._private.config import GLOBAL_CONFIG

            max_queued = GLOBAL_CONFIG.get("serve_max_queued_requests")
        config = {
            "callable_blob": callable_blob,
            "init_args_blob": init_args_blob,
            "autoscaling": autoscaling,
            "actor_options": dict(actor_options or {}),
            "max_concurrent": max_concurrent,
            "max_queued": max_queued,
            "version": version,
        }
        async with self._scale_lock:
            self._deleted.discard(name)
            old = self.deployments.get(name)
            differs = (None if old is None
                       else self._config_matches(old["config"], config))
            if old is not None and differs is None:
                # same logical deployment: a pure replica-count update —
                # rescale in place, no roll (reference: deployment_state
                # only restarts replicas whose config actually changed).
                # Keep the OLD blobs so new replicas of a version-pinned
                # deployment match the running ones byte-for-byte.
                old["target"] = num_replicas
                await self._scale_to_locked(name, num_replicas)
                return True
            if old is not None:
                # config change (field `differs`): roll all existing
                # replicas (no publish for the intermediate empty set)
                import logging

                logging.getLogger(__name__).info(
                    "serve deployment %s: rolling restart (config field "
                    "%r changed)", name, differs)
                old["target"] = 0
                await self._scale_to_locked(name, 0, publish=False)
            self.deployments[name] = {
                "config": config,
                "replicas": [],
                "next_id": old["next_id"] if old else 0,
                "target": num_replicas,
            }
            await self._scale_to_locked(name, num_replicas)
        return True

    async def delete_deployment(self, name: str) -> bool:
        async with self._scale_lock:
            if name in self.deployments:
                await self._scale_to_locked(name, 0)
                del self.deployments[name]
                self._deleted.add(name)
        return True

    async def get_replicas(self, name: str) -> list:
        d = self.deployments.get(name)
        if d is None:
            return []
        # Filter replicas this worker already knows are dead (actor-state
        # pubsub lands here between reconcile ticks) — don't hand a router a
        # replica we know can't serve. The reconcile loop replaces them.
        from ray_tpu_torch._private import protocol as pb
        from ray_tpu_torch._private.core_worker import get_core_worker

        cw = get_core_worker()
        live = []
        for r in d["replicas"]:
            st = cw._actor_states.get(r._actor_id.binary())
            if st is not None and st.state == pb.ACTOR_DEAD:
                continue
            live.append(r)
        return live

    async def get_routing_info(self, name: str) -> dict:
        """Replica set + admission capacity for the handle's router. The
        `known` bit lets a handle distinguish "deployment deleted" (honor
        the empty set) from "this controller has never heard of it" (an
        amnesiac controller freshly auto-created after a crash — the
        handle keeps serving its last-known set)."""
        d = self.deployments.get(name)
        if d is None:
            # a tombstoned name IS known — deleted: the empty set is
            # authoritative and handles must stop routing to the corpses
            return {"known": name in self._deleted, "replicas": [],
                    "max_concurrent": 0, "max_queued": -1}
        cfg = d["config"]
        return {
            "known": True,
            "replicas": await self.get_replicas(name),
            "max_concurrent": cfg["max_concurrent"],
            "max_queued": cfg.get("max_queued", -1),
        }

    async def list_deployments(self) -> dict:
        return {
            name: {
                "target": d["target"],
                "running": len(d["replicas"]),
                "autoscaling": d["config"]["autoscaling"],
            }
            for name, d in self.deployments.items()
        }

    async def debug_state(self) -> dict:
        t = self._reconcile_task
        return {
            "deployments": {
                name: {
                    "target": d["target"],
                    "replicas": [r._actor_id.hex()[:8] for r in d["replicas"]],
                }
                for name, d in self.deployments.items()
            },
            "lock_locked": self._scale_lock.locked(),
            "reconcile": (
                "none" if t is None
                else "done:" + repr(t.exception() if not t.cancelled() else "cancelled")
                if t.done() else "running"
            ),
        }

    async def shutdown(self) -> bool:
        self._running = False
        await self.shutdown_proxies()
        for name in list(self.deployments):
            await self.delete_deployment(name)
        return True

    # -- reconciliation -------------------------------------------------

    @staticmethod
    async def _await_ref(ref):
        # plain-coroutine wrapper: asyncio.wait_for needs something
        # ensure_future understands on every supported Python
        return await ref

    async def _probe(self, ref, timeout: Optional[float] = None):
        """Deadline-bounded replica probe. Every await of a replica's
        health/stats from the reconcile path MUST ride this: an unbounded
        await on a wedged replica freezes the deployment's reconcile (and
        with it scaling and failure replacement) forever."""
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        if timeout is None:
            timeout = GLOBAL_CONFIG.get("serve_health_probe_timeout_s")
        return await asyncio.wait_for(self._await_ref(ref), timeout=timeout)

    async def _kill_replica(self, replica):
        """Awaited kill: ray_tpu_torch.kill from the controller's event loop is
        fire-and-forget, and a controller torn down right after scheduling
        the kill would leak the detached named replica forever."""
        from ray_tpu_torch._private.core_worker import get_core_worker

        try:
            await get_core_worker().kill_actor(
                replica._actor_id.binary(), no_restart=True)
        except Exception:  # noqa: BLE001 — already dead
            pass

    async def _scale_to_locked(self, name: str, target: int,
                               publish: bool = True):
        """Scale a deployment's replica set; caller must hold _scale_lock.
        Re-checks deployment identity after every await — a redeploy swaps
        the dict and this scale must not touch the new generation."""
        from ray_tpu_torch.serve._replica import ServeReplica

        d = self.deployments.get(name)
        if d is None:
            return
        cfg = d["config"]
        before = [id(r) for r in d["replicas"]]
        while len(d["replicas"]) < target:
            rid = d["next_id"]
            d["next_id"] += 1
            opts = dict(cfg["actor_options"])
            anti_spot = {}
            if not d["replicas"] and "label_selector" not in opts:
                # the deployment's FIRST replica prefers non-spot capacity:
                # scale-down pops newest-first, so this one is also the
                # LAST to go — a correlated spot-reclaim wave can dent the
                # replica set but not empty it (all-spot falls back)
                from ray_tpu_torch._private.spot import anti_spot_placement_async

                anti_spot = await anti_spot_placement_async(
                    f"serve deployment {name!r} replica 0")
            replica = ServeReplica.options(
                name=f"serve:{name}:{rid}", namespace=SERVE_NAMESPACE,
                max_concurrency=max(8, cfg["max_concurrent"]),
                lifetime="detached", **{**anti_spot, **opts},
            ).remote(
                name, rid, cfg["callable_blob"], cfg["init_args_blob"],
                max_concurrent=cfg["max_concurrent"],
                max_queued=cfg.get("max_queued", -1),
            )
            # fail fast if the replica can't construct — and reap the actor,
            # or a late start would leak a detached replica holding
            # resources. BOUNDED: a replica wedged in __init__ (chaos
            # stall, deadlocked model load) must not freeze this
            # deployment's reconcile forever — expiry is unhealthy.
            from ray_tpu_torch._private.config import GLOBAL_CONFIG

            try:
                await asyncio.wait_for(
                    self._await_ref(replica.health.remote()),
                    timeout=GLOBAL_CONFIG.get("serve_replica_init_timeout_s"))
            except Exception:
                await self._kill_replica(replica)
                if not anti_spot:
                    raise
                # the anti-spot preference was chosen from a snapshot: the
                # non-spot capacity may be full or gone. The preference
                # must never turn a placeable replica into a deploy
                # failure — retry unconstrained (name suffix: the dead
                # detached actor's name frees asynchronously)
                replica = ServeReplica.options(
                    name=f"serve:{name}:{rid}r", namespace=SERVE_NAMESPACE,
                    max_concurrency=max(8, cfg["max_concurrent"]),
                    lifetime="detached", **opts,
                ).remote(
                    name, rid, cfg["callable_blob"], cfg["init_args_blob"],
                    max_concurrent=cfg["max_concurrent"],
                    max_queued=cfg.get("max_queued", -1),
                )
                try:
                    await asyncio.wait_for(
                        self._await_ref(replica.health.remote()),
                        timeout=GLOBAL_CONFIG.get(
                            "serve_replica_init_timeout_s"))
                except Exception:
                    await self._kill_replica(replica)
                    raise
            if self.deployments.get(name) is not d:
                await self._kill_replica(replica)
                return
            d["replicas"].append(replica)
        while len(d["replicas"]) > target:
            await self._kill_replica(d["replicas"].pop())
        # config PUSH (reference: long_poll.py:318 — the controller notifies
        # routers of replica-set changes instead of them polling a TTL).
        # Only on CHANGE (the reconcile tick calls this every second), and
        # never for the intermediate roll-to-0 of a redeploy (publish=False
        # there: handles refreshing into an empty set would hard-fail while
        # the ActorDied failover path rides out the roll).
        if publish and [id(r) for r in d["replicas"]] != before:
            try:
                from ray_tpu_torch._private.core_worker import get_core_worker

                cw = get_core_worker()
                # short timeout: the push is an optimization and this
                # runs under _scale_lock — a wedged control store must not
                # freeze every deployment's reconcile for retry-minutes
                await cw.control.call("publish", {
                    "channel": "serve",
                    "message": {"name": name,
                                "replicas": len(d["replicas"])},
                }, timeout=2)
            except Exception:  # noqa: BLE001 — push is an optimization
                pass

    async def _reconcile_loop(self):
        """Autoscaling + health: every second, poll replica stats; scale
        toward ceil(total_ongoing / target_ongoing_requests) within
        [min_replicas, max_replicas] (reference: autoscaling_policy.py
        request-based policy)."""
        while self._running:
            await asyncio.sleep(1.0)
            for name, d in list(self.deployments.items()):
                try:
                    await self._reconcile_deployment(name, d)
                except Exception:  # noqa: BLE001 — one deployment's failure
                    # must not kill reconciliation for the rest
                    import logging

                    logging.getLogger(__name__).exception(
                        "reconcile of %s failed", name)
            if self._proxy_cfg is not None:
                try:
                    await self._reconcile_proxies()
                except Exception:  # noqa: BLE001 — heal next tick
                    import logging

                    logging.getLogger(__name__).exception(
                        "proxy-fleet reconcile failed")

    # -- per-node proxy fleet (reference: proxy.py:1031 one proxy per
    # node + proxy_state.py's controller-side fleet state) ---------------

    async def ensure_proxies(self, host: str = "127.0.0.1",
                             port: int = 0) -> dict:
        """Switch the ingress to a per-node fleet: one HTTP proxy pinned
        to every ALIVE node, healed as nodes come and go. port=0 gives
        each proxy an ephemeral port (several proxies share a host in
        tests); a fixed port maps one-to-one on real multi-host clusters.
        Returns {node_id_hex: url}."""
        self._proxy_cfg = {"host": host, "port": port}
        await self._reconcile_proxies()
        return await self.proxy_urls()

    async def proxy_urls(self) -> dict:
        return {n: p["url"] for n, p in self._proxies.items()}

    async def _reconcile_proxies(self):
        from ray_tpu_torch._private.core_worker import get_core_worker
        from ray_tpu_torch.serve._http import HttpProxy

        async with self._proxy_lock:
            cfg = self._proxy_cfg
            if cfg is None:
                return
            cw = get_core_worker()
            reply = await cw.control.call("get_all_nodes", {}, timeout=10)
            alive = {n["node_id"].hex() for n in reply["nodes"]
                     if n["state"] == "ALIVE"}
            # forget (and reap) proxies on dead nodes
            for node in list(self._proxies):
                if node not in alive:
                    p = self._proxies.pop(node)
                    try:
                        await cw.kill_actor(
                            p["actor"]._actor_id.binary(), no_restart=True)
                    except Exception:  # noqa: BLE001 — died with its node
                        pass
            for node in alive:
                if node in self._proxies:
                    continue
                proxy = HttpProxy.options(
                    name=f"serve-http-proxy:{node[:12]}",
                    namespace=SERVE_NAMESPACE, lifetime="detached",
                    max_concurrency=256,
                    scheduling_strategy=f"node:{node}",
                ).remote(host=cfg["host"], port=cfg["port"])
                try:
                    # bounded: a wedged bind must not freeze the shared
                    # reconcile loop (deployment scaling rides it too)
                    url = await asyncio.wait_for(
                        proxy.ready.remote(), timeout=60)
                except Exception:  # noqa: BLE001 — reap; retry next tick
                    try:
                        await cw.kill_actor(
                            proxy._actor_id.binary(), no_restart=True)
                    except Exception:  # noqa: BLE001
                        pass
                    continue
                self._proxies[node] = {"actor": proxy, "url": url}

    async def shutdown_proxies(self):
        from ray_tpu_torch._private.core_worker import get_core_worker

        cw = get_core_worker()
        for p in self._proxies.values():
            try:
                await p["actor"].stop.remote()
            except Exception:  # noqa: BLE001
                pass
            try:
                await cw.kill_actor(
                    p["actor"]._actor_id.binary(), no_restart=True)
            except Exception:  # noqa: BLE001
                pass
        self._proxies = {}
        self._proxy_cfg = None

    async def _reconcile_deployment(self, name: str, d: dict):
        async with self._scale_lock:
            if self.deployments.get(name) is not d:
                return  # deleted or redeployed while we waited for the lock
            auto = d["config"]["autoscaling"]
            # replace dead replicas. Probes are DEADLINE-BOUNDED: a replica
            # stalled by chaos (testing_rpc_stall) or wedged user code
            # previously froze this await — and the whole deployment's
            # reconcile — forever. Expiry is unhealthy: the replica is
            # killed (it still exists but can't serve; dropping it without
            # the kill would leak a detached actor) and replaced below.
            # Probes run CONCURRENTLY: this holds _scale_lock, and N wedged
            # replicas probed serially would stall deploys for N timeouts.
            async def health_of(r):
                try:
                    await self._probe(r.health.remote())
                    return "alive"
                except asyncio.TimeoutError:
                    return "wedged"
                except Exception:  # noqa: BLE001 — replica died
                    return "dead"

            verdicts = await asyncio.gather(
                *[health_of(r) for r in d["replicas"]])
            alive = []
            for r, verdict in zip(d["replicas"], verdicts):
                if verdict == "alive":
                    alive.append(r)
                elif verdict == "wedged":
                    import logging

                    logging.getLogger(__name__).warning(
                        "serve deployment %s: replica health probe timed "
                        "out — ejecting the wedged replica", name)
                    await self._kill_replica(r)
            if self.deployments.get(name) is not d:
                return
            d["replicas"] = alive

            if auto is None:
                if len(d["replicas"]) < d["target"]:
                    await self._scale_to_locked(name, d["target"])
                return

            async def stats_of(r):
                try:
                    return await self._probe(r.stats.remote())
                except Exception:  # noqa: BLE001
                    return None

            stats = [st for st in await asyncio.gather(
                *[stats_of(r) for r in d["replicas"]]) if st is not None]
            if self.deployments.get(name) is not d:
                return
            from ray_tpu_torch.serve._autoscaling import AutoscalingPolicy

            policy = d.get("policy")
            if policy is None or policy.config != dict(auto):
                policy = AutoscalingPolicy(auto)
                d["policy"] = policy
            raw = policy.desired_from_stats(stats, len(d["replicas"]))
            d["target"] = policy.update(raw, d["target"])
            from ray_tpu_torch.util.metrics import Gauge

            Gauge("rt_serve_target_replicas",
                  "Autoscaler target replica count per serve deployment.",
                  ("deployment",)).set(d["target"], {"deployment": name})
            running = len(d["replicas"])
            if d["target"] > running:
                # scale up only to what the cluster can PLACE right now;
                # the shortfall rides the report_demand plane so the node
                # autoscaler launches capacity for it, and a later tick
                # (d["target"] unchanged) places the rest when nodes land.
                # A blocking actor-create for an unplaceable replica would
                # instead pin _scale_lock for the 60s init timeout.
                placeable, unplaceable = await self._placeability(
                    d, d["target"] - running)
                await self._report_replica_demand(name, d, unplaceable)
                await self._scale_to_locked(name, running + placeable)
            else:
                await self._report_replica_demand(name, d, 0)
                await self._scale_to_locked(name, d["target"])

    async def _placeability(self, d: dict, pending: int):
        """(placeable, unplaceable) split of `pending` new replicas against
        the cluster's current free capacity. Load-read failure degrades to
        all-placeable: _scale_to_locked's own init timeout remains the
        backstop, and demand under-report only delays node launch."""
        from ray_tpu_torch.serve._autoscaling import count_placeable, replica_shape

        shape = replica_shape(d["config"].get("actor_options") or {})
        try:
            from ray_tpu_torch._private.core_worker import get_core_worker

            cw = get_core_worker()
            reply = await cw.control.call("get_cluster_load", {}, timeout=5)
            nodes = reply.get("nodes") or []
        except Exception:  # noqa: BLE001 — control store unreachable
            return pending, 0
        placeable = count_placeable(shape, nodes, pending)
        return placeable, pending - placeable

    async def _report_replica_demand(self, name: str, d: dict,
                                     unplaceable: int):
        """Publish (or withdraw) pending-replica shapes on the
        report_demand plane. Re-published every reconcile tick while
        non-empty so the TTL stays fresh; withdrawn ONCE when the backlog
        clears (tracked per deployment) instead of spamming empty writes."""
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        if not GLOBAL_CONFIG.get("serve_autoscale_demand_report"):
            return
        if unplaceable <= 0 and not d.get("demand_published"):
            return
        from ray_tpu_torch.serve._autoscaling import (demand_key, demand_shapes,
                                                replica_shape)

        shape = replica_shape(d["config"].get("actor_options") or {})
        try:
            from ray_tpu_torch._private.core_worker import get_core_worker

            cw = get_core_worker()
            await cw.control.call("report_demand", {
                "key": demand_key(name),
                "shapes": demand_shapes(shape, unplaceable),
            }, timeout=2)
            d["demand_published"] = unplaceable > 0
        except Exception:  # noqa: BLE001 — best-effort; TTL ages out stale
            pass


def _create_controller(placement: Optional[dict] = None):
    # the controller is a cluster singleton: keep it off spot capacity so a
    # correlated reclaim wave can't take the serve control point down with
    # the replicas it would be failing over (all-spot clusters fall back)
    if placement is None:
        from ray_tpu_torch._private.spot import anti_spot_placement

        placement = anti_spot_placement("the serve controller")
    return ServeController.options(
        name=CONTROLLER_NAME, namespace=SERVE_NAMESPACE, lifetime="detached",
        max_concurrency=64, **placement,
    ).remote()


def get_or_create_controller():
    """Named detached controller, one per cluster (reference:
    serve.start creating the controller under SERVE_CONTROLLER_NAME)."""
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME, namespace=SERVE_NAMESPACE)
    except ValueError:
        pass
    try:
        return _create_controller()
    except Exception as e:  # noqa: BLE001 — name-collision race only
        if "already taken" not in str(e):
            raise
        return ray_tpu_torch.get_actor(CONTROLLER_NAME, namespace=SERVE_NAMESPACE)


async def get_or_create_controller_async():
    """Loop-safe variant for async actors (the HTTP proxy) — a blocking
    get_actor on the core event loop would deadlock."""
    from ray_tpu_torch._private.worker import get_actor_async

    try:
        return await get_actor_async(CONTROLLER_NAME, namespace=SERVE_NAMESPACE)
    except ValueError:
        pass
    from ray_tpu_torch._private.spot import anti_spot_placement_async

    return _create_controller(
        await anti_spot_placement_async("the serve controller"))
