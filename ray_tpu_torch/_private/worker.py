"""Driver/worker global state and the sync↔async bridge.

Capability parity with the reference's worker module (reference:
python/ray/_private/worker.py:442 Worker, :1438 ray.init, :2855 ray.get,
:3080 ray.wait, :2069 ray.shutdown): holds the process-wide connection state
and bridges the synchronous public API onto the core worker's asyncio loop,
which runs on a dedicated background thread in driver processes.
"""

from __future__ import annotations

import asyncio
import atexit
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private import node as node_mod
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.core_worker import (
    MODE_DRIVER,
    CoreWorker,
    ObjectRef,
    get_core_worker,
    set_core_worker,
)
from ray_tpu_torch._private.errors import RayTpuError
from ray_tpu_torch._private.ids import JobID
from ray_tpu_torch._private.protocol import NodeInfo


class DriverContext:
    """Everything ray_tpu_torch.init() sets up in a driver process."""

    def __init__(self):
        self.core_worker: Optional[CoreWorker] = None
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self.loop_thread: Optional[threading.Thread] = None
        self.owned_processes: list = []
        self.session_dir: str = ""
        self.control_address: str = ""
        self.initialized = False

    def start_loop(self):
        ready = threading.Event()

        def run():
            self.loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self.loop)
            self.loop._thread_ident = threading.get_ident()
            ready.set()
            self.loop.run_forever()

        self.loop_thread = threading.Thread(target=run, name="ray-tpu-driver-loop", daemon=True)
        self.loop_thread.start()
        ready.wait()

    def stop_loop(self):
        if self.loop is not None:
            # cancel stragglers (best-effort lease returns, background
            # fetches) before stopping: the deadline-bounded shutdown no
            # longer idles long enough for them to finish on their own, and
            # a stopped loop full of pending tasks spews "Task was
            # destroyed but it is pending!" at interpreter exit
            def _drain_and_stop():
                for task in asyncio.all_tasks(self.loop):
                    task.cancel()
                self.loop.call_soon(self.loop.stop)

            self.loop.call_soon_threadsafe(_drain_and_stop)
            self.loop_thread.join(timeout=5)
            self.loop = None


_context = DriverContext()


def global_context() -> DriverContext:
    return _context


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
    labels: Optional[Dict[str, str]] = None,
    system_config: Optional[Dict[str, Any]] = None,
    ignore_reinit_error: bool = False,
) -> Dict[str, Any]:
    """Start a new local cluster (head) or connect to an existing one.

    Reference: ray.init python/ray/_private/worker.py:1438. An
    ``rt://host:port`` address connects as a REMOTE client (reference: Ray
    Client, python/ray/util/client): a driver with no host shm store whose
    object reads/writes ride daemon RPCs — same API, works from a machine
    that is not a cluster node (requires bidirectional routability: cluster
    workers resolve borrowed args by calling back to this driver).
    """
    if _context.initialized:
        if ignore_reinit_error:
            return {"address": _context.control_address}
        raise RayTpuError("ray_tpu_torch.init() already called (pass ignore_reinit_error=True)")
    if system_config:
        GLOBAL_CONFIG.apply_system_config(system_config)
    if "RT_CHAOS_ROLE" not in os.environ:
        # the driver's stable chaos role (spawned processes inherit labels
        # via RT_CHAOS_ROLE; see _private.chaos determinism contract)
        from ray_tpu_torch._private import chaos

        chaos.set_role("driver")

    client_mode = address is not None and address.startswith("rt://")
    if client_mode:
        address = address[len("rt://"):]

    if address is None:
        # head mode: spawn control store + a node daemon
        session_dir = node_mod.new_session_dir()
        cs_proc, control_address = node_mod.start_control_store(session_dir)
        _context.owned_processes.append(cs_proc)
        if GLOBAL_CONFIG.get("store_standby_enabled"):
            # warm standby: tails the shared WAL and takes over at the
            # primary's address on its death (control-store HA). The
            # standby fate-shares the head host (shared-WAL requirement) —
            # it cannot be placed elsewhere, so spot-awareness here is a
            # loud signal, not a constraint: a spot head loses primary AND
            # standby to one reclaim
            if (resources or {}).get("spot") or \
                    (labels or {}).get("spot") == "true" or \
                    (labels or {}).get("preemptible") == "true":
                import logging

                logging.getLogger(__name__).warning(
                    "control-store HA standby is being spawned on a "
                    "spot-labeled head host: one spot reclaim takes the "
                    "primary and the standby together — run the head on "
                    "non-spot capacity for real failover coverage")
            _context.owned_processes.append(
                node_mod.start_standby_store(session_dir, control_address))
        res = dict(resources or {})
        if num_cpus is not None:
            res["CPU"] = float(num_cpus)
        nd_proc, nd_info = node_mod.start_node_daemon(
            control_address, session_dir, resources=res or None, labels=labels
        )
        _context.owned_processes.append(nd_proc)
        daemon_address = nd_info["address"]
        node_id_hex = nd_info["node_id"]
        store_name = nd_info["store_name"]
        _context.session_dir = session_dir
    else:
        control_address = address
        _context.session_dir = node_mod.new_session_dir()
        daemon_address = node_id_hex = store_name = None  # resolved below

    _context.control_address = control_address
    _context.start_loop()
    loop = _context.loop

    async def boot():
        from ray_tpu_torch.runtime.rpc import RpcClient

        cs = RpcClient(control_address, name="driver-boot")
        await cs.connect()
        nonlocal_info = {}
        if daemon_address is None:
            # connect mode: adopt the first live node on this host as local
            deadline = time.monotonic() + 10
            while True:
                nodes = (await cs.call("get_all_nodes", {}))["nodes"]
                live = [NodeInfo.from_wire(n) for n in nodes]
                live = [n for n in live if n.state == "ALIVE"]
                if live:
                    break
                if time.monotonic() > deadline:
                    raise RayTpuError("no live nodes in cluster to attach to")
                await asyncio.sleep(0.1)
            info = live[0]
            nonlocal_info = {
                "daemon": info.address,
                "node_id": info.node_id.hex(),
                "store": info.object_store_name,
            }
        job_reply = await cs.call("add_job", {"driver_address": ""})
        await cs.close()
        return nonlocal_info, job_reply["job_id"]

    info, job_id_bytes = asyncio.run_coroutine_threadsafe(boot(), loop).result(30)
    if daemon_address is None:
        daemon_address = info["daemon"]
        node_id_hex = info["node_id"]
        store_name = info["store"]
    if client_mode:
        store_name = None  # storeless: never mmap a (possibly remote) shm

    cw = CoreWorker(
        mode=MODE_DRIVER,
        control_address=control_address,
        daemon_address=daemon_address,
        store_name=store_name,
        node_id_hex=node_id_hex,
        job_id=JobID(job_id_bytes),
        loop=loop,
    )
    asyncio.run_coroutine_threadsafe(cw.start(), loop).result(30)
    set_core_worker(cw)
    _context.core_worker = cw
    _context.initialized = True
    atexit.register(shutdown)
    return {
        "address": control_address,
        "session_dir": _context.session_dir,
        "job_id": JobID(job_id_bytes).hex(),
        "node_id": node_id_hex,
    }


def shutdown():
    if not _context.initialized:
        return
    # One deadline bounds the WHOLE exit sequence (unified deadline
    # machinery from _private.retry): a drain or control-store failover in
    # progress must not hang driver exit — each step gets the remaining
    # budget, clipped to its usual per-step cap.
    from ray_tpu_torch._private.retry import Backoff, deadline_from_timeout

    budget = Backoff(deadline=deadline_from_timeout(
        GLOBAL_CONFIG.get("shutdown_timeout_s")))
    cw = _context.core_worker
    try:
        # finish_job is best-effort: a live store answers in milliseconds,
        # so the tight retry-chain deadline only bites when the store is
        # gone/wedged — an exiting driver must not burn seconds of backoff
        # reporting to a control store that cannot hear it
        asyncio.run_coroutine_threadsafe(
            cw.control.call("finish_job", {"job_id": cw.job_id.binary()},
                            timeout=budget.clamp(5),
                            deadline=deadline_from_timeout(budget.clamp(1.5))),
            _context.loop,
        ).result(budget.clamp(10))
    except Exception:  # noqa: BLE001
        pass
    try:
        if not budget.expired():
            asyncio.run_coroutine_threadsafe(
                cw.close(), _context.loop).result(budget.clamp(10))
    except Exception:  # noqa: BLE001
        pass
    set_core_worker(None)
    _context.core_worker = None
    _context.stop_loop()
    for proc in reversed(_context.owned_processes):
        node_mod.kill_process(proc)
    _context.owned_processes.clear()
    _context.initialized = False
    atexit.unregister(shutdown)


def is_initialized() -> bool:
    return _context.initialized


def get(refs, timeout: Optional[float] = None):
    cw = get_core_worker()
    if cw._loop_running_here():
        raise RuntimeError(
            "ray_tpu_torch.get() cannot block inside an async actor — use "
            "`await ref` (or gather multiple refs) instead"
        )
    # unwrap ref-like wrappers (e.g. serve's _TrackedRef) that carry the
    # real ObjectRef in ._ref
    if not isinstance(refs, ObjectRef) and hasattr(refs, "_ref"):
        refs = refs._ref
    single = isinstance(refs, ObjectRef)
    if single:
        refs = [refs]
    else:
        refs = [r._ref if not isinstance(r, ObjectRef) and hasattr(r, "_ref")
                else r for r in refs]
    if not all(isinstance(r, ObjectRef) for r in refs):
        raise TypeError("ray_tpu_torch.get() accepts an ObjectRef or a list of ObjectRefs")
    bridge_timeout = None if timeout is None else timeout + 30
    values = cw.run_sync(cw.get_objects(refs, timeout), bridge_timeout)
    return values[0] if single else values


def put(value) -> ObjectRef:
    cw = get_core_worker()
    if cw._loop_running_here():
        raise RuntimeError(
            "ray_tpu_torch.put() cannot block inside an async actor — use "
            "`await cw.put_object(value)` via an executor thread instead"
        )
    return cw.run_sync(cw.put_object(value))


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    cw = get_core_worker()
    if cw._loop_running_here():
        raise RuntimeError(
            "ray_tpu_torch.wait() cannot block inside an async actor — await the "
            "refs (e.g. asyncio.wait on them) instead"
        )
    if num_returns > len(refs):
        raise ValueError("num_returns exceeds the number of refs")
    bridge_timeout = None if timeout is None else timeout + 30
    return cw.run_sync(cw.wait_objects(refs, num_returns, timeout), bridge_timeout)


def nodes() -> List[dict]:
    cw = get_core_worker()
    reply = cw.run_sync(cw.control.call("get_all_nodes", {}))
    out = []
    for n in reply["nodes"]:
        info = NodeInfo.from_wire(n)
        out.append({
            "node_id": info.node_id.hex(),
            "address": info.address,
            "state": info.state,
            "resources": info.resources.to_dict(),
            "labels": info.labels,
            "drain_reason": info.drain_reason,
            "drain_deadline": info.drain_deadline,
            "death": info.death.to_wire() if info.death else None,
        })
    return out


def cluster_resources() -> Dict[str, float]:
    return _sum_resources(
        n["resources"] for n in nodes() if n["state"] == "ALIVE"
    )


def available_resources() -> Dict[str, float]:
    from ray_tpu_torch._private.protocol import ResourceSet

    cw = get_core_worker()
    view = cw.run_sync(cw.control.call("get_resource_view", {})).get("view", {})
    return _sum_resources(ResourceSet.from_wire(w).to_dict() for w in view.values())


def _sum_resources(dicts) -> Dict[str, float]:
    total: Dict[str, float] = {}
    for d in dicts:
        for k, v in d.items():
            total[k] = total.get(k, 0) + v
    return total


def cancel(ref_or_gen, *, force: bool = False, recursive: bool = False) -> bool:
    """Cancel a submitted task (reference: ray.cancel,
    python/ray/_private/worker.py). Queued tasks are dequeued and their
    returns resolve to TaskCancelledError; running tasks get the error raised
    into their execution (best-effort for sync tasks); `force=True` kills the
    executing worker process. `recursive` is accepted for API parity; child
    tasks are not chased."""
    from ray_tpu_torch._private.core_worker import ObjectRefGenerator

    cw = get_core_worker()
    if isinstance(ref_or_gen, ObjectRefGenerator):
        return cw.run_sync(
            cw.cancel_task_by_id(ref_or_gen._task_id, force=force), 30
        )
    if not isinstance(ref_or_gen, ObjectRef):
        raise TypeError("ray_tpu_torch.cancel() expects an ObjectRef or ObjectRefGenerator")
    return cw.run_sync(cw.cancel_task(ref_or_gen, force=force, recursive=recursive), 30)


def kill(actor, no_restart: bool = True):
    from ray_tpu_torch.actor import ActorHandle

    if not isinstance(actor, ActorHandle):
        raise TypeError("ray_tpu_torch.kill() expects an ActorHandle")
    cw = get_core_worker()
    if cw._loop_running_here():
        # from inside an async actor: fire-and-forget (run_sync would
        # deadlock the shared event loop)
        cw.schedule(cw.kill_actor(actor._actor_id.binary(), no_restart))
        return
    cw.run_sync(cw.kill_actor(actor._actor_id.binary(), no_restart), 30)


def _handle_from_named_actor_reply(name: str, reply: dict) -> "Any":
    from ray_tpu_torch._private.ids import ActorID
    from ray_tpu_torch.actor import ActorHandle

    rec = reply["actor"]
    if rec is None or rec["state"] == "DEAD":
        raise ValueError(f"no live actor named {name!r}")
    # carry the class's @method declarations so a get_actor handle behaves
    # like the original (concurrency groups, multi-returns)
    return ActorHandle(
        ActorID(rec["actor_id"]),
        class_key=rec.get("class_key", ""),
        method_meta=rec.get("method_meta") or None,
        max_task_retries=rec.get("max_task_retries", 0),
        concurrent=rec.get("concurrent", False),
    )


def get_actor(name: str, namespace: str = "") -> "Any":
    cw = get_core_worker()
    if cw._loop_running_here():
        raise RuntimeError(
            "get_actor() called on the core event loop would deadlock — "
            "use get_actor_async() from async actor code"
        )
    reply = cw.run_sync(
        cw.control.call("get_named_actor", {"name": name, "namespace": namespace})
    )
    return _handle_from_named_actor_reply(name, reply)


async def get_actor_async(name: str, namespace: str = "") -> "Any":
    """Loop-safe variant of get_actor for code running on the core event loop
    (async actors)."""
    cw = get_core_worker()
    reply = await cw.control.call(
        "get_named_actor", {"name": name, "namespace": namespace}
    )
    return _handle_from_named_actor_reply(name, reply)
