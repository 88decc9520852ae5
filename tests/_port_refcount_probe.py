"""Probe of the port's ReferenceCounter against a finaliser that runs while
the counter is busy. Run as ``python _port_refcount_probe.py <where>``:

* ``gc_in_binary`` — ``add_local`` is given a ref whose ``binary()`` runs
  the cyclic GC, which finalises an ObjectRef held in a cycle;
* ``gc_under_lock`` — the GC runs while the thread holds the counter's lock;
* ``handle_gc_under_lock`` — the GC finalises an owned ActorHandle held in
  a cycle while the thread holds the core worker's lock.

The work runs on a thread joined with a timeout; the script prints
``blocked`` and exits 1 if the thread is still stuck, else waits for the
cycle's ref (or handle) to be released and prints ``ok``. It runs against a stand-in
for the core worker (no cluster), in a process of its own, so a deadlock
ends with the process instead of holding the test session.
"""

import asyncio
import collections
import gc
import os
import sys
import threading
import time

from ray_tpu_torch._private import core_worker as cwm
from ray_tpu_torch._private.ids import ActorID, ObjectID, WorkerID
from ray_tpu_torch.actor import ActorHandle

JOIN_S = 10.0


class StubWorker:
    """The parts of a CoreWorker that the reference counter and an owned
    ActorHandle call; the handle refcount is the CoreWorker's own code."""

    add_actor_handle_ref = cwm.CoreWorker.add_actor_handle_ref
    remove_actor_handle_ref = cwm.CoreWorker.remove_actor_handle_ref
    remove_actor_handle_ref_deferred = (
        cwm.CoreWorker.remove_actor_handle_ref_deferred)
    drain_actor_handle_refs = cwm.CoreWorker.drain_actor_handle_refs
    _kill_on_gc = cwm.CoreWorker._kill_on_gc

    def __init__(self):
        self.worker_id = WorkerID.from_random()
        self.loop = asyncio.new_event_loop()
        threading.Thread(target=self.loop.run_forever, daemon=True).start()
        self.freed = []
        self.killed = []
        self._lock = threading.Lock()
        self._owned_actor_handles = {}
        self._released_handles = collections.deque()
        self.ref_counter = cwm.ReferenceCounter(self)

    def schedule(self, coro):
        asyncio.run_coroutine_threadsafe(coro, self.loop)

    def owns(self, ref):
        return ref._owner_worker_id == self.worker_id.binary()

    async def free_owned_object(self, oid):
        self.freed.append(oid.binary())

    async def notify_owner(self, owner, method, key):
        pass

    async def kill_actor(self, actor_id, no_restart):
        self.killed.append(actor_id)


class GcRef(cwm.ObjectRef):
    """A ref whose ``binary()`` runs the cyclic GC."""

    def binary(self):
        gc.collect()
        return super().binary()


def main(where: str) -> int:
    cw = StubWorker()
    cwm.set_core_worker(cw)
    rc = cw.ref_counter
    owner = cw.worker_id.binary()

    class Node:
        pass

    gc.disable()  # the cycle must survive until the collection under test
    node = Node()
    node.self = node
    node.ref = cwm.ObjectRef(ObjectID.from_random(), "", owner)
    node.handle = ActorHandle(ActorID.from_random(), "", None, _owned=True)
    key = node.ref.binary()
    actor_id = node.handle._actor_id.binary()
    del node
    held = cwm.ObjectRef(ObjectID.from_random(), "", owner)
    probe = GcRef(held.object_id(), "", owner, _register=False)

    def body():
        if where == "gc_in_binary":
            rc.add_local(probe)
        elif where == "gc_under_lock":
            with rc._lock:
                gc.collect()
        else:
            with cw._lock:
                gc.collect()

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(JOIN_S)
    if t.is_alive():
        print("blocked", flush=True)
        os._exit(1)
    gc.enable()
    deadline = time.monotonic() + JOIN_S
    while key not in cw.freed or actor_id not in cw.killed:
        if time.monotonic() > deadline:
            print(f"not released: ref {rc.local_counts.get(key)}, handle "
                  f"{cw._owned_actor_handles.get(actor_id)}", flush=True)
            return 1
        time.sleep(0.01)
    want = 2 if where == "gc_in_binary" else 1
    if rc.local_counts.get(held.binary()) != want:
        print(f"held count {rc.local_counts.get(held.binary())}", flush=True)
        return 1
    print("ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
