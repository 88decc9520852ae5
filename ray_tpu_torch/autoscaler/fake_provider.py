"""FakeNodeProvider: the autoscaler's in-process scale vehicle.

The port's counterpart of ``ray_tpu/autoscaler/fake_provider.py``, on the
port's ``_private/simnode.py``.

Reference: python/ray/autoscaler/_private/fake_multi_node/node_provider.py —
the provider the reference autoscaler's own tests run against. Ours
provisions SimNodes (protocol-faithful daemon speakers, _private/simnode.py)
instead of subprocesses, so a 500-1000-node scale-up storm driven by the
REAL reconciler runs in one process: every launch registers a real
control-store member that heartbeats, subscribes, answers drain notices,
and counts protocol errors.

Deterministic: node ids derive from (seed, index) with indices handed out
sequentially from `index_base`, so a storm replays identically run to run.

All SimNodes live on one owned asyncio loop thread; the provider's
synchronous create/terminate surface bridges into it, which is exactly the
shape a cloud provider has (blocking API calls against remote state).
"""

from __future__ import annotations

import asyncio
import logging
import threading
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.simnode import SimNode
from ray_tpu_torch.autoscaler import NodeProvider

logger = logging.getLogger(__name__)


class FakeNodeProvider(NodeProvider):
    """Registers deterministic SimNodes as autoscaler-launched workers."""

    def __init__(self, control_address: str, *, seed: Optional[int] = None,
                 index_base: int = 50_000, serve: bool = True,
                 heartbeat: bool = True):
        self.control_address = control_address
        self.seed = seed if seed is not None \
            else GLOBAL_CONFIG.get("simnode_seed")
        self._serve = serve
        self._heartbeat = heartbeat
        self._next_index = index_base
        self.nodes: Dict[str, dict] = {}  # node hex -> handle
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, name="fake-provider", daemon=True)
        self._thread.start()

    def _run(self, coro, timeout: float = 60.0):
        return asyncio.run_coroutine_threadsafe(
            coro, self._loop).result(timeout)

    # -- NodeProvider surface -------------------------------------------

    def create_node(self, resources: Dict[str, float]) -> Any:
        idx = self._next_index
        self._next_index += 1
        sim = SimNode(self.control_address, index=idx, seed=self.seed,
                      resources=dict(resources), serve=self._serve,
                      heartbeat=self._heartbeat)
        self._run(sim.start())
        handle = {"sim": sim, "node_id": sim.node_id.hex(),
                  "address": sim.address, "index": idx}
        self.nodes[handle["node_id"]] = handle
        return handle

    def create_nodes(self, resources: Dict[str, float], count: int,
                     concurrency: int = 64) -> List[dict]:
        """Batched launch (the storm path): `count` SimNodes registered
        with bounded concurrency on the provider loop — sequential
        create_node round-trips would serialize a 500-node storm."""
        sims = []
        for _ in range(count):
            idx = self._next_index
            self._next_index += 1
            sims.append(SimNode(
                self.control_address, index=idx, seed=self.seed,
                resources=dict(resources), serve=self._serve,
                heartbeat=self._heartbeat))

        async def up_all():
            sem = asyncio.Semaphore(concurrency)

            async def up(n):
                async with sem:
                    await n.start()

            await asyncio.gather(*(up(n) for n in sims))

        self._run(up_all(), timeout=300.0)
        handles = []
        for sim in sims:
            handle = {"sim": sim, "node_id": sim.node_id.hex(),
                      "address": sim.address, "index": sim.index}
            self.nodes[handle["node_id"]] = handle
            handles.append(handle)
        return handles

    def terminate_node(self, handle: Any) -> None:
        self.nodes.pop(handle["node_id"], None)
        try:
            self._run(handle["sim"].stop(), timeout=30.0)
        except Exception:  # noqa: BLE001 — already dead is fine
            pass

    def node_alive(self, handle: Any) -> bool:
        return handle["sim"].state in ("ALIVE", "DRAINING")

    # -- harness knobs --------------------------------------------------

    def set_pending(self, handle: Any, shapes: List[dict]) -> None:
        """Script unmet lease demand onto one node's heartbeats — the
        reactive-mode signal path (what a real daemon reports when leases
        queue up on it)."""
        handle["sim"].pending_shapes = [dict(s) for s in shapes]

    def protocol_errors(self) -> List[str]:
        return [e for h in self.nodes.values()
                for e in h["sim"].protocol_errors]

    def stats(self) -> dict:
        sims = [h["sim"] for h in self.nodes.values()]
        return {
            "nodes": len(sims),
            "alive": sum(1 for s in sims if s.state == "ALIVE"),
            "beats": sum(s.beats for s in sims),
            "protocol_errors": self.protocol_errors(),
        }

    def shutdown(self) -> None:
        for handle in list(self.nodes.values()):
            self.terminate_node(handle)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=10)


__all__ = ["FakeNodeProvider"]
