"""NCCL / gloo collective group — the port's counterpart of the JAX
package's ``ray_tpu/util/collective/xla_group.py`` (``XlaCollectiveGroup``).

Capability parity with the reference's NCCL and GLOO collective groups
(reference: python/ray/util/collective/collective_group/
nccl_collective_group.py, gloo_collective_group.py):

- Bootstrap: rank 0 opens a ``torch.distributed.TCPStore`` on a free port
  and publishes ``host:port`` under ``{group}:coordinator`` in the control
  store's ``collective`` KV namespace (``RT_COLLECTIVE_COORD`` overrides
  it, as in the JAX package). Each group builds its OWN process group on
  a ``PrefixStore(group_name, store)``: ``ProcessGroupNCCL`` on the rank's
  current CUDA device, or ``ProcessGroupGloo``. It never calls
  ``init_process_group``, so the default group a ``TorchTrainer`` worker
  joins (``setup_torch_distributed``) is neither created nor destroyed
  here, and two groups live side by side. The ops call the process
  group's own methods; ``torch.distributed``'s functions (and
  ``parallel/mesh.py::stage``, which asks ``dist.get_backend``) know only
  registered groups, so this module stages by its own ``backend``.
- Results as the JAX package returns them: the input is never written
  (torch's collectives work in place, so each op copies first); a tensor
  in gives a tensor out on the same device, numpy in gives numpy out; at
  world 1 every op returns what the JAX package's does.
- Host data (numpy, CPU tensors) on a group whose ranks share one node
  takes the shared-memory path (``_shm_allreduce``, ``_shm_reducescatter``
  over ``experimental/channel.py::ShmChannel`` rings), combining the
  ranks' values in a fixed order so every rank's result is bitwise the
  same, and the JAX package's. A CUDA tensor stays on the device under
  NCCL and is staged through host memory under gloo.
- P2P send/recv ride the framework's RPC host plane out-of-band, as in
  the JAX package; ``permute`` is the group-wide device-plane exchange.

One card cannot run NCCL across ranks (NCCL refuses two ranks on one
GPU), so a multi-rank NCCL group needs a card a rank (ROADMAP M7's
multi-card half).
"""

from __future__ import annotations

import asyncio
import datetime
import hashlib
import os
import sys
import time
import warnings
from typing import Optional

import numpy as np

from ray_tpu_torch.util.collective.types import Backend, GroupInfo, ReduceOp

TIMEOUT_S = 300.0  # a collective (and the store) waits this long for peers

_NP_OPS = {ReduceOp.SUM: np.add, ReduceOp.PRODUCT: np.multiply,
           ReduceOp.MAX: np.maximum, ReduceOp.MIN: np.minimum}


def _torch_op(op: str):
    import torch

    return {ReduceOp.SUM: torch.add, ReduceOp.PRODUCT: torch.mul,
            ReduceOp.MAX: torch.maximum, ReduceOp.MIN: torch.minimum}[op]


def _combine(vals, op: str, tensor: bool):
    """``vals`` reduced left to right: ((v0 op v1) op v2) ..., the first
    step allocating the result."""
    f = _torch_op(op) if tensor else _NP_OPS[op]
    out = f(vals[0], vals[1])
    for v in vals[2:]:
        f(out, v, out=out)
    return out


def _host_bytes(x, tensor: bool) -> np.ndarray:
    """The bytes of ``x`` (contiguous, in host memory) as a uint8 array;
    a tensor's through a uint8 view, so bf16 goes too."""
    if tensor:
        import torch

        return x.detach().contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def _from_bytes(view, like, tensor: bool, shape):
    """A view of ``like``'s dtype and ``shape`` over the buffer ``view``."""
    if tensor:
        import torch

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # read-only: only read from
            flat = torch.frombuffer(view, dtype=torch.uint8)
        return flat.view(like.dtype).reshape(shape)
    return np.frombuffer(view, dtype=like.dtype).reshape(shape)


class NcclCollectiveGroup:
    def __init__(self, world_size: int, rank: int, group_name: str,
                 backend: str = Backend.NCCL):
        import torch

        self.world_size = world_size
        self.rank = rank
        self.group_name = group_name
        self.backend = Backend.validate(backend)
        if self.backend == Backend.NCCL:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "backend='nccl' needs CUDA but torch.cuda.is_available() "
                    "is False; use backend='gloo' for host memory")
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = torch.device("cpu")
        self._p2p_queues: dict = {}
        # shm fast path state (same-node host collectives; see _shm_allreduce)
        self._shm_chans: Optional[dict] = None
        self._shm_chan_size = 0
        self._shm_gen = 0
        self._same_node: Optional[bool] = None
        self._store = self._rendezvous()
        self.pg = self._process_group()
        self._register_p2p()

    # ------------------------------------------------------------------
    # bootstrap
    # ------------------------------------------------------------------

    def _kv(self):
        """KV access through the process's core worker (None outside a cluster)."""
        try:
            from ray_tpu_torch._private.core_worker import get_core_worker

            return get_core_worker()
        except Exception:  # noqa: BLE001
            return None

    def _kv_call(self, method: str, key: str, **extra):
        cw = self._kv()
        if cw is None:
            raise RuntimeError(
                "collective rendezvous needs a ray_tpu_torch cluster (or set "
                "RT_COLLECTIVE_COORD)"
            )
        return cw.run_sync(cw.control.call(
            method, {"ns": "collective", "key": key.encode(), **extra}))

    def _kv_put(self, key: str, value: bytes):
        self._kv_call("kv_put", key, value=value)

    def _kv_get(self, key: str, timeout: float = 60.0) -> bytes:
        deadline = time.monotonic() + timeout
        while True:
            reply = self._kv_call("kv_get", key)
            if reply["value"] is not None:
                return reply["value"]
            if time.monotonic() > deadline:
                raise TimeoutError(f"rendezvous key {key} never appeared")
            time.sleep(0.05)

    def _host(self) -> str:
        """The address peers reach this process at: its core worker's RPC
        host inside a cluster, loopback outside one."""
        cw = self._kv()
        if cw is None:
            return "127.0.0.1"
        return cw.address.rsplit(":", 1)[0]

    def _rendezvous(self):
        """The group's TCPStore: rank 0 serves it, the others connect."""
        from torch.distributed import TCPStore

        timeout = datetime.timedelta(seconds=TIMEOUT_S)
        env = os.environ.get("RT_COLLECTIVE_COORD")
        if env:
            host, port = env.rsplit(":", 1)
            return TCPStore(host, int(port), self.world_size, self.rank == 0,
                            timeout=timeout, wait_for_workers=False)
        key = f"{self.group_name}:coordinator"
        if self.rank == 0:
            host = self._host()
            store = TCPStore(host, 0, self.world_size, True, timeout=timeout,
                             wait_for_workers=False)
            if self.world_size > 1:
                self._kv_put(key, f"{host}:{store.port}".encode())
            return store
        host, port = self._kv_get(key, timeout=TIMEOUT_S).decode().rsplit(":", 1)
        return TCPStore(host, int(port), self.world_size, False,
                        timeout=timeout)

    def _process_group(self):
        import torch.distributed as dist

        prefix = dist.PrefixStore(self.group_name, self._store)
        timeout = datetime.timedelta(seconds=TIMEOUT_S)
        if self.backend == Backend.GLOO:
            return dist.ProcessGroupGloo(prefix, self.rank, self.world_size,
                                         timeout)
        nccl = getattr(dist, "ProcessGroupNCCL", None)
        if nccl is None or not dist.is_nccl_available():
            raise RuntimeError("this torch build has no NCCL")
        opts = nccl.Options()
        opts._timeout = timeout
        return nccl(prefix, self.rank, self.world_size, opts)

    def _register_p2p(self):
        """Register this member's RPC address for out-of-band send/recv:
        the handler first, then the address a sender looks up (published
        before the handler, a send can arrive at a member that cannot take
        it yet; the JAX package's order)."""
        cw = self._kv()
        if cw is None:
            return
        cw.server.register(
            f"collective_p2p:{self.group_name}", self._handle_p2p
        )
        self._kv_put(f"{self.group_name}:member:{self.rank}", cw.address.encode())
        self._kv_put(f"{self.group_name}:node:{self.rank}",
                     cw.node_id_hex.encode())

    # ------------------------------------------------------------------
    # shm fast path: same-node host collectives through the node's object
    # store (zero-copy reads) instead of gloo's localhost TCP — the host-
    # plane analogue of the reference's shared-memory Gloo transport. CUDA
    # tensors keep the backend's collectives.
    # ------------------------------------------------------------------

    def _all_same_node(self) -> bool:
        if self._same_node is None:
            cw = self._kv()
            if cw is None or cw.store is None or self.world_size == 1:
                self._same_node = False
            else:
                try:
                    nodes = {
                        self._kv_get(f"{self.group_name}:node:{r}",
                                     timeout=30)
                        for r in range(self.world_size)
                    }
                    self._same_node = len(nodes) == 1
                except Exception:  # noqa: BLE001 — fall back to the backend
                    self._same_node = False
        return self._same_node

    def _shm_chan_oid(self, src: int, dst: int, gen: int):
        from ray_tpu_torch._private.ids import ObjectID

        digest = hashlib.sha256(
            f"colchan:{self.group_name}:{src}->{dst}:{gen}".encode()
        ).digest()
        return ObjectID(digest[:24])

    def _unpin_chans(self):
        for ch in list(self._shm_chans["in"].values()) + list(
                self._shm_chans["out"].values()):
            try:
                ch.unpin()
            except Exception:  # noqa: BLE001
                pass
        self._shm_chans = None

    def _shm_chan_pairs(self, nbytes: int):
        """Lazily build (and resize in lockstep) the per-peer SPSC channel
        pairs. Fixed ring slots mean payload pages fault ONCE and stay hot
        — per-call store objects re-fault every 4KB page every round
        (shmem THP is usually off), which caps bandwidth well below
        memcpy."""
        from ray_tpu_torch._private.core_worker import get_core_worker
        from ray_tpu_torch.experimental.channel import ShmChannel

        size = max(1 << 16, 1 << (max(nbytes, 1) - 1).bit_length())
        if self._shm_chans is not None and self._shm_chan_size >= size:
            return self._shm_chans
        store = get_core_worker().store
        if self._shm_chans is not None:
            self._unpin_chans()
        self._shm_gen += 1
        self._shm_chan_size = size
        gen = self._shm_gen
        peers = [r for r in range(self.world_size) if r != self.rank]
        # reader creates its inbound rings; writers block-open them (the
        # same ownership rule as the compiled-DAG channel plane)
        inbound = {
            r: ShmChannel(store, self._shm_chan_oid(r, self.rank, gen),
                          creator=True, nslots=2, slot_size=size)
            for r in peers
        }
        outbound = {
            r: ShmChannel(store, self._shm_chan_oid(self.rank, r, gen),
                          creator=False, nslots=2, slot_size=size)
            for r in peers
        }
        for ch in inbound.values():
            ch.prefault(write=False)
        for ch in outbound.values():
            ch.prefault(write=True)
        self._shm_chans = {"in": inbound, "out": outbound}
        return self._shm_chans

    def _shm_exchange(self, outgoing: dict, nbytes: int):
        """Write ``outgoing[peer]`` (uint8 arrays of ``nbytes``) into each
        peer's ring, then take one view of each peer's contribution to this
        rank: ({peer: view}, release). One slot memcpy out, zero-copy reads
        in — no serialization, no RPC, no per-call allocation."""
        chans = self._shm_chan_pairs(nbytes)
        for r, ch in chans["out"].items():
            slot = ch.reserve_view(nbytes, timeout=120)
            np.copyto(np.frombuffer(slot, dtype=np.uint8), outgoing[r])
            slot.release()
            ch.commit(nbytes)
        # one slot view is held per inbound channel (distinct rings), so
        # all contributions can be viewed at once
        held = {r: ch.read_view(timeout=120) for r, ch in chans["in"].items()}

        def release():
            for r, pview in held.items():
                pview.release()
                chans["in"][r].consume()

        return held, release

    def _shm_allreduce(self, x, op: str, tensor: bool):
        """Same-node host allreduce. Combine in FIXED global rank order:
        float reduction is not associative, and every rank must return
        bit-identical results or lockstep replicas silently drift."""
        raw = _host_bytes(x, tensor)
        held, release = self._shm_exchange(
            {r: raw for r in range(self.world_size) if r != self.rank},
            raw.nbytes)
        mine = x.detach() if tensor else x
        try:
            return _combine(
                [mine if r == self.rank
                 else _from_bytes(held[r], x, tensor, tuple(x.shape))
                 for r in range(self.world_size)], op, tensor)
        finally:
            release()

    def _shm_reducescatter(self, x, op: str, tensor: bool):
        """Same-node host reduce-scatter: row j of each rank's (world,
        chunk...) input goes to rank j alone, which combines its chunk in
        the order of a ring reduce-scatter (the contribution of rank j + 1
        first, its own last; XLA's CPU collectives reduce in this order,
        so the result is bitwise the JAX package's). The full reduced
        tensor exists on no rank."""
        rows = {j: _host_bytes(x[j], tensor)
                for j in range(self.world_size) if j != self.rank}
        chunk = tuple(x.shape[1:])
        held, release = self._shm_exchange(rows, _host_bytes(
            x[self.rank], tensor).nbytes)
        mine = x[self.rank].detach() if tensor else x[self.rank]
        order = [(self.rank + 1 + i) % self.world_size
                 for i in range(self.world_size)]
        try:
            return _combine(
                [mine if r == self.rank
                 else _from_bytes(held[r], x, tensor, chunk)
                 for r in order], op, tensor)
        finally:
            release()

    async def _handle_p2p(self, conn_id, payload):
        q = self._p2p_queues.setdefault(payload["src"], asyncio.Queue())
        await q.put((payload["data"], payload["shape"], payload["dtype"],
                     payload.get("torch", False)))
        return {"ok": True}

    # ------------------------------------------------------------------
    # collectives on the process group
    # ------------------------------------------------------------------

    def _resolve_input(self, x):
        """Accept numpy, a torch tensor, or an ObjectRef of either (rdt: a
        same-process ref resolves to the original tensor, no copy).
        Returns (value, is_tensor)."""
        from ray_tpu_torch._private.core_worker import ObjectRef

        if isinstance(x, ObjectRef):
            import ray_tpu_torch

            x = ray_tpu_torch.get(x)
        torch = sys.modules.get("torch")
        return x, torch is not None and isinstance(x, torch.Tensor)

    def _on_host(self, x, tensor: bool) -> bool:
        return not tensor or x.device.type == "cpu"

    def _wire(self, x, tensor: bool):
        """A contiguous copy of ``x`` where the backend takes it: the
        group's CUDA device under NCCL, host memory under gloo. The
        collectives write it, never the caller's input."""
        import torch

        t = x.detach() if tensor else torch.from_numpy(np.array(x))
        if t.device != self.device:
            return t.to(self.device).contiguous()
        return t.contiguous().clone()

    def _back(self, w, x, tensor: bool):
        """The result ``w`` as the caller gave ``x``: a tensor on ``x``'s
        device, or numpy."""
        if tensor:
            return w if w.device == x.device else w.to(x.device)
        return w.cpu().numpy()

    def _reduce_opts(self, kind, op: str):
        import torch.distributed as dist

        opts = kind()
        opts.reduceOp = {ReduceOp.SUM: dist.ReduceOp.SUM,
                         ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
                         ReduceOp.MAX: dist.ReduceOp.MAX,
                         ReduceOp.MIN: dist.ReduceOp.MIN}[op]
        return opts

    def _backend_allreduce(self, w, op: str = ReduceOp.SUM):
        """One all-reduce of the tensor ``w`` (in place) through the
        process group, whatever the world size."""
        import torch.distributed as dist

        self.pg.allreduce([w], self._reduce_opts(dist.AllreduceOptions,
                                                 op)).wait()
        return w

    def allreduce(self, x, op: str = ReduceOp.SUM):
        x, ten = self._resolve_input(x)
        if self.world_size == 1:
            return x if ten else np.asarray(x)
        if self._on_host(x, ten) and self._all_same_node():
            # Host-memory payload on a co-located group: zero-copy through
            # the node's shm store beats gloo's loopback TCP several-fold.
            # Mixed host/device inputs across ranks are not allowed (the
            # paths would deadlock) — the collective contract already
            # requires symmetric calls.
            return self._shm_allreduce(x if ten else np.asarray(x), op, ten)
        w = self._wire(x, ten)
        return self._back(self._backend_allreduce(w, op), x, ten)

    def reduce(self, x, dst_rank: int = 0, op: str = ReduceOp.SUM):
        # resolve ONCE (an ObjectRef would otherwise be fetched twice on
        # non-dst ranks: inside allreduce and again for the passthrough)
        x, ten = self._resolve_input(x)
        out = self.allreduce(x, op)
        if self.rank == dst_rank:
            return out
        return x if ten else np.asarray(x)

    def broadcast(self, x, src_rank: int = 0):
        import torch.distributed as dist

        x, ten = self._resolve_input(x)
        if self.world_size == 1:
            return x if ten else np.asarray(x)
        w = self._wire(x, ten)
        opts = dist.BroadcastOptions()
        opts.rootRank = src_rank
        opts.rootTensor = 0
        self.pg.broadcast([w], opts).wait()
        return self._back(w, x, ten)

    def allgather(self, x):
        import torch

        x, ten = self._resolve_input(x)
        if self.world_size == 1:
            return x[None] if ten else np.asarray(x)[None]
        w = self._wire(x, ten)
        out = torch.empty((self.world_size, *w.shape), dtype=w.dtype,
                          device=w.device)
        self.pg.allgather([list(out.unbind(0))], [w]).wait()
        return self._back(out, x, ten)

    def reducescatter(self, x, op: str = ReduceOp.SUM):
        """x: local (world, chunk...) contribution → this rank's reduced
        chunk, through a reduce-scatter (the shared-memory one for host
        data on one node, the backend's otherwise): the full reduced
        tensor is never materialized on any rank."""
        import torch
        import torch.distributed as dist

        x, ten = self._resolve_input(x)
        if not ten:
            x = np.asarray(x)  # lists/tuples were accepted before; keep it
        if x.shape[0] != self.world_size:
            raise ValueError(
                f"reducescatter input leading dim must be world_size "
                f"{self.world_size}, got {tuple(x.shape)}"
            )
        if self.world_size == 1:
            return x[0]
        if self._on_host(x, ten) and self._all_same_node():
            return self._shm_reducescatter(x, op, ten)
        w = self._wire(x, ten)
        out = torch.empty(w.shape[1:], dtype=w.dtype, device=w.device)
        self.pg.reduce_scatter(
            [out], [list(w.unbind(0))],
            self._reduce_opts(dist.ReduceScatterOptions, op)).wait()
        return self._back(out, x, ten)

    def barrier(self):
        self.allreduce(np.ones((1,), np.int32))

    def permute(self, x, perm):
        """Device-plane point-to-point: out = contribution of `src` on rank
        `dst` for every (src, dst) in `perm`, zeros elsewhere. A COLLECTIVE
        call (all ranks participate): every rank walks `perm` in order and
        takes part in the pairs it is an endpoint of, a blocking send or
        receive each, so the pairs complete one after another and no cycle
        of them can deadlock."""
        import torch

        x, ten = self._resolve_input(x)
        if self.world_size == 1:
            return x if ten else np.asarray(x)
        seen_dst = set()
        for s, d in perm:
            if not (0 <= s < self.world_size and 0 <= d < self.world_size):
                raise ValueError(
                    f"permute pair ({s}, {d}) out of range for world size "
                    f"{self.world_size}")
            if d in seen_dst:
                raise ValueError(f"permute destination {d} appears twice")
            seen_dst.add(d)
        w = self._wire(x, ten)
        out = torch.zeros_like(w)
        for tag, (s, d) in enumerate(perm):
            if s == d:
                if self.rank == s:
                    out.copy_(w)
            elif self.rank == s:
                self.pg.send([w], d, tag).wait()
            elif self.rank == d:
                self.pg.recv([out], s, tag).wait()
        return self._back(out, x, ten)

    # ------------------------------------------------------------------
    # p2p over the RPC host plane
    # ------------------------------------------------------------------

    def send(self, x, dst_rank: int):
        cw = self._kv()
        addr = self._kv_get(f"{self.group_name}:member:{dst_rank}").decode()
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(x, torch.Tensor):
            data = _host_bytes(x.cpu(), True).tobytes()
            shape, dtype, is_tensor = list(x.shape), str(x.dtype), True
        else:
            x = np.ascontiguousarray(x)
            data = x.tobytes()
            shape, dtype, is_tensor = list(x.shape), str(x.dtype), False

        async def _send():
            client = await cw._owner_client(addr)
            await client.call(f"collective_p2p:{self.group_name}", {
                "src": self.rank,
                "data": data,
                "shape": shape,
                "dtype": dtype,
                "torch": is_tensor,
            })

        cw.run_sync(_send())

    def recv(self, src_rank: int, timeout: float = 60.0):
        """The next value ``src_rank`` sent: numpy as numpy (a read-only
        view of the received bytes, as in the JAX package), a tensor as a
        CPU tensor of its own dtype (numpy has no bf16)."""
        cw = self._kv()

        async def _recv():
            q = self._p2p_queues.setdefault(src_rank, asyncio.Queue())
            return await asyncio.wait_for(q.get(), timeout)

        data, shape, dtype, is_tensor = cw.run_sync(_recv(), timeout + 5)
        if not is_tensor:
            return np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape)
        import torch

        tdtype = getattr(torch, dtype.split(".", 1)[1])
        if not data:
            return torch.empty(shape, dtype=tdtype)
        flat = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        return flat.view(tdtype).reshape(shape)

    def destroy(self):
        # unpin shm-path channel rings (the reader-created inbound rings
        # become evictable once the writer side unpins too)
        if self._shm_chans is not None:
            self._unpin_chans()
        # only this group's process group and store: the default group
        # (and every other group) lives on
        pg, self.pg = self.pg, None
        if pg is not None:
            try:
                pg.shutdown()
            except Exception:  # noqa: BLE001 — older builds lack shutdown
                pass
        self._store = None
        if self.rank == 0 and self.world_size > 1 and self._kv() is not None \
                and not os.environ.get("RT_COLLECTIVE_COORD"):
            try:  # a later group of this name publishes its own store
                self._kv_call("kv_del", f"{self.group_name}:coordinator")
            except Exception:  # noqa: BLE001
                pass

    def info(self) -> GroupInfo:
        return GroupInfo(self.group_name, self.world_size, self.rank,
                         self.backend)
