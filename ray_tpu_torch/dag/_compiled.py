"""Compiled DAG execution: static schedules + preallocated shm channels.
The port's copy of ``ray_tpu/dag/_compiled.py``.

Reference surface: python/ray/dag/compiled_dag_node.py:813 (CompiledDAG —
static actor schedules, per-actor executors, preallocated channels),
experimental/channel/shared_memory_channel.py (the channel plane),
collective_node.py:23 (_CollectiveOperation in graphs).

Redesign for this framework:
  * compile() resolves the DAG ONCE into per-actor static schedules
    (topologically ordered steps), with one SPSC shm channel per cross-actor
    edge (ray_tpu_torch/experimental/channel.py — native atomics, no RPC).
  * each actor runs an executor LOOP delivered through the `__rt_call__`
    system method: read input channels, run the bound method in-process,
    write output channels. A graph hop costs serialize + memcpy + atomic
    publish — the task scheduler, lease plane, and reply plumbing are out
    of the hot path entirely.
  * same-actor edges pass values in-process (no channel, no copy).
  * channel capacity is the pipeline depth: execute() keeps submitting
    while channels have room, so consecutive executions overlap across
    stage actors (aDAG pipelining); a full entry channel is backpressure.
  * collective nodes (dag/collective.py) compile into reduce+broadcast
    steps over the same channel plane (host values; device tensors take
    torch.distributed inside a step instead).

Cross-node DAGs (reference: channel/torch_tensor_accelerator_channel.py):
each edge's ring lives in the READER's node store (readers create their
own rings at executor-loop start); a writer on the same node opens the
ring directly through the shared shm segment, a writer on another node
ships slots over the worker RPC plane (RemoteChannel → rpc_chan_write on
the reader's core worker), with the ring's futex-doorbell backpressure
carried through the RPC reply. Methods must be synchronous; a compiled
DAG does not survive actor restarts.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

_STOP = "__rt_dag_stop__"
_dag_counter = itertools.count(1)


@dataclass
class _Step:
    idx: int
    method: str = ""
    # each source: ("chan", edge) | ("local", idx) | ("input",) |
    #              ("input_attr", key) | ("const", value)
    arg_sources: List[Tuple] = field(default_factory=list)
    kwarg_sources: Dict[str, Tuple] = field(default_factory=dict)
    out_edges: List[str] = field(default_factory=list)
    # collective steps ("reduce root" / "leaf"):
    kind: str = "method"          # "method" | "coll_root" | "coll_leaf"
    coll_op: str = "sum"
    coll_in_edges: List[str] = field(default_factory=list)   # root: leaf→root
    coll_out_edges: List[str] = field(default_factory=list)  # root: root→leaf
    coll_src: Optional[Tuple] = None   # this actor's own contribution source


@dataclass
class _ActorPlan:
    dag_id: str
    store_name: str
    steps: List[_Step] = field(default_factory=list)
    nslots: int = 8
    slot_size: int = 1 << 20
    # out-edge → reader location {"node": node_id_hex, "address": rpc addr}:
    # same-node edges open the reader's ring in the shared store; cross-node
    # edges write through RemoteChannel → rpc_chan_write
    edge_dests: Dict[str, dict] = field(default_factory=dict)


def _reduce_vals(op: str, vals: List[Any]):
    import numpy as np

    if op == "sum":
        out = vals[0]
        for v in vals[1:]:
            out = out + v
        return out
    if op == "max":
        return np.maximum.reduce(vals)
    if op == "min":
        return np.minimum.reduce(vals)
    raise ValueError(f"unknown collective op {op!r}")


def _open_in_channels(plan: _ActorPlan, edges: List[str]):
    """Create THIS process's read rings (the reader owns its rings) and
    register them so cross-node writers can reach them via rpc_chan_write."""
    from ray_tpu_torch._private.core_worker import get_core_worker
    from ray_tpu_torch.experimental.channel import ShmChannel, channel_object_id

    cw = get_core_worker()
    if cw.store is None:
        raise RuntimeError("compiled DAGs need a node-local shm store")
    chans = {}
    for e in edges:
        chans[e] = ShmChannel(
            cw.store, channel_object_id(plan.dag_id, e), creator=True,
            nslots=plan.nslots, slot_size=plan.slot_size)
        cw.register_dag_channel(plan.dag_id, e, chans[e])
    return chans


def _open_writer(dag_id: str, edge: str, dest: dict, nslots: int,
                 slot_size: int):
    """Writer half of one edge: the reader's local ring when the reader
    shares this node's store, RemoteChannel over the RPC plane otherwise.
    Shared by actor executor loops and the driver's entry writers."""
    from ray_tpu_torch._private.core_worker import get_core_worker
    from ray_tpu_torch.experimental.channel import (RemoteChannel, ShmChannel,
                                              channel_object_id)

    cw = get_core_worker()
    if dest.get("node", cw.node_id_hex) == cw.node_id_hex:
        if cw.store is None:
            raise RuntimeError("compiled DAGs need a node-local shm store")
        return ShmChannel(
            cw.store, channel_object_id(dag_id, edge), creator=False,
            nslots=nslots, slot_size=slot_size)
    return RemoteChannel(dag_id, edge, dest["address"], slot_size=slot_size)


def _open_out_channels(plan: _ActorPlan, edges: List[str]):
    return {
        e: _open_writer(plan.dag_id, e, plan.edge_dests.get(e) or {},
                        plan.nslots, plan.slot_size)
        for e in edges
    }


def _plan_edges(plan: _ActorPlan) -> Tuple[List[str], List[str]]:
    ins, outs = [], []
    for s in plan.steps:
        for src in list(s.arg_sources) + list(s.kwarg_sources.values()):
            if src[0] == "chan":
                ins.append(src[1])
            if src[0] in ("input", "input_attr"):
                ins.append(f"driver->{s.idx}")
        if s.coll_src is not None and s.coll_src[0] == "chan":
            ins.append(s.coll_src[1])
        ins.extend(s.coll_in_edges)
        outs.extend(s.out_edges)
        outs.extend(s.coll_out_edges)
    # dedupe, stable
    return list(dict.fromkeys(ins)), list(dict.fromkeys(outs))


@dataclass
class _DagError:
    """An execution-scoped error flowing through the channel plane: poisons
    one execution's downstream values, not the pipeline."""

    pickled: bytes

    def raise_(self):
        import pickle

        raise pickle.loads(self.pickled)


def _write_val(chan, value):
    """Channel write that degrades an oversized payload into a (small)
    _DagError instead of killing the executor loop."""
    try:
        chan.write(value, timeout=None)
    except ValueError as exc:
        import pickle

        chan.write(_DagError(pickle.dumps(exc)), timeout=None)


def _actor_loop(instance, plan: _ActorPlan):
    """Runs INSIDE the actor via __rt_call__ for the compiled DAG's
    lifetime. Returns per-loop stats at teardown."""
    in_edges, out_edges = _plan_edges(plan)
    # create OWN read rings first (writers block-open them), then open
    # writer halves toward each out-edge's reader. Everything after the
    # in-ring creation runs under the cleanup `finally` — a failed
    # out-open (dead peer, 30s open timeout) must not leak the pinned,
    # registered in-rings for the process lifetime.
    in_chans = _open_in_channels(plan, in_edges)
    out_chans: Dict[str, Any] = {}
    executions = 0
    t_busy = 0.0

    def read(edge):
        return in_chans[edge].read(timeout=None)

    try:
        out_chans.update(_open_out_channels(plan, out_edges))
        while True:
            local_vals: Dict[int, Any] = {}
            chan_cache: Dict[str, Any] = {}
            stop = False

            def fetch(src, step_idx):
                nonlocal stop
                kind = src[0]
                if kind == "const":
                    return src[1]
                if kind == "local":
                    return local_vals[src[1]]
                if kind == "chan":
                    edge = src[1]
                    if edge not in chan_cache:
                        chan_cache[edge] = read(edge)
                    v = chan_cache[edge]
                    if isinstance(v, str) and v == _STOP:
                        stop = True
                    return v
                if kind in ("input", "input_attr"):
                    edge = f"driver->{step_idx}"
                    if edge not in chan_cache:
                        chan_cache[edge] = read(edge)
                    v = chan_cache[edge]
                    if isinstance(v, str) and v == _STOP:
                        stop = True
                        return v
                    if kind == "input_attr":
                        return v[src[1]] if isinstance(v, dict) else getattr(v, src[1])
                    return v
                raise ValueError(f"bad source {src}")

            for step in plan.steps:
                if step.kind == "method":
                    args = [fetch(s, step.idx) for s in step.arg_sources]
                    if stop:
                        break
                    kwargs = {k: fetch(s, step.idx)
                              for k, s in step.kwarg_sources.items()}
                    if stop:
                        break
                    poisoned = next(
                        (a for a in list(args) + list(kwargs.values())
                         if isinstance(a, _DagError)), None)
                    if poisoned is not None:
                        out = poisoned
                    else:
                        t0 = time.perf_counter()
                        try:
                            out = getattr(instance, step.method)(
                                *args, **kwargs)
                        except Exception as exc:  # noqa: BLE001
                            import pickle

                            try:
                                out = _DagError(pickle.dumps(exc))
                            except Exception:  # noqa: BLE001
                                out = _DagError(pickle.dumps(
                                    RuntimeError(repr(exc))))
                        t_busy += time.perf_counter() - t0
                    local_vals[step.idx] = out
                    for e in step.out_edges:
                        _write_val(out_chans[e], out)
                else:
                    own = fetch(step.coll_src, step.idx)
                    if stop:
                        break
                    if step.kind == "coll_root":
                        vals = [own] + [read(e) for e in step.coll_in_edges]
                        # a poisoned contribution poisons THIS execution's
                        # reduced value for everyone, not the pipeline
                        err = next((v for v in vals
                                    if isinstance(v, _DagError)), None)
                        red = err if err is not None else _reduce_vals(
                            step.coll_op, vals)
                        for e in step.coll_out_edges:
                            _write_val(out_chans[e], red)
                    else:  # leaf: send own, receive reduced
                        _write_val(out_chans[step.coll_out_edges[0]], own)
                        red = read(step.coll_in_edges[0])
                    local_vals[step.idx] = red
                    for e in step.out_edges:
                        _write_val(out_chans[e], red)
            if stop:
                # propagate the sentinel downstream so every loop unwinds
                for step in plan.steps:
                    for e in step.out_edges + step.coll_out_edges:
                        try:
                            out_chans[e].write(_STOP, timeout=5)
                        except Exception:  # noqa: BLE001 — already torn down
                            pass
                break
            executions += 1
    finally:
        from ray_tpu_torch._private.core_worker import get_core_worker

        cw = get_core_worker()
        # Teardown order matters (ADVICE r5 #3): close each read ring FIRST
        # so an in-flight rpc_chan_write blocked on a full ring fails fast,
        # then unregister under the per-edge lock (no writer still holds the
        # chan), and only THEN release the pin — never unpin shm a racing
        # writer could still memcpy into.
        for ch in in_chans.values():
            try:
                ch.close()
            except Exception:  # noqa: BLE001 — store already torn down
                pass
        for e, ch in in_chans.items():
            try:
                cw.run_sync(
                    cw.quiesce_dag_channel(plan.dag_id, e), timeout=30)
            except Exception:  # noqa: BLE001 — never leak the registration
                cw.unregister_dag_channel(plan.dag_id, e)
            ch.unpin()
        for ch in out_chans.values():
            ch.unpin()
    return {"executions": executions, "busy_s": round(t_busy, 6)}


# ---------------------------------------------------------------------------
# driver side: compile + execute
# ---------------------------------------------------------------------------


class CompiledDAGRef:
    """Result handle for one compiled execution (reference:
    compiled_dag_node.py CompiledDAGRef). Results must be consumed in
    submission order — the channel plane is ordered."""

    def __init__(self, dag: "CompiledDAG", seq: int):
        self._dag = dag
        self._seq = seq
        self._value = None
        self._done = False

    def get(self, timeout: Optional[float] = 300.0):
        if self._done:
            return self._value
        self._value = self._dag._collect(self._seq, timeout)
        self._done = True
        return self._value


class CompiledDAG:
    """A frozen actor DAG with preallocated shm channels and per-actor
    executor loops (reference: compiled_dag_node.py:813)."""

    def __init__(self, root, max_in_flight: int = 8,
                 slot_size: int = 1 << 20):
        from ray_tpu_torch.dag import (ClassMethodNode, DAGNode, InputAttributeNode,
                                 InputNode, MultiOutputNode)
        from ray_tpu_torch.dag.collective import CollectiveOutputNode

        self.dag_id = f"cdag{next(_dag_counter)}_{id(root) & 0xffffff:x}"
        self._nslots = max_in_flight
        self._slot_size = slot_size
        self._torn_down = False
        self._poisoned: Optional[str] = None
        self._seq_submitted = 0
        self._seq_collected = 0

        targets = root.outputs if isinstance(root, MultiOutputNode) else [root]
        self._multi = isinstance(root, MultiOutputNode)

        # -- topo order ------------------------------------------------
        order: List[Any] = []
        seen: Dict[int, int] = {}

        def visit(n):
            if not isinstance(n, DAGNode) or isinstance(
                    n, (InputNode, InputAttributeNode)):
                return
            if id(n) in seen:
                return
            if isinstance(n, ClassMethodNode):
                for a in list(n.args) + list(n.kwargs.values()):
                    visit(a)
            elif isinstance(n, CollectiveOutputNode):
                for src in n.operation.nodes:
                    visit(src)
                # lower EVERY participant, consumed or not: the root blocks
                # on all leaf contributions, so an unplanned sibling would
                # deadlock the collective at runtime
                for sib in n.operation.outputs:
                    if sib is not n and id(sib) not in seen:
                        seen[id(sib)] = len(order)
                        order.append(sib)
            else:
                raise TypeError(
                    f"compiled DAGs support actor methods and collective "
                    f"nodes, not {type(n).__name__}")
            seen[id(n)] = len(order)
            order.append(n)

        for t in targets:
            visit(t)
        if not order:
            raise ValueError("compiled DAG has no actor-method nodes")

        # -- per-actor plans -------------------------------------------
        from ray_tpu_torch._private.core_worker import get_core_worker

        cw = get_core_worker()
        if cw.store is None:
            raise RuntimeError("compiled DAGs need a node-local shm store")
        store_name = cw.store_name
        self._actors: Dict[str, Any] = {}
        plans: Dict[str, _ActorPlan] = {}
        steps: Dict[int, _Step] = {}
        self._entry_nodes: List[int] = []

        def actor_key(handle):
            key = handle._actor_id.hex()
            self._actors[key] = handle
            if key not in plans:
                plans[key] = _ActorPlan(
                    dag_id=self.dag_id, store_name=store_name,
                    nslots=self._nslots, slot_size=self._slot_size)
            return key

        def node_actor(n):
            if isinstance(n, ClassMethodNode):
                return actor_key(n.handle)
            return actor_key(n.operation.nodes[n.index].handle)

        def source_for(consumer_idx, consumer_actor, value):
            from ray_tpu_torch.dag import DAGNode as _DN

            if isinstance(value, InputNode):
                if consumer_idx not in self._entry_nodes:
                    self._entry_nodes.append(consumer_idx)
                return ("input",)
            if isinstance(value, InputAttributeNode):
                if consumer_idx not in self._entry_nodes:
                    self._entry_nodes.append(consumer_idx)
                return ("input_attr", value.key)
            if isinstance(value, _DN):
                pidx = seen[id(value)]
                pactor = node_actor(value)
                if pactor == consumer_actor:
                    return ("local", pidx)
                edge = f"{pidx}->{consumer_idx}"
                if edge not in steps[pidx].out_edges:
                    # a consumer using the same producer in two argument
                    # positions still reads the channel once per execution
                    steps[pidx].out_edges.append(edge)
                return ("chan", edge)
            return ("const", value)

        coll_lowered: Dict[int, Dict[int, int]] = {}  # op id → index → step idx

        for n in order:
            idx = seen[id(n)]
            akey = node_actor(n)
            if isinstance(n, CollectiveOutputNode):
                op = n.operation
                if id(op) not in coll_lowered:
                    # participants must sit on distinct actors
                    actors = [actor_key(x.handle) for x in op.nodes]
                    if len(set(actors)) != len(actors):
                        raise ValueError(
                            "collective participants must be distinct actors")
                    coll_lowered[id(op)] = {}
                cid = f"c{seen[id(op.outputs[0])]}"
                i = n.index
                st = _Step(idx=idx, kind="coll_root" if i == 0 else "coll_leaf",
                           coll_op=op.op)
                src_node = op.nodes[i]
                st.coll_src = ("local", seen[id(src_node)]) \
                    if node_actor(src_node) == akey else None
                if st.coll_src is None:
                    raise ValueError(
                        "collective input must be a node on the same actor")
                if i == 0:
                    st.coll_in_edges = [
                        f"{cid}:{j}->root" for j in range(1, len(op.nodes))]
                    st.coll_out_edges = [
                        f"{cid}:root->{j}" for j in range(1, len(op.nodes))]
                else:
                    st.coll_out_edges = [f"{cid}:{i}->root"]
                    st.coll_in_edges = [f"{cid}:root->{i}"]
                steps[idx] = st
                plans[akey].steps.append(st)
                coll_lowered[id(op)][i] = idx
                continue
            st = _Step(idx=idx, method=n.method_name)
            st.arg_sources = [source_for(idx, akey, a) for a in n.args]
            st.kwarg_sources = {
                k: source_for(idx, akey, v) for k, v in n.kwargs.items()}
            steps[idx] = st
            plans[akey].steps.append(st)

        # Per-actor execution order = AUTHORING order (stable for plain
        # chains, and how interleaved schedules like 1F1B are expressed —
        # bind ops in the order each actor should run them). Cross-actor
        # ordering still flows from the channel dependencies.
        created = {seen[id(n)]: getattr(n, "_created", seen[id(n)])
                   for n in order}
        for plan in plans.values():
            plan.steps.sort(key=lambda s: created[s.idx])

        # Every actor's loop must be reachable by the STOP sentinel, which
        # only flows through input/chan-sourced fetches. An actor whose
        # steps read nothing (all-const args, e.g. b.tick.bind()) would
        # free-run ahead of execute() and never unwind at teardown —
        # reject it at compile time.
        for akey, plan in plans.items():
            stoppable = any(
                src[0] in ("chan", "input", "input_attr")
                for s in plan.steps
                for src in list(s.arg_sources) + list(s.kwarg_sources.values())
            )
            if not stoppable:
                raise ValueError(
                    f"actor {akey[:8]} has no InputNode- or channel-sourced "
                    f"step: its executor loop could never observe teardown. "
                    f"Bind at least one argument to the DAG input or to "
                    f"another actor's output.")

        # targets stream to the driver
        self._out_edges: List[str] = []
        for t in targets:
            tidx = seen[id(t)]
            edge = f"{tidx}->driver"
            steps[tidx].out_edges.append(edge)
            self._out_edges.append(edge)
        self._entry_edges = [f"driver->{i}" for i in self._entry_nodes]
        if not self._entry_edges:
            raise ValueError(
                "compiled DAG must consume InputNode (every execution is "
                "driven through the entry channels)")

        # -- resolve actor locations (node + worker RPC address) --------
        # Each edge's RING lives with its READER; writers on other nodes
        # reach it through rpc_chan_write. Locations come from the control
        # store's actor table, waiting out in-flight creations. A compiled
        # DAG does not survive actor restarts (reference: aDAG tears down
        # on actor death).
        from ray_tpu_torch._private import protocol as _pb

        locs: Dict[str, dict] = {}
        pending = set(self._actors)
        deadline = time.monotonic() + 120
        while pending:
            for key in list(pending):
                info = cw.run_sync(cw.control.call(
                    "get_actor_info",
                    {"actor_id": self._actors[key]._actor_id.binary()},
                    timeout=10), timeout=20)
                rec = info.get("actor")
                if rec is None:
                    raise ValueError(f"unknown actor {key[:8]} in DAG")
                if rec.get("state") == _pb.ACTOR_DEAD:
                    raise RuntimeError(
                        f"actor {key[:8]} died before compile: "
                        f"{rec.get('death_cause')}")
                if rec.get("state") == _pb.ACTOR_ALIVE \
                        and rec.get("worker_address"):
                    locs[key] = {"node": rec["node_id"].hex(),
                                 "address": rec["worker_address"]}
                    pending.discard(key)
            if pending:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{len(pending)} DAG actors not alive within 120s")
                time.sleep(0.05)

        driver_loc = {"node": cw.node_id_hex, "address": cw.address}
        edge_reader: Dict[str, dict] = {e: driver_loc
                                        for e in self._out_edges}
        for key, plan in plans.items():
            ins, _ = _plan_edges(plan)
            for e in ins:
                edge_reader[e] = locs[key]
        for key, plan in plans.items():
            _, outs = _plan_edges(plan)
            plan.edge_dests = {e: edge_reader[e] for e in outs}

        # -- driver's own read rings (results stream here) --------------
        from ray_tpu_torch.experimental.channel import ShmChannel, channel_object_id

        self._channels: Dict[str, ShmChannel] = {}
        for e in self._out_edges:
            ch = ShmChannel(
                cw.store, channel_object_id(self.dag_id, e), creator=True,
                nslots=self._nslots, slot_size=self._slot_size)
            cw.register_dag_channel(self.dag_id, e, ch)
            self._channels[e] = ch
        # entry writers open LAZILY: the consumer actor creates its ring
        # when its executor loop starts, and the local open block-waits
        self._entry_dest = {e: edge_reader[e] for e in self._entry_edges}
        self._entry_writers: Dict[str, Any] = {}

        # -- launch the per-actor executor loops ------------------------
        self._loop_refs = [
            self._actors[key].__rt_call__.remote(_actor_loop, plan)
            for key, plan in plans.items()
        ]

    def _entry_writer(self, e: str):
        w = self._entry_writers.get(e)
        if w is None:
            w = _open_writer(self.dag_id, e, self._entry_dest[e],
                             self._nslots, self._slot_size)
            self._entry_writers[e] = w
        return w

    # -- runtime --------------------------------------------------------

    def execute(self, *args, **kwargs) -> CompiledDAGRef:
        if self._torn_down:
            raise RuntimeError("CompiledDAG is torn down")
        if self._poisoned:
            raise RuntimeError(
                f"compiled DAG {self.dag_id} is desynchronized "
                f"({self._poisoned}); call teardown()")
        if self._seq_submitted - self._seq_collected >= self._nslots:
            # every edge ring holds nslots items; admitting more in-flight
            # executions than that could block this writer forever while
            # the driver is the one who must drain the output channels
            # (reference: CompiledDAG max_buffered_results raises the same
            # way rather than deadlocking)
            raise RuntimeError(
                f"{self._nslots} executions already in flight; call get() "
                f"on earlier results first (pipeline depth = max_in_flight)")
        if kwargs:
            if args:
                raise ValueError("pass the input positionally OR by keyword")
            value = dict(kwargs)
        else:
            value = args[0] if args else None
        from ray_tpu_torch._private import serialization as ser

        # serialize ONCE; entry channels share the byte payload
        payload = ser.serialize(value).to_bytes()
        for i, e in enumerate(self._entry_edges):
            try:
                # a full entry channel IS the pipeline backpressure
                self._entry_writer(e).write_bytes(payload, timeout=300)
            except Exception as exc:  # noqa: BLE001
                if i == 0:
                    raise  # nothing fed yet — the DAG is still consistent
                # Entries 0..i-1 already hold this execution's payload; the
                # stages they feed will run it while the rest never see it.
                # Every later execute() would return outputs shifted by one
                # on the fed edges — poison the DAG so subsequent calls
                # fail loudly instead of returning wrong results. teardown()
                # still works (STOP rides the same entry channels).
                self._poisoned = (
                    f"entry write to {e!r} failed after {i} entry "
                    f"channel(s) were already fed")
                raise RuntimeError(
                    f"compiled DAG {self.dag_id}: {self._poisoned}; the "
                    f"pipeline is desynchronized — call teardown()") from exc
        self._seq_submitted += 1
        return CompiledDAGRef(self, self._seq_submitted)

    def _collect(self, seq: int, timeout: Optional[float]):
        if seq != self._seq_collected + 1:
            raise RuntimeError(
                f"compiled DAG results must be consumed in submission order "
                f"(next is #{self._seq_collected + 1}, asked for #{seq})")
        # drain EVERY output edge before raising: a partial read would
        # shift all later executions' values on the non-drained edges
        outs = []
        first_err: Optional[_DagError] = None
        for e in self._out_edges:
            v = self._channels[e].read(timeout=timeout)
            if isinstance(v, _DagError) and first_err is None:
                first_err = v
            outs.append(v)
        self._seq_collected = seq
        if first_err is not None:
            first_err.raise_()
        return outs if self._multi else outs[0]

    def teardown(self) -> List[dict]:
        """Stop the executor loops; returns per-actor loop stats."""
        if self._torn_down:
            return []
        self._torn_down = True
        import logging

        import ray_tpu_torch

        for e in self._entry_edges:
            try:
                self._entry_writer(e).write(_STOP, timeout=30)
            except Exception:  # noqa: BLE001 — loop may already be dead
                pass
        stats: List[dict] = []
        try:
            stats = ray_tpu_torch.get(self._loop_refs, timeout=60)
        except Exception as exc:  # noqa: BLE001 — never leak pinned channels
            logging.getLogger(__name__).warning(
                "compiled DAG %s: executor loops did not stop cleanly (%s); "
                "kill the stage actors to reclaim them", self.dag_id, exc)
        finally:
            from ray_tpu_torch._private.core_worker import get_core_worker

            cw = get_core_worker()
            # same close → quiesce-unregister → unpin order as the executor
            # loops (see _actor_loop): an in-flight rpc_chan_write must fail
            # fast and drain before the ring's pin drops
            for ch in self._channels.values():
                try:
                    ch.close()
                except Exception:  # noqa: BLE001 — store already torn down
                    pass
            for e, ch in self._channels.items():
                try:
                    cw.run_sync(
                        cw.quiesce_dag_channel(self.dag_id, e), timeout=30)
                except Exception:  # noqa: BLE001 — never leak the registration
                    cw.unregister_dag_channel(self.dag_id, e)
                ch.unpin()
            for ch in self._entry_writers.values():
                ch.unpin()
        return stats
