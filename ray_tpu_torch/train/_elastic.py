"""Elastic training: live gang resize instead of checkpoint-restore.

The drain/preemption plane makes planned node death a protocol; this module
makes the train stack *ride* it. When a node drains with survivors still
holding >= ElasticScalingPolicy.min_workers, the controller does not tear
the gang down: surviving workers pause at a step boundary, the dead ranks'
state shards are re-distributed across the survivors through the object
plane (a shard that keeps its holder never moves at all; lost/overflow
shards travel host-staged: a CUDA tensor is copied to host memory by the
put and rebuilt on the reader's device by the get, while a reader in the
producing process gets the tensor itself through rdt, as JAX's
jax.Arrays stay on the device), ranks and world_size are renumbered under a fresh
generation id, and training resumes. When capacity returns (node-table
"nodes" pubsub), the symmetric regrow spawns joiners that absorb shed
shards and a slice of the data-iterator assignment.

Three pieces live here:

- the pure re-shard planner (`plan_shards` / `plan_iterator` over the
  shared `rebalance` core): deterministic, retention-first assignment —
  every holder keeps what it already has up to a balanced quota, so the
  bytes that move are exactly the orphaned (dead-rank) shards plus the
  minimum overflow;
- `ElasticDataIterator`: per-rank epoch/batch/shard-assignment state with
  an explicit contract — across any shrink/regrow sequence, no sample is
  dropped or consumed twice within an epoch (remaining-sets are disjoint
  by construction and resize re-partitions exactly their union);
- `ElasticClient`: the worker-side half of the resize protocol
  (prepare -> park+publish -> commit/absorb -> resume | retire), driven by
  the controller through TrainWorker actor methods.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple


class ResizePlanError(RuntimeError):
    """The parked payloads cannot be re-planned live (e.g. ranks parked in
    different epochs); the controller falls back to checkpoint-restore."""


# ---------------------------------------------------------------------------
# pure planning
# ---------------------------------------------------------------------------


def rebalance(
    items_by_holder: Dict[int, List[Any]],
    rank_map: Dict[int, int],
    new_world: int,
) -> Dict[int, List[Tuple[Any, int]]]:
    """Retention-first balanced re-assignment of items across a new world.

    `items_by_holder` maps OLD rank -> items it holds; `rank_map` maps the
    surviving old ranks to their new ranks (dead/doomed old ranks are
    absent). Every new rank receives a balanced quota (total/new_world,
    +-1); a surviving holder keeps its own items up to its quota, so the
    only items that change hands are the orphans (held by non-surviving
    ranks) and the overflow above quota. Deterministic: items spill and
    fill in sorted order, ranks fill lowest-first.

    Returns new rank -> [(item, source_old_rank)].
    """
    if new_world <= 0:
        raise ResizePlanError("new world size must be positive")
    total = sum(len(v) for v in items_by_holder.values())
    quota = [total // new_world + (1 if i < total % new_world else 0)
             for i in range(new_world)]
    assigned: Dict[int, List[Tuple[Any, int]]] = {i: [] for i in range(new_world)}
    spill: List[Tuple[Any, int]] = []
    # pass 1: survivors keep their own, up to quota
    for old in sorted(items_by_holder):
        items = sorted(items_by_holder[old], key=_sort_key)
        new = rank_map.get(old)
        if new is None or new >= new_world:
            spill.extend((it, old) for it in items)  # orphaned
            continue
        keep = quota[new] - len(assigned[new])
        assigned[new].extend((it, old) for it in items[:keep])
        spill.extend((it, old) for it in items[keep:])  # overflow
    # pass 2: orphans + overflow fill the remaining quota, lowest rank first
    spill.sort(key=lambda p: _sort_key(p[0]))
    for nr in range(new_world):
        need = quota[nr] - len(assigned[nr])
        if need > 0:
            assigned[nr].extend(spill[:need])
            del spill[:need]
    if spill:  # can't happen: quotas sum to total
        raise ResizePlanError(f"rebalance left {len(spill)} unassigned items")
    return assigned


def _sort_key(item):
    if isinstance(item, (int, float)):
        return (0, item, "")
    return (1, 0, str(item))


def plan_shards(
    manifests: Dict[int, List[Any]],
    rank_map: Dict[int, int],
    new_world: int,
) -> Dict[int, List[Tuple[Any, int]]]:
    """Assign the union of all published state shards to the new world.

    `manifests` maps old rank -> the shard keys it holds (each key must be
    held by exactly one rank). Output maps new rank -> [(key, source old
    rank)]; a pair whose source maps to the same new rank is local — the
    worker already holds the shard and nothing moves."""
    seen: Dict[Any, int] = {}
    for old, keys in manifests.items():
        for k in keys:
            if k in seen:
                raise ResizePlanError(
                    f"shard key {k!r} held by both rank {seen[k]} and "
                    f"rank {old}")
            seen[k] = old
    return rebalance(manifests, rank_map, new_world)


def plan_iterator(
    states: Dict[int, Optional[dict]],
    rank_map: Dict[int, int],
    new_world: int,
) -> Dict[int, dict]:
    """Re-partition the pooled *remaining* samples of every parked rank's
    iterator across the new world. The per-epoch contract holds because
    the remaining sets are disjoint and their union is preserved exactly.

    All parked ranks must agree on (epoch, seed, num_samples, batch_size);
    a mismatch (a resize landing exactly on an epoch boundary) raises
    ResizePlanError and the controller falls back to checkpoint-restore
    rather than guessing at cross-epoch semantics."""
    live = {r: s for r, s in states.items() if s is not None}
    if not live:
        return {}
    base = next(iter(live.values()))
    for r, s in live.items():
        for key in ("epoch", "seed", "num_samples", "batch_size"):
            if s.get(key) != base.get(key):
                raise ResizePlanError(
                    f"iterator {key} mismatch at resize: rank {r} has "
                    f"{s.get(key)!r}, expected {base.get(key)!r}")
    assigned = rebalance(
        {r: list(s["samples"]) for r, s in live.items()},
        rank_map, new_world)
    global_base = sum(int(s.get("batches", 0)) for s in live.values()) + int(
        base.get("global_batch_base", 0))
    out: Dict[int, dict] = {}
    for nr in range(new_world):
        out[nr] = {
            "num_samples": base["num_samples"],
            "batch_size": base["batch_size"],
            "seed": base["seed"],
            "epoch": base["epoch"],
            "samples": [it for it, _src in assigned.get(nr, [])],
            "batches": 0,
            "global_batch_base": global_base,
        }
    return out


# ---------------------------------------------------------------------------
# data iterator
# ---------------------------------------------------------------------------


class ElasticDataIterator:
    """Deterministic per-rank sample iterator that survives gang resizes.

    Epoch `e` is a seeded permutation of range(num_samples) partitioned by
    stride across the world at `start_epoch` time; `next_batch()` consumes
    the local assignment in order and returns None once the local share of
    the epoch is exhausted (epoch advance is an explicit, coordinated call
    — auto-advance would let ranks drift across epoch boundaries and break
    the resize merge). `state()`/`from_state` are the handoff payload the
    elastic protocol moves."""

    def __init__(self, num_samples: int, batch_size: int, seed: int = 0,
                 rank: int = 0, world: int = 1):
        self.num_samples = int(num_samples)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.epoch = 0
        self.batches = 0            # local batches emitted this epoch
        self.global_batch_base = 0  # stamped by the resize plan
        self._remaining: List[int] = []
        self.start_epoch(0, rank=rank, world=world)

    @staticmethod
    def epoch_permutation(num_samples: int, seed: int, epoch: int) -> List[int]:
        rng = random.Random(seed * 1_000_003 + epoch)
        idx = list(range(num_samples))
        rng.shuffle(idx)
        return idx

    def start_epoch(self, epoch: int, rank: int, world: int) -> None:
        perm = self.epoch_permutation(self.num_samples, self.seed, epoch)
        self.epoch = int(epoch)
        self.batches = 0
        self._remaining = perm[rank::world]

    def next_batch(self) -> Optional[List[int]]:
        if not self._remaining:
            return None
        batch = self._remaining[: self.batch_size]
        del self._remaining[: len(batch)]
        self.batches += 1
        return batch

    @property
    def exhausted(self) -> bool:
        return not self._remaining

    @property
    def global_batch(self) -> int:
        """Monotone epoch-wide progress marker (exact while the world is
        stable; re-based from the pooled counts at each resize)."""
        return self.global_batch_base + self.batches

    def state(self) -> dict:
        return {
            "num_samples": self.num_samples,
            "batch_size": self.batch_size,
            "seed": self.seed,
            "epoch": self.epoch,
            "samples": list(self._remaining),
            "batches": self.batches,
            "global_batch_base": self.global_batch_base,
        }

    @classmethod
    def from_state(cls, state: dict) -> "ElasticDataIterator":
        it = cls.__new__(cls)
        it.num_samples = int(state["num_samples"])
        it.batch_size = int(state["batch_size"])
        it.seed = int(state["seed"])
        it.epoch = int(state["epoch"])
        it.batches = int(state.get("batches", 0))
        it.global_batch_base = int(state.get("global_batch_base", 0))
        it._remaining = list(state["samples"])
        return it


# ---------------------------------------------------------------------------
# worker-side protocol client
# ---------------------------------------------------------------------------


@dataclass
class ResizeOutcome:
    """What `ElasticClient.sync()` hands back to the train loop."""

    resized: bool = False
    retired: bool = False
    model: Any = None
    shards: Optional[Dict[Any, Any]] = None
    iterator: Optional[ElasticDataIterator] = None
    rank: int = 0
    world: int = 0
    generation: int = 0


class ElasticClient:
    """Worker-side half of the live-resize protocol.

    The TRAIN thread calls `init_or_join()` once and `sync()` every step;
    the ACTOR thread (TrainWorker methods, driven by the controller) calls
    prepare/status/commit/release/abort. A step's `sync()` is a single
    Event check when no resize is pending — the protocol costs nothing in
    steady state."""

    def __init__(self, ctx):
        self._ctx = ctx
        self._lock = threading.Lock()
        self._pending_gen: Optional[int] = None
        self._flagged = threading.Event()   # prepare() arrived
        self._parked = threading.Event()    # train thread published + waiting
        self._commit_event = threading.Event()
        self._commit: Optional[dict] = None
        self._published: Optional[dict] = None
        self._need_model = False
        self._join_spec: Optional[dict] = None
        self._done = True   # no resize in flight
        self._absorb_error: Optional[str] = None
        self.retired = False
        self.stats = {"resizes": 0, "shards_moved": 0, "joined": False}

    # -- actor-thread API (controller-driven) ---------------------------

    def prepare(self, generation: int, need_model: bool = False) -> bool:
        with self._lock:
            if self.retired:
                return False
            self._pending_gen = int(generation)
            # only the rank whose model will seed joiners pays the full
            # model staging at park (a shrink consumes no model at all)
            self._need_model = bool(need_model)
            self._commit = None
            self._commit_event.clear()
            self._parked.clear()
            self._done = False
            self._flagged.set()
        return True

    def status(self) -> dict:
        with self._lock:
            out = {
                "parked": self._parked.is_set(),
                "done": self._done,
                "failed": self._absorb_error,
                "retired": self.retired,
                "generation": self._pending_gen,
            }
            if self._parked.is_set() and self._published is not None:
                out.update(self._published)
        return out

    def commit(self, spec: dict) -> bool:
        """Deliver the controller's decision to the parked train thread."""
        with self._lock:
            if self.retired:
                return False
            if not self._parked.is_set():
                # not parked (never saw prepare's flag, or already aborted
                # locally on park timeout): only an abort is deliverable
                if spec.get("abort"):
                    self._flagged.clear()
                    self._pending_gen = None
                    self._done = True
                    return True
                return False
            self._commit = dict(spec)
            self._commit_event.set()
        return True

    def abort(self) -> bool:
        return self.commit({"abort": True})

    def release(self) -> bool:
        """Retire a doomed rank: its train thread unparks and returns."""
        return self.commit({"retire": True})

    def done(self) -> bool:
        with self._lock:
            return self._done

    # -- train-thread API ------------------------------------------------

    def init_or_join(
        self,
        init_model: Optional[Callable[[], Any]] = None,
        init_shards: Optional[Callable[[List[Any]], Dict[Any, Any]]] = None,
        shard_keys: Optional[List[Any]] = None,
        iterator: Optional[dict] = None,
    ) -> Tuple[Any, Dict[Any, Any], Optional[ElasticDataIterator]]:
        """First call of an elastic train fn: generation-0 workers build
        fresh state (their stride of `shard_keys`, a fresh iterator);
        workers joining a live run at generation N absorb the handoff
        payload the resize plan assigned them instead."""
        import ray_tpu_torch

        spec = self._join_spec
        if spec is not None:
            self._join_spec = None
            try:
                model = (ray_tpu_torch.get(spec["model_ref"], timeout=120)
                         if spec.get("model_ref") is not None
                         else (init_model() if init_model else None))
                shards: Dict[Any, Any] = {}
                for key, ref in spec.get("shards", []):
                    shards[key] = ray_tpu_torch.get(ref, timeout=120)
                    self.stats["shards_moved"] += 1
            except BaseException as e:  # noqa: BLE001 — join absorb failed
                with self._lock:
                    self._absorb_error = repr(e)
                raise
            it = (ElasticDataIterator.from_state(spec["iter"])
                  if spec.get("iter") is not None else None)
            self.stats["joined"] = True
            with self._lock:
                self._done = True
            return model, shards, it
        model = init_model() if init_model else None
        keys = list(shard_keys or [])
        mine = keys[self._ctx.rank::max(1, self._ctx.world_size)]
        shards = init_shards(mine) if init_shards else {k: None for k in mine}
        it = (ElasticDataIterator(rank=self._ctx.rank,
                                  world=self._ctx.world_size, **iterator)
              if iterator is not None else None)
        return model, shards, it

    def sync(self, model: Any = None, shards: Optional[Dict[Any, Any]] = None,
             iterator: Optional[ElasticDataIterator] = None,
             park_timeout_s: float = 600.0) -> ResizeOutcome:
        """Per-step resize point. Fast path: one Event check. When a
        resize is pending: publish this rank's payload into the object
        plane, park until the controller commits, then absorb the plan
        (fetch only the shards assigned here that are not already local)
        and resume under the new (rank, world, generation)."""
        if not self._flagged.is_set():
            return ResizeOutcome(resized=False)
        import ray_tpu_torch

        with self._lock:
            gen = self._pending_gen
            need_model = self._need_model
        if gen is None:
            self._flagged.clear()
            return ResizeOutcome(resized=False)
        shards = shards or {}
        # publish OUTSIDE the lock: staging a large model/shard set can
        # take long, and the actor thread's status()/commit() polls (the
        # controller's 30s RPC timeouts) must not block behind it. One
        # plane object per shard so absorption moves exactly the assigned
        # shards, nothing else; tensors inside stay on the device for
        # this process (rdt), the put stages host bytes for any
        # cross-process consumer.
        published = {
            "manifest": sorted(shards, key=_sort_key),
            "shard_refs": {k: ray_tpu_torch.put(v) for k, v in shards.items()},
            "model_ref": (ray_tpu_torch.put(model)
                          if model is not None and need_model else None),
            "iter": iterator.state() if iterator is not None else None,
        }
        with self._lock:
            if self._pending_gen != gen:  # aborted while staging
                self._flagged.clear()
                return ResizeOutcome(resized=False)
            self._published = published
            self._parked.set()
        try:
            # slice the park wait so a controller shutdown (stop_event)
            # unparks the train thread instead of orphaning it for the
            # whole timeout; the controller otherwise always resolves a
            # park with commit/abort/release
            deadline = time.monotonic() + park_timeout_s
            committed = False
            while time.monotonic() < deadline:
                if self._commit_event.wait(timeout=0.2):
                    committed = True
                    break
                stop = getattr(self._ctx, "stop_event", None)
                if stop is not None and stop.is_set():
                    break
            with self._lock:
                spec = (self._commit or {"abort": True}) if committed \
                    else {"abort": True}
                self._commit = None
                self._commit_event.clear()
                self._parked.clear()
                self._flagged.clear()
                self._pending_gen = None
                # drop the published refs: every absorber holds its own
                # borrow / fetched copy by now (the controller sequences
                # release after all resize_done acks)
                self._published = None
            if spec.get("retire"):
                self.retired = True
                return ResizeOutcome(retired=True)
            if spec.get("abort"):
                return ResizeOutcome(resized=False)
            try:
                new_shards: Dict[Any, Any] = {}
                for entry in spec.get("shards", []):
                    key, ref = entry[0], entry[1]
                    if key in shards:
                        new_shards[key] = shards[key]  # local: nothing moves
                    else:
                        new_shards[key] = ray_tpu_torch.get(ref, timeout=120)
                        self.stats["shards_moved"] += 1
                new_model = model
                if spec.get("model_ref") is not None:
                    new_model = ray_tpu_torch.get(spec["model_ref"], timeout=120)
            except BaseException as e:  # noqa: BLE001 — absorb failed:
                # mark it BEFORE re-raising so the controller's
                # resize_done sweep sees a failure, not a clean "done",
                # and routes through the planned post-commit teardown
                # instead of charging the failure budget
                with self._lock:
                    self._absorb_error = repr(e)
                raise
            new_it = iterator
            if spec.get("iter") is not None and iterator is not None:
                new_it = ElasticDataIterator.from_state(spec["iter"])
            ctx = self._ctx
            ctx.rank = int(spec["rank"])
            ctx.world_size = int(spec["world"])
            ctx.generation = int(spec.get("generation", ctx.generation + 1))
            self.stats["resizes"] += 1
            return ResizeOutcome(
                resized=True, model=new_model, shards=new_shards,
                iterator=new_it, rank=ctx.rank, world=ctx.world_size,
                generation=ctx.generation)
        finally:
            with self._lock:
                self._done = True


__all__ = [
    "ElasticClient",
    "ElasticDataIterator",
    "ResizeOutcome",
    "ResizePlanError",
    "plan_iterator",
    "plan_shards",
    "rebalance",
]
