"""Worker group: the gang of training worker actors + synchronization actor.

Reference: python/ray/train/v2/_internal/execution/worker_group/
worker_group.py:88 (create/poll/shutdown lifecycle over a placement group)
and checkpoint/sync_actor.py (barrier/broadcast among workers).

The port's copy of ``ray_tpu/train/_worker_group.py``. The group is placed
on a SPREAD placement group of per-worker bundles (a GPU worker's bundle
holds one device by default, one process a device in torch's idiom; a
fractional ``resources_per_worker`` shares the node's); rank 0's node
becomes the torch.distributed rendezvous (``RT_TRAIN_COORDINATOR``, read by
``trainer.setup_torch_distributed``), injected as the reference's JaxConfig
injects its coordinator (reference: python/ray/train/v2/jax/config.py:
60-121). JAX's other placement, a whole TPU slice, is a whole NVLink
domain here (``gpu/slice.py``): with ``use_gpu_domain`` the workers fill
the domain's per-host bundles, ranks in host order. A worker's ``stop``
destroys its process group, so the process can join a gang again.

Elastic extension: the group is GENERATION-aware. A live resize (see
train/_elastic.py) renumbers ranks in place — surviving actors are reused,
never recreated — under a monotonically increasing generation id. All
SyncActor barriers and rendezvous keys are scoped by that generation, so a
straggler from generation N can neither satisfy nor poison generation
N+1's barriers: its calls fail fast with a stale-generation error.
"""

from __future__ import annotations

import logging
import queue
import socket
import sys
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train import _context as ctx_mod
from ray_tpu_torch.train import _elastic

logger = logging.getLogger(__name__)

def destroy_process_group() -> bool:
    """``torch.distributed.destroy_process_group()`` where this process has
    a group: True if it had one. Imports no torch (a process that never
    imported torch.distributed has no group)."""
    dist = sys.modules.get("torch.distributed")
    if dist is None or not dist.is_available() or not dist.is_initialized():
        return False
    dist.destroy_process_group()
    return True


@ray_tpu_torch.remote
class SyncActor:
    """Barrier + rank-0 broadcast rendezvous (reference: sync_actor.py),
    scoped by gang generation: `advance_generation` (called by the
    controller when a live resize commits) invalidates every in-flight
    wait from older generations — parked waiters wake and raise instead
    of satisfying a barrier the resized gang will never complete."""

    def __init__(self):
        self._counts: Dict[tuple, int] = {}
        self._rounds: Dict[tuple, int] = {}
        self._kv: Dict[tuple, Any] = {}
        self._generation = 0

    def _check_gen(self, generation: int):
        if generation < self._generation:
            raise RuntimeError(
                f"stale gang generation {generation} (current: "
                f"{self._generation}) — this worker was resized out or "
                f"has not absorbed the resize yet")

    async def _await_gen(self, generation: int):
        """Stale generations fail fast; FUTURE generations wait — a joiner
        starts at generation N+1 and may reach a barrier before the
        controller's advance_generation commit lands (the commit always
        follows: joiners only exist because a resize is in flight)."""
        import asyncio

        self._check_gen(generation)
        while generation > self._generation:
            await asyncio.sleep(0.01)
        self._check_gen(generation)

    async def barrier(self, name: str, world_size: int, generation: int = 0):
        import asyncio

        await self._await_gen(generation)
        key = (generation, name)
        self._counts[key] = self._counts.get(key, 0) + 1
        rnd = self._rounds.get(key, 0)
        if self._counts[key] >= world_size:
            self._counts[key] = 0
            self._rounds[key] = rnd + 1
            return True
        while self._rounds.get(key, 0) == rnd:
            self._check_gen(generation)  # a resize landed mid-wait
            await asyncio.sleep(0.01)
        return True

    async def put(self, key: str, value: Any, generation: int = 0):
        await self._await_gen(generation)
        self._kv[(generation, key)] = value
        return True

    async def wait_for(self, key: str, poll_s: float = 0.01,
                       generation: int = 0):
        import asyncio

        await self._await_gen(generation)
        while (generation, key) not in self._kv:
            self._check_gen(generation)
            await asyncio.sleep(poll_s)
        return self._kv[(generation, key)]

    async def advance_generation(self, generation: int):
        """Commit point of a live resize: bump the generation and drop
        stale barrier rounds/kv so generation-N stragglers fail fast
        (their wait loops observe the bump and raise)."""
        if generation <= self._generation:
            return False
        self._generation = generation
        for d in (self._counts, self._rounds, self._kv):
            for k in [k for k in d if k[0] < generation]:
                del d[k]
        return True

    async def generation(self) -> int:
        return self._generation


@ray_tpu_torch.remote
class TrainWorker:
    """One training process. Runs the user's train fn on a thread with a
    TrainContext installed; buffers reports for the controller's polls.
    The elastic resize protocol (prepare/status/commit/release) is driven
    through actor methods while the train thread runs — parking happens
    cooperatively at the train fn's next `elastic.sync()` call."""

    def __init__(self, rank: int, world_size: int, local_rank: int,
                 node_rank: int, run_name: str, storage_path: str,
                 run_dir: str):
        self.rank = rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.node_rank = node_rank
        self.run_name = run_name
        self.storage_path = storage_path
        self.run_dir = run_dir
        self._thread: Optional[threading.Thread] = None
        self._ctx: Optional[ctx_mod.TrainContext] = None
        self._error: Optional[str] = None
        self._done = False

    def node_ip(self) -> str:
        return socket.gethostbyname(socket.gethostname())

    def host_node_id(self) -> str:
        """Hex id of the node daemon that spawned this worker process —
        ground truth for the controller's drain blast-radius mapping (the
        actor-table record can lag placement)."""
        import os

        return os.environ.get("RT_NODE_ID", "")

    def start(self, train_fn_pickled: bytes, config: Optional[dict],
              latest_checkpoint: Optional[dict],
              sync_actor, env_vars: Optional[Dict[str, str]] = None,
              elastic: bool = False, generation: int = 0,
              elastic_join: Optional[dict] = None) -> bool:
        import os

        import cloudpickle

        # cloudpickle: the user's train fn is typically a closure/local def,
        # beyond plain pickle (same treatment as exported remote functions)
        train_fn = cloudpickle.loads(train_fn_pickled)
        if env_vars:
            os.environ.update(env_vars)
        # generation-scoped at WRITE time (ctx.generation moves with each
        # committed resize), so a resize purge of older generations can
        # never race these writes
        from ray_tpu_torch.train._checkpoint import staging_dir_name

        staging_fn = (
            lambda step: f"{self.run_dir}/"
                         f"{staging_dir_name(step, ctx.generation)}"
        )
        ctx = ctx_mod.TrainContext(
            rank=self.rank, world_size=self.world_size,
            local_rank=self.local_rank, node_rank=self.node_rank,
            run_name=self.run_name, storage_path=self.storage_path,
            staging_dir_fn=staging_fn,
            latest_checkpoint=(
                Checkpoint.from_wire(latest_checkpoint)
                if latest_checkpoint else None
            ),
        )
        ctx._sync_client = sync_actor
        ctx.generation = generation
        if elastic or elastic_join is not None:
            ctx.elastic = _elastic.ElasticClient(ctx)
            if elastic_join is not None:
                ctx.elastic._join_spec = dict(elastic_join)
                with ctx.elastic._lock:
                    ctx.elastic._done = False
        self._ctx = ctx

        def run():
            ctx_mod.set_context(ctx)
            try:
                if config is not None:
                    train_fn(config)
                else:
                    train_fn()
            except BaseException:  # noqa: BLE001 — reported to controller
                self._error = traceback.format_exc()
            finally:
                self._done = True
                ctx_mod.set_context(None)

        self._thread = threading.Thread(target=run, name="train-fn", daemon=True)
        self._thread.start()
        return True

    def poll(self) -> dict:
        """Drain buffered reports; include liveness/error state."""
        reports = []
        if self._ctx is not None:
            while True:
                try:
                    reports.append(self._ctx.report_queue.get_nowait())
                except queue.Empty:
                    break
        return {"reports": reports, "done": self._done, "error": self._error}

    def stop(self) -> bool:
        if self._ctx is not None:
            self._ctx.stop_event.set()
        destroy_process_group()
        return True

    def flush_checkpoints(self) -> bool:
        """Block until any in-flight async checkpoint write lands."""
        if self._ctx is not None:
            self._ctx._writer.wait()
        return True

    # -- elastic resize protocol (controller-driven) --------------------

    def _elastic_client(self):
        if self._ctx is None or self._ctx.elastic is None:
            return None
        return self._ctx.elastic

    def prepare_resize(self, generation: int, need_model: bool = False) -> bool:
        client = self._elastic_client()
        if client is None:
            return False
        return client.prepare(generation, need_model)

    def resize_status(self) -> dict:
        client = self._elastic_client()
        out = client.status() if client is not None else {"parked": False,
                                                          "done": True}
        out["training_done"] = self._done
        out["rank"] = self._ctx.rank if self._ctx else self.rank
        return out

    def commit_resize(self, spec: dict) -> bool:
        client = self._elastic_client()
        return client.commit(spec) if client is not None else False

    def abort_resize(self) -> bool:
        client = self._elastic_client()
        return client.abort() if client is not None else True

    def release_resize(self) -> bool:
        client = self._elastic_client()
        return client.release() if client is not None else False

    def resize_done(self) -> bool:
        client = self._elastic_client()
        return client.done() if client is not None else True

    def elastic_stats(self) -> dict:
        client = self._elastic_client()
        return dict(client.stats) if client is not None else {}


@dataclass
class WorkerStatus:
    alive: bool
    done: bool = False
    error: Optional[str] = None
    reports: List[dict] = field(default_factory=list)
    # hex id of the node that hosted the worker, resolved for dead workers
    # so the controller can ask "was THAT node draining?" instead of
    # treating any drain anywhere in the cluster as the cause
    node_id: Optional[str] = None


class WorkerGroup:
    """Creates, polls, resizes, and tears down the gang of TrainWorker
    actors. `live_resize` reuses surviving actors in place — the teardown/
    recreate path is the fallback, not the norm."""

    def __init__(self, num_workers: int, resources_per_worker: Dict[str, float],
                 run_name: str, storage_path: str, run_dir: str,
                 use_gpu_domain: bool = False, topology: str = "",
                 accelerator_type: str = "", elastic: bool = False):
        self.num_workers = num_workers
        self.resources_per_worker = dict(resources_per_worker)
        self.run_name = run_name
        self.storage_path = storage_path
        self.run_dir = run_dir
        self.use_gpu_domain = use_gpu_domain
        self.topology = topology
        self.accelerator_type = accelerator_type
        self.elastic = elastic
        self.workers: List[Any] = []        # index == current rank
        self.worker_nodes: List[Optional[str]] = []
        self.generation = 0      # last COMMITTED generation
        # every attempt burns a fresh generation number, committed or not:
        # an aborted attempt's killed joiner may have left barrier/kv calls
        # parked in the SyncActor at its generation — reusing the number
        # would let that residue poison the retry (phantom barrier counts,
        # stale rendezvous values). advance_generation purges strictly
        # older keys only.
        self._attempt_gen = 0
        # final reports drained from ranks retired by a live resize — the
        # next poll() hands them to the controller; killing a doomed actor
        # must not lose the (reported) samples it consumed before parking
        self._stashed_reports: List[dict] = []
        self.sync_actor = None
        self._pg = None
        self._slice_pg = None
        self._fn_bytes: Optional[bytes] = None
        self._config: Optional[dict] = None

    # -- lifecycle ------------------------------------------------------

    def create(self, latest_checkpoint: Optional[Checkpoint] = None):
        from ray_tpu_torch.util.placement_group import placement_group

        # unique name per ATTEMPT: a retry after a failed creation must not
        # collide with (and bind to) the previous attempt's still-dying
        # named actor — that surfaced as "actor failed to start:
        # ray_tpu_torch.kill" under full-suite load. Discovery is by handle (the
        # workers receive it in start()); the name is only for debugging.
        import os as _os

        placement = self._sync_actor_placement()
        self.sync_actor = SyncActor.options(
            name=f"{self.run_name}-sync-{_os.urandom(4).hex()}",
            namespace="_train",
            **placement,
        ).remote()
        if placement:
            # the anti-spot selector was chosen from a SNAPSHOT: if the
            # last non-spot node left between the check and placement, the
            # selector is unmatchable and the actor queues infeasible
            # forever. Probe readiness; on expiry RE-CHECK feasibility —
            # only a genuinely all-spot cluster falls back to
            # unconstrained placement (a merely slow scheduler must not
            # silently trade away the anti-spot protection).
            try:
                ray_tpu_torch.get(self.sync_actor.generation.remote(), timeout=20)
            except (ray_tpu_torch.GetTimeoutError, ray_tpu_torch.ActorDiedError,
                    ray_tpu_torch.ActorUnavailableError):
                if self._sync_actor_placement():
                    logger.warning(
                        "anti-spot SyncActor slow to place but non-spot "
                        "capacity still exists — keeping the constraint")
                else:
                    logger.warning(
                        "anti-spot SyncActor placement infeasible "
                        "(non-spot capacity gone) — falling back to "
                        "unconstrained placement")
                    try:
                        ray_tpu_torch.kill(self.sync_actor)
                    except Exception:  # noqa: BLE001
                        pass
                    self.sync_actor = SyncActor.options(
                        name=f"{self.run_name}-sync-{_os.urandom(4).hex()}",
                        namespace="_train",
                    ).remote()

        bundle_of = list(range(self.num_workers))
        if self.use_gpu_domain:
            from ray_tpu_torch.gpu.slice import slice_placement_group

            self._slice_pg = slice_placement_group(
                pod_type=self.accelerator_type, num_slices=1,
                topology=self.topology,
            )
            hosts = self._slice_pg.hosts_per_slice
            if self.num_workers % hosts:
                raise ValueError(
                    f"{self.num_workers} workers do not fill the "
                    f"{hosts} hosts of topology {self.topology!r} evenly")
            if not self._slice_pg.ready(timeout=120):
                raise TimeoutError(
                    f"NVLink domain {self.accelerator_type} "
                    f"({self.topology}) not reserved")
            pg = self._slice_pg.placement_group
            # ranks fill the hosts in order, num_workers / hosts each
            bundle_of = [i * hosts // self.num_workers
                         for i in range(self.num_workers)]
        elif self.elastic:
            # no gang placement group: a PG fate-shares every bundle with
            # every bundle's node — one drained node would take the whole
            # (healthy) gang down with "placement group returned" exactly
            # when the live resize wants the survivors untouched. Elastic
            # workers schedule individually (drain_cooperative below keeps
            # the control store's drain migration off them too: the
            # controller owns their planned-removal handling).
            pg = None
        else:
            pg = placement_group(
                [dict(self.resources_per_worker)
                 for _ in range(self.num_workers)],
                strategy="SPREAD",
            )
            if not pg.ready(timeout=120):
                raise TimeoutError("worker-group placement group not ready")
        self._pg = pg

        self.workers = [
            self._worker_options(pg=pg, bundle_index=bundle_of[i]).remote(
                rank=i, world_size=self.num_workers, local_rank=0,
                node_rank=i, run_name=self.run_name,
                storage_path=self.storage_path, run_dir=self.run_dir,
            )
            for i in range(self.num_workers)
        ]
        # rank-0's host becomes the torch.distributed rendezvous
        ips = ray_tpu_torch.get([w.node_ip.remote() for w in self.workers],
                          timeout=120)
        coordinator = f"{ips[0]}:{_pick_port(self.run_name)}"
        env_base = {
            "RT_TRAIN_COORDINATOR": coordinator,
            "RT_TRAIN_WORLD_SIZE": str(self.num_workers),
        }
        self._env_base = env_base
        self._latest = latest_checkpoint
        self._resolve_worker_nodes()
        return self

    @staticmethod
    def _sync_actor_placement() -> Dict[str, Any]:
        """Pin the rendezvous/barrier actor OFF spot/preemptible capacity
        (nodes labeled spot=true / preemptible=true): every elastic resize
        rendezvouses through the SyncActor, so losing it to a reclaimed
        spot node mid-resize turns a planned shrink into a full
        checkpoint-restore. Anti-affinity via the "!value" label selector;
        falls back to unconstrained placement when every usable node
        carries the marker (an all-spot cluster must still train).
        Implementation shared with the other coordination singletons in
        `_private/spot.py`."""
        from ray_tpu_torch._private.spot import anti_spot_placement

        return anti_spot_placement("the rendezvous SyncActor")

    def _worker_options(self, pg=None, bundle_index: int = -1):
        opts: Dict[str, Any] = {"resources": self.resources_per_worker}
        if pg is not None:
            opts["placement_group"] = pg
            opts["placement_group_bundle_index"] = bundle_index
        if self.elastic:
            opts["drain_cooperative"] = True
        return TrainWorker.options(**opts)

    def start_training(self, train_fn: Callable, config: Optional[dict]):
        import cloudpickle

        self._fn_bytes = cloudpickle.dumps(train_fn)
        self._config = config
        wire_ckpt = self._latest.to_wire() if self._latest else None
        starts = []
        for i, w in enumerate(self.workers):
            env = dict(self._env_base)
            env["RT_TRAIN_RANK"] = str(i)
            starts.append(w.start.remote(
                self._fn_bytes, config, wire_ckpt, self.sync_actor, env,
                self.elastic, self.generation))
        ray_tpu_torch.get(starts, timeout=120)

    def poll(self) -> List[WorkerStatus]:
        out: List[WorkerStatus] = []
        if self._stashed_reports:
            out.append(WorkerStatus(alive=True, done=True,
                                    reports=self._stashed_reports))
            self._stashed_reports = []
        refs = [w.poll.remote() for w in self.workers]
        for i, ref in enumerate(refs):
            try:
                r = ray_tpu_torch.get(ref, timeout=60)
                out.append(WorkerStatus(alive=True, done=r["done"],
                                        error=r["error"], reports=r["reports"],
                                        node_id=(self.worker_nodes[i]
                                                 if i < len(self.worker_nodes)
                                                 else None)))
            except (ray_tpu_torch.ActorDiedError, ray_tpu_torch.ActorUnavailableError,
                    ray_tpu_torch.GetTimeoutError) as e:
                logger.info("worker rank %d (gen %d, node %s) poll failed: %s",
                            i, self.generation,
                            (self.worker_nodes[i] or "?")[:12]
                            if i < len(self.worker_nodes) else "?", e)
                out.append(WorkerStatus(alive=False, error=str(e),
                                        node_id=self._worker_node(i)))
        return out

    def _worker_node(self, idx: int) -> Optional[str]:
        """Last node that hosted worker `idx` (the actor record keeps its
        node_id after death)."""
        try:
            from ray_tpu_torch._private.core_worker import get_core_worker

            cw = get_core_worker()
            info = cw.run_sync(cw.control.call(
                "get_actor_info",
                {"actor_id": self.workers[idx]._actor_id.binary()}),
                10)["actor"]
            nid = info.get("node_id")
            return nid.hex() if nid else None
        except Exception:  # noqa: BLE001 — control store unreachable
            return None

    def _resolve_worker_nodes(self):
        """Map each worker to its hosting node (drain notices name nodes;
        the controller needs worker-level blast radius). Asks each LIVE
        worker for its own RT_NODE_ID — the actor-table record can lag
        placement, and a wrong mapping here would shrink away the healthy
        half of the gang."""
        nodes: List[Optional[str]] = []
        try:
            resolved = ray_tpu_torch.get(
                [w.host_node_id.remote() for w in self.workers], timeout=60)
            nodes = [r or None for r in resolved]
        except (ray_tpu_torch.ActorDiedError, ray_tpu_torch.ActorUnavailableError,
                ray_tpu_torch.GetTimeoutError):
            nodes = [self._worker_node(i) for i in range(len(self.workers))]
        self.worker_nodes = nodes

    def flush_checkpoints(self):
        try:
            ray_tpu_torch.get(
                [w.flush_checkpoints.remote() for w in self.workers],
                timeout=300,
            )
        except (ray_tpu_torch.ActorDiedError, ray_tpu_torch.ActorUnavailableError):
            pass

    # -- live resize ----------------------------------------------------

    def live_resize(self, keep: List[int], add: int = 0,
                    park_timeout_s: float = 20.0) -> str:
        """Resize the gang in place: survivors (current ranks in `keep`)
        are renumbered 0..len(keep)-1 and reused; `add` joiners are
        spawned at the tail ranks. Returns:

        - "ok"      — resize committed; the group now has the new shape
        - "aborted" — nothing changed (park timed out, plan infeasible,
                      training already finishing); safe to continue
        - "failed"  — the resize died after the commit point (a survivor
                      or joiner was lost mid-absorption); the gang is in
                      an undefined shape and must go through teardown

        Protocol (see train/_elastic.py): prepare -> all workers park at
        a step boundary and publish their shard/iterator payload into the
        object plane -> plan (retention-first, only lost/overflow shards
        assigned across processes) -> joiners spawn+absorb -> generation
        advances -> survivors commit+absorb -> doomed ranks released.
        Everything that can fail cleanly happens before the commit point.
        """
        keep = sorted(keep)
        new_world = len(keep) + add
        if not self.elastic or new_world <= 0:
            return "aborted"
        self._attempt_gen += 1
        gen = self._attempt_gen
        keep_set = set(keep)
        doomed = [i for i in range(len(self.workers)) if i not in keep_set]
        logger.info(
            "live resize gen %d: %d -> %d workers (keep=%s, +%d joiners)",
            gen, len(self.workers), new_world, keep, add)

        for i, w in enumerate(self.workers):
            # only the lowest surviving rank stages its model — it seeds
            # joiners; nothing consumes a model on a pure shrink
            w.prepare_resize.remote(
                gen, bool(add > 0 and keep and i == keep[0]))

        # 1. wait for every current worker to park (abort early if one
        #    finishes training or dies — both make the resize moot)
        statuses = self._await_parked(park_timeout_s)
        if statuses is None:
            self._abort_resize()
            return "aborted"

        # 1b. drain the doomed ranks' final reports while they are parked
        #     (nothing new arrives past the park): killing them after
        #     release must not lose the samples they consumed+reported
        if doomed:
            try:
                finals = ray_tpu_torch.get(
                    [self.workers[i].poll.remote() for i in doomed],
                    timeout=30)
                for r in finals:
                    self._stashed_reports.extend(r.get("reports") or [])
            except Exception as e:  # noqa: BLE001 — a doomed worker died
                logger.warning("doomed-rank report drain failed: %s", e)
                self._abort_resize()
                return "aborted"

        # 2. plan: shards + iterator over the published payloads
        rank_map = {old: new for new, old in enumerate(keep)}
        try:
            shard_plan = _elastic.plan_shards(
                {i: list(st.get("manifest") or []) for i, st in
                 statuses.items()},
                rank_map, new_world)
            iter_plan = _elastic.plan_iterator(
                {i: st.get("iter") for i, st in statuses.items()},
                rank_map, new_world)
        except _elastic.ResizePlanError as e:
            logger.warning("live resize plan infeasible: %s", e)
            self._abort_resize()
            return "aborted"
        ref_of = {i: st.get("shard_refs") or {} for i, st in statuses.items()}
        # the lowest surviving rank's published model seeds joiners
        model_src = statuses[keep[0]].get("model_ref") if keep else None

        def spec_for(new_rank: int, joiner: bool) -> dict:
            shards = []
            for key, src in shard_plan.get(new_rank, []):
                local = (not joiner) and rank_map.get(src) == new_rank
                shards.append([key, None if local else ref_of[src].get(key)])
            return {
                "generation": gen, "rank": new_rank, "world": new_world,
                "shards": shards, "iter": iter_plan.get(new_rank),
                "model_ref": model_src if joiner else None,
            }

        # 3. joiners spawn and absorb BEFORE the commit point: a joiner
        #    that fails to start aborts the resize with survivors still
        #    parked and nothing renumbered. All starts are issued together
        #    — the gang is paused for the SLOWEST joiner, not the sum.
        joiners: List[Any] = []
        try:
            starts = []
            for j in range(add):
                nr = len(keep) + j
                w = self._worker_options().remote(
                    rank=nr, world_size=new_world, local_rank=0,
                    node_rank=nr, run_name=self.run_name,
                    storage_path=self.storage_path, run_dir=self.run_dir,
                )
                env = dict(self._env_base)
                env["RT_TRAIN_RANK"] = str(nr)
                env["RT_TRAIN_WORLD_SIZE"] = str(new_world)
                starts.append(w.start.remote(
                    self._fn_bytes, self._config, None, self.sync_actor,
                    env, True, gen, spec_for(nr, joiner=True)))
                joiners.append(w)
            if starts:
                ray_tpu_torch.get(starts, timeout=120)
            if joiners and not self._await_done(joiners, park_timeout_s):
                raise TimeoutError("joiners never absorbed the handoff")
            # re-validate right before the point of no return: a survivor
            # whose park wait expired during a slow joiner spawn silently
            # resumed — committing would renumber a gang that is already
            # running at the old shape
            sts = ray_tpu_torch.get(
                [self.workers[i].resize_status.remote() for i in keep],
                timeout=30)
            if not all(st.get("parked") for st in sts):
                raise TimeoutError("a survivor unparked before commit")
        except Exception as e:  # noqa: BLE001 — pre-commit: clean abort
            logger.warning("live resize aborted before commit: %s", e)
            self._kill_workers(joiners)
            self._abort_resize()
            return "aborted"

        # ---- commit point ------------------------------------------------
        # 4. the generation advances (stale-gen barrier calls now fail
        #    fast), then survivors renumber and absorb
        try:
            ray_tpu_torch.get(self.sync_actor.advance_generation.remote(gen),
                        timeout=30)
            survivors = [self.workers[i] for i in keep]
            acks = [w.commit_resize.remote(spec_for(nr, joiner=False))
                    for nr, w in enumerate(survivors)]
            if not all(ray_tpu_torch.get(acks, timeout=60)):
                raise RuntimeError("a survivor rejected the resize commit")
            if not self._await_done(survivors, max(park_timeout_s, 60.0)):
                raise TimeoutError("survivors never finished absorbing")
        except Exception as e:  # noqa: BLE001 — post-commit: poisoned
            logger.error("live resize failed after commit: %s", e)
            # the joiners are not yet in self.workers: reap them here or
            # they outlive the teardown, squat on gang resources, and
            # keep writing shard files into the run's staging dirs
            self._kill_workers(joiners)
            return "failed"

        # 5. release the doomed ranks so their train fns return cleanly
        #    inside the drain window: await the release ack (the commit is
        #    delivered to the parked thread) and then give the train fn a
        #    beat to unwind its finally blocks — an immediate kill races
        #    the un-awaited release through the control plane and cuts
        #    user cleanup off. Bounded tightly: the node is dying anyway.
        doomed_workers = [self.workers[i] for i in doomed]
        try:
            ray_tpu_torch.get([w.release_resize.remote() for w in doomed_workers],
                        timeout=10)
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                polls = ray_tpu_torch.get([w.poll.remote() for w in doomed_workers],
                                    timeout=10)
                for p in polls:
                    # anything reported during unwind still reaches the
                    # controller (the pre-park payload was stashed earlier)
                    self._stashed_reports.extend(p.get("reports") or [])
                if all(p.get("done") for p in polls):
                    break
                time.sleep(0.05)
        except Exception:  # noqa: BLE001 — a doomed worker died mid-release
            pass
        self._kill_workers(doomed_workers)

        self.workers = [self.workers[i] for i in keep] + joiners
        self.num_workers = new_world
        self.generation = gen
        self._env_base["RT_TRAIN_WORLD_SIZE"] = str(new_world)
        self._resolve_worker_nodes()
        logger.info("live resize gen %d committed: world=%d", gen, new_world)
        return "ok"

    def _await_parked(self, timeout_s: float) -> Optional[Dict[int, dict]]:
        """Poll resize_status until every worker is parked with a payload.
        None => abort (timeout, a death, or training finishing)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                sts = ray_tpu_torch.get(
                    [w.resize_status.remote() for w in self.workers],
                    timeout=30)
            except (ray_tpu_torch.ActorDiedError, ray_tpu_torch.ActorUnavailableError,
                    ray_tpu_torch.GetTimeoutError) as e:
                logger.warning("worker lost while parking for resize: %s", e)
                return None
            if any(st.get("training_done") for st in sts):
                return None  # the run is ending; let it end
            if all(st.get("parked") for st in sts):
                return dict(enumerate(sts))
            time.sleep(0.05)
        logger.warning("live resize park timed out after %.1fs", timeout_s)
        return None

    def _await_done(self, workers: List[Any], timeout_s: float) -> bool:
        """True only when every worker finished its absorb CLEANLY — a
        worker whose absorb raised reports failed (done alone would read
        as success and let the resize destroy the unabsorbed shards'
        last copies)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                sts = ray_tpu_torch.get(
                    [w.resize_status.remote() for w in workers], timeout=30)
            except (ray_tpu_torch.ActorDiedError, ray_tpu_torch.ActorUnavailableError,
                    ray_tpu_torch.GetTimeoutError):
                return False
            failed = [st.get("failed") for st in sts if st.get("failed")]
            if failed:
                logger.warning("resize absorb failed: %s", failed[0])
                return False
            if all(st.get("done") for st in sts):
                return True
            time.sleep(0.05)
        return False

    @staticmethod
    def _kill_workers(workers: List[Any]):
        for w in workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # noqa: BLE001
                pass

    def _abort_resize(self):
        for w in self.workers:
            try:
                w.abort_resize.remote()
            except Exception:  # noqa: BLE001
                pass

    def shutdown(self):
        for w in self.workers:
            try:
                w.stop.remote()
            except Exception:  # noqa: BLE001
                pass
        time.sleep(0.2)
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # noqa: BLE001
                pass
        if self.sync_actor is not None:
            try:
                ray_tpu_torch.kill(self.sync_actor)
            except Exception:  # noqa: BLE001
                pass
        if self._slice_pg is not None:
            try:
                self._slice_pg.remove()
            except Exception:  # noqa: BLE001
                pass
        elif self._pg is not None:
            try:
                from ray_tpu_torch.util.placement_group import remove_placement_group

                remove_placement_group(self._pg)
            except Exception:  # noqa: BLE001
                pass
        self.workers = []


def _pick_port(seed: str) -> int:
    return 20000 + (hash(seed) % 20000)
