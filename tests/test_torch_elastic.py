"""The port's elastic training (``ray_tpu_torch.train``: the live gang
resize of ``_elastic.py``, ``ElasticScalingPolicy``, the generation-scoped
``SyncActor``, ``ElasticClient``) against the tier-1 cases of
``test_elastic_train.py`` and the controller case of
``test_elastic_restore.py`` (its checkpoint cases are
``test_torch_checkpoint.py``'s), on the port's runtime and its
``cluster_utils``. The chaos soak drains its victim through the control
store's ``drain_node`` and its shards are torch tensors, moved host-staged
through the object plane. JAX's ``test_preemption_watcher_rearm_fires_again``
is mirrored in ``test_torch_preemption.py``, beside the watcher. The runtime
imports no torch, so these run in the pytest worker; the train fns import
torch in the port's worker processes.
"""

import os
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private import chaos
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch.train._elastic import (
    ElasticClient,
    ElasticDataIterator,
    ResizePlanError,
    plan_iterator,
    plan_shards,
)
from ray_tpu_torch.train._policies import (
    ElasticScalingPolicy,
    FailurePolicy,
    ScalingDecision,
    ScalingPolicy,
    usable_cluster_resources,
)
from ray_tpu_torch.util.metrics import reset_registry


@pytest.fixture(autouse=True)
def _reset_port_config():
    """The conftest fixture resets the JAX package's registries; this one
    resets the port's."""
    yield
    GLOBAL_CONFIG.reset()
    chaos.reset()
    reset_registry()


SEEDS = [
    101,
    pytest.param(202, marks=pytest.mark.slow),
    pytest.param(303, marks=pytest.mark.slow),
]


# ---------------------------------------------------------------------------
# pure planner
# ---------------------------------------------------------------------------


def _moved(plan, rank_map):
    return sorted(k for nr, lst in plan.items() for k, src in lst
                  if rank_map.get(src) != nr)


def test_plan_shards_shrink_moves_only_lost_shards():
    manifests = {0: [0, 4], 1: [1, 5], 2: [2, 6], 3: [3, 7]}
    rank_map = {0: 0, 1: 1, 2: 2}  # rank 3 doomed
    plan = plan_shards(manifests, rank_map, 3)
    # balanced +-1 and complete
    sizes = sorted(len(v) for v in plan.values())
    assert sizes == [2, 3, 3]
    assert sorted(k for lst in plan.values() for k, _ in lst) == list(range(8))
    # exactly the dead rank's shards changed hands
    assert _moved(plan, rank_map) == [3, 7]


def test_plan_shards_grow_moves_only_overflow():
    manifests = {0: [0, 2], 1: [1, 3]}
    rank_map = {0: 0, 1: 1}
    plan = plan_shards(manifests, rank_map, 4)
    assert sorted(len(v) for v in plan.values()) == [1, 1, 1, 1]
    # each survivor sheds exactly one shard to a joiner; determinism too
    assert _moved(plan, rank_map) == [2, 3]
    assert plan == plan_shards(manifests, rank_map, 4)


def test_plan_shards_rejects_duplicate_holder():
    with pytest.raises(ResizePlanError, match="held by both"):
        plan_shards({0: [1], 1: [1]}, {0: 0, 1: 1}, 2)


def test_plan_iterator_pool_preserved_exactly():
    its = {r: ElasticDataIterator(40, 3, seed=9, rank=r, world=4)
           for r in range(4)}
    for it in its.values():
        it.next_batch()
    consumed = 4 * 3
    states = {r: it.state() for r, it in its.items()}
    plan = plan_iterator(states, {0: 0, 2: 1}, 2)
    pooled = sorted(s for st in states.values() for s in st["samples"])
    replanned = sorted(s for st in plan.values() for s in st["samples"])
    assert replanned == pooled
    assert len(pooled) == 40 - consumed
    # survivors retain their own remaining samples where the quota allows
    kept0 = set(states[0]["samples"]) & set(plan[0]["samples"])
    assert len(kept0) == len(states[0]["samples"])  # under quota: all kept


def test_plan_iterator_epoch_mismatch_aborts():
    a = ElasticDataIterator(8, 2, seed=1, rank=0, world=2)
    b = ElasticDataIterator(8, 2, seed=1, rank=1, world=2)
    b.start_epoch(1, rank=1, world=2)  # crossed the boundary already
    with pytest.raises(ResizePlanError, match="epoch"):
        plan_iterator({0: a.state(), 1: b.state()}, {0: 0, 1: 1}, 2)


def test_iterator_handoff_exact_coverage_across_shrink_and_regrow():
    """The contract: across any shrink/regrow sequence, no sample is
    dropped or consumed twice within an epoch."""
    n, batch, seed = 101, 4, 7
    its = {r: ElasticDataIterator(n, batch, seed=seed, rank=r, world=3)
           for r in range(3)}
    consumed = []

    def consume(steps):
        for it in its.values():
            for _ in range(steps):
                b = it.next_batch()
                if b:
                    consumed.extend(b)

    consume(3)
    # shrink 3 -> 2 (rank 2 dies; its remaining samples are re-planned)
    plan = plan_iterator({r: it.state() for r, it in its.items()},
                         {0: 0, 1: 1}, 2)
    its = {r: ElasticDataIterator.from_state(plan[r]) for r in plan}
    consume(4)
    # regrow 2 -> 4 (joiners take a slice of the remaining pool)
    plan = plan_iterator({r: it.state() for r, it in its.items()},
                         {0: 0, 1: 1}, 4)
    its = {r: ElasticDataIterator.from_state(plan[r]) for r in plan}
    while any(not it.exhausted for it in its.values()):
        consume(1)
    assert sorted(consumed) == list(range(n))


def test_iterator_epoch_partition_is_disjoint_and_seeded():
    n = 64
    a = ElasticDataIterator(n, 4, seed=3, rank=0, world=2)
    b = ElasticDataIterator(n, 4, seed=3, rank=1, world=2)
    sa, sb = set(a.state()["samples"]), set(b.state()["samples"])
    assert not (sa & sb) and len(sa | sb) == n
    # same seed+epoch => same permutation
    assert (ElasticDataIterator.epoch_permutation(n, 3, 0)
            == ElasticDataIterator.epoch_permutation(n, 3, 0))
    assert (ElasticDataIterator.epoch_permutation(n, 3, 0)
            != ElasticDataIterator.epoch_permutation(n, 3, 1))


# ---------------------------------------------------------------------------
# sizing fix (satellite): DRAINING / freshly-dead nodes never count
# ---------------------------------------------------------------------------


def _node(state="ALIVE", cpu=4.0, spot=0.0, drain_reason="", death=None):
    res = {"CPU": cpu}
    if spot:
        res["spot"] = spot
    return {"node_id": os.urandom(4).hex(), "state": state,
            "resources": res, "drain_reason": drain_reason, "death": death}


def test_usable_resources_exclude_draining_and_fresh_expected_death():
    now = 1000.0
    nodes = [
        _node(cpu=4, spot=2),
        _node(state="DRAINING", cpu=4, spot=2),
        _node(drain_reason="preemption", cpu=4),  # notice racing state
        _node(state="DEAD", cpu=4),
        _node(cpu=8, death={"expected": True, "ts": now - 5.0}),
        _node(cpu=8, death={"expected": True, "ts": now - 500.0}),  # stale
    ]
    usable = usable_cluster_resources(nodes, 120.0, now=now)
    assert usable == {"CPU": 12.0, "spot": 2.0}


def test_elastic_policy_fits_every_resource_shape():
    pol = ElasticScalingPolicy(1, 8)
    # spot-constrained: plenty of CPU must not inflate the fit
    d = pol.target_size({"CPU": 64.0, "spot": 2.0}, {"spot": 1.0})
    assert d.num_workers == 2
    # the pre-fix failure mode: a DRAINING node's resources inflate the
    # fit and the post-drain re-create targets an impossible width
    draining = _node(state="DRAINING", cpu=0, spot=2)
    alive = _node(cpu=4, spot=2)
    usable = usable_cluster_resources([alive, draining], 120.0)
    assert pol.target_size(usable, {"spot": 1.0}).num_workers == 2
    # bare float stays accepted (compatibility)
    assert pol.target_size(6.0, {"CPU": 2.0}).num_workers == 3


def test_checkpoint_finalize_idempotent_for_duplicate_step(tmp_path):
    """A step id can be reported twice (per-rank counters restart across
    a resize): the first promotion wins, the duplicate staging dir drops,
    and the controller never crashes on rename-over-existing."""
    from ray_tpu_torch.train._checkpoint import CheckpointManager

    mgr = CheckpointManager(str(tmp_path), "dup", num_to_keep=3)
    os.makedirs(mgr.staging_dir(5))
    np.savez(os.path.join(mgr.staging_dir(5), "rank_0.npz"), w=np.ones(2))
    first = mgr.finalize(5, {"loss": 1.0}, expected_ranks=1)
    assert first is not None
    os.makedirs(mgr.staging_dir(5))
    np.savez(os.path.join(mgr.staging_dir(5), "rank_0.npz"), w=np.zeros(2))
    again = mgr.finalize(5, {"loss": 2.0}, expected_ranks=1)
    assert again is not None and again.path == first.path
    # the duplicate staging dir is LEFT for the purge paths: deleting it
    # at finalize time would race a skewed rank's in-flight shard write
    assert os.path.isdir(mgr.staging_dir(5))
    assert len(mgr.checkpoints) == 1
    # purge_staging sweeps leftovers (generation-targeted at resize
    # commits, wholesale at restarts)
    os.makedirs(mgr.staging_dir(9, generation=2))
    mgr.purge_staging(below_generation=2)
    assert not os.path.isdir(mgr.staging_dir(5))      # gen 0 < 2: reaped
    assert os.path.isdir(mgr.staging_dir(9, generation=2))  # current: kept
    mgr.purge_staging()
    assert not os.path.isdir(mgr.staging_dir(9, generation=2))


def test_controller_reads_config_knobs(tmp_path):
    from ray_tpu_torch.train._checkpoint import CheckpointManager
    from ray_tpu_torch.train._controller import TrainController
    from ray_tpu_torch.train._policies import FixedScalingPolicy

    GLOBAL_CONFIG.apply_system_config({
        "train_max_drain_rejoins": 3,
        "train_expected_death_fresh_s": 45.0,
    })
    c = TrainController(
        train_fn=lambda: None, train_config=None,
        scaling_policy=FixedScalingPolicy(1),
        failure_policy=FailurePolicy(0),
        resources_per_worker={"CPU": 1}, run_name="knobs",
        storage_path=str(tmp_path),
        checkpoint_manager=CheckpointManager(str(tmp_path), "knobs"),
    )
    assert c.max_drain_rejoins == 3
    assert float(GLOBAL_CONFIG.get("train_expected_death_fresh_s")) == 45.0


# ---------------------------------------------------------------------------
# generation-scoped barriers + client round-trip (real actors / object plane)
# ---------------------------------------------------------------------------


@pytest.fixture
def ray_init():
    # function-scoped (unlike most suites): the chaos soak below stands up
    # its own multi-node cluster and must not inherit a live session
    info = rt.init(num_cpus=4)
    yield info
    rt.shutdown()


def test_sync_actor_generation_scoping(ray_init):
    from ray_tpu_torch.train._worker_group import SyncActor

    sa = SyncActor.remote()
    # a generation-0 barrier completes normally
    refs = [sa.barrier.remote("b", 2, 0), sa.barrier.remote("b", 2, 0)]
    assert rt.get(refs, timeout=60) == [True, True]
    # park a waiter, then advance the generation: the straggler must wake
    # and FAIL, not hang (its gang will never complete that barrier)
    waiter = sa.barrier.remote("late", 2, 0)
    time.sleep(0.3)
    assert rt.get(sa.advance_generation.remote(1), timeout=60)
    with pytest.raises(Exception, match="stale"):
        rt.get(waiter, timeout=60)
    # stale-generation calls fail fast instead of poisoning the new round
    with pytest.raises(Exception, match="stale"):
        rt.get(sa.barrier.remote("b2", 1, 0), timeout=60)
    assert rt.get(sa.barrier.remote("b2", 1, 1), timeout=60)
    # rendezvous keys are scoped too
    assert rt.get(sa.put.remote("k", "v1", 1), timeout=60)
    assert rt.get(sa.wait_for.remote("k", 0.01, 1), timeout=60) == "v1"
    with pytest.raises(Exception, match="stale"):
        rt.get(sa.put.remote("k", "v0", 0), timeout=60)
    rt.kill(sa)


def _mk_ctx(rank, world):
    from ray_tpu_torch.train._context import TrainContext

    ctx = TrainContext(
        rank=rank, world_size=world, local_rank=0, node_rank=rank,
        run_name="rt", storage_path="/tmp", staging_dir_fn=lambda s: "/tmp")
    ctx.elastic = ElasticClient(ctx)
    return ctx


def test_elastic_client_shrink_payload_roundtrip(ray_init):
    """Full worker-side protocol in-process: two ranks park and publish,
    the 'controller' plans, rank 0 absorbs rank 1's shards through the
    object plane, rank 1 retires. Values round-trip exactly and rank/world
    renumber."""
    ctx0, ctx1 = _mk_ctx(0, 2), _mk_ctx(1, 2)
    c0, c1 = ctx0.elastic, ctx1.elastic
    shards0 = {0: np.arange(64.0), 2: np.full(8, 2.0)}
    shards1 = {1: np.arange(32.0) * 3, 3: np.full(8, 3.0)}
    it0 = ElasticDataIterator(20, 2, seed=1, rank=0, world=2)
    it1 = ElasticDataIterator(20, 2, seed=1, rank=1, world=2)
    assert c0.prepare(1) and c1.prepare(1)
    out = {}

    def run(tag, client, model, shards, it):
        out[tag] = client.sync(model=model, shards=shards, iterator=it,
                               park_timeout_s=60)

    t0 = threading.Thread(target=run,
                          args=("r0", c0, {"w": 1.0}, shards0, it0))
    t1 = threading.Thread(target=run,
                          args=("r1", c1, {"w": 1.0}, shards1, it1))
    t0.start(), t1.start()
    deadline = time.time() + 30
    while time.time() < deadline:
        s0, s1 = c0.status(), c1.status()
        if s0["parked"] and s1["parked"]:
            break
        time.sleep(0.02)
    assert s0["parked"] and s1["parked"]
    assert s0["manifest"] == [0, 2] and s1["manifest"] == [1, 3]

    rank_map = {0: 0}
    shard_plan = plan_shards({0: s0["manifest"], 1: s1["manifest"]},
                             rank_map, 1)
    iter_plan = plan_iterator({0: s0["iter"], 1: s1["iter"]}, rank_map, 1)
    spec = {
        "generation": 1, "rank": 0, "world": 1,
        "shards": [[k, None if rank_map.get(src) == 0
                    else s1["shard_refs"][k]]
                   for k, src in shard_plan[0]],
        "iter": iter_plan[0], "model_ref": None,
    }
    assert c0.commit(spec)
    t0.join(timeout=60)
    assert not t0.is_alive() and c0.done()
    assert c1.release()
    t1.join(timeout=60)
    assert not t1.is_alive()

    r0, r1 = out["r0"], out["r1"]
    assert r1.retired and not r1.resized
    assert r0.resized and r0.rank == 0 and r0.world == 1
    assert r0.generation == 1 and ctx0.generation == 1
    assert sorted(r0.shards) == [0, 1, 2, 3]
    np.testing.assert_array_equal(r0.shards[1], shards1[1])
    np.testing.assert_array_equal(r0.shards[3], shards1[3])
    # retention: rank 0's own shards did not round-trip through the store
    assert r0.shards[0] is shards0[0]
    assert c0.stats["shards_moved"] == 2
    # iterator pool preserved exactly: r0 now owns every remaining sample
    assert (sorted(r0.iterator.state()["samples"])
            == sorted(s0["iter"]["samples"] + s1["iter"]["samples"]))


# ---------------------------------------------------------------------------
# chaos soak: preempt -> live shrink -> regrow, mid-training
# ---------------------------------------------------------------------------

_CHAOS = {
    "testing_event_loop_delay_us": "*:500:8000",
    "health_check_period_s": 0.25,
    "health_check_timeout_s": 2.0,
    "train_node_watch_period_s": 0.25,
    "train_regrow_cooldown_s": 0.5,
    "train_resize_park_timeout_s": 30.0,
}


def _make_elastic_train_fn():
    """Built through a factory so cloudpickle serializes the train fn BY
    VALUE (a module-level function in a test file pickles by reference,
    which workers cannot import)."""

    def _elastic_train_fn(config):
        """Strongly convex toy: per-step loss decreases monotonically IFF
        the model state survives every resize (a restore from an older
        checkpoint would bounce the loss back up — the continuity
        assertion below)."""
        import os
        import time

        import torch

        from ray_tpu_torch import train

        ctx = train.get_context()
        elastic = ctx.elastic

        def init_model():
            return {"w": float(config["w0"])}

        def init_shards(keys):
            return {k: torch.full((config["shard_elems"],), float(k))
                    for k in keys}

        model, shards, it = elastic.init_or_join(
            init_model=init_model, init_shards=init_shards,
            shard_keys=list(range(config["num_shards"])),
            iterator=dict(num_samples=config["num_samples"],
                          batch_size=config["batch_size"],
                          seed=config["seed"]),
        )
        pid = os.getpid()
        while True:
            batch = it.next_batch()
            if batch is None:
                break
            model["w"] = model["w"] - 0.2 * (model["w"] - 1.0)
            loss = float((model["w"] - 1.0) ** 2)
            train.report({
                "pid": pid, "step": it.batches, "epoch": it.epoch,
                "rank": ctx.get_world_rank(), "world": ctx.get_world_size(),
                "gen": ctx.get_generation(), "loss": loss,
                "samples": list(batch),
                "moved": elastic.stats["shards_moved"],
                "shard_keys": sorted(shards),
                # every shard a tensor holding its own key, moved or not
                "shards_ok": all(
                    torch.is_tensor(v) and bool((v == float(k)).all())
                    for k, v in shards.items()),
            })
            if it.batches == 3 and ctx.get_generation() == 0:
                open(os.path.join(
                    config["mark_dir"],
                    f"started_{ctx.get_world_rank()}"), "w").close()
            time.sleep(config["step_s"])
            out = elastic.sync(model=model, shards=shards, iterator=it)
            if out.retired:
                return
            if out.resized:
                model, shards, it = out.model, out.shards, out.iterator

    return _elastic_train_fn


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_preempt_shrink_regrow_mid_training(seed, tmp_path):
    """Preemption notice mid-run: the controller live-SHRINKS the gang
    (no teardown, failure budget AND drain-rejoin budget untouched), then
    live-REGROWS when replacement capacity registers. Exact batch
    coverage and loss-curve continuity hold across both resizes."""
    from ray_tpu_torch._private import protocol as pb
    from ray_tpu_torch._private.core_worker import get_core_worker
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.train import (DataParallelTrainer, FailureConfig,
                                     RunConfig, ScalingConfig)

    cfg = dict(_CHAOS)
    cfg["testing_chaos_seed"] = seed
    GLOBAL_CONFIG.apply_system_config(cfg)
    cluster = Cluster(initialize_head=True, head_resources={"CPU": 4})
    mark_dir = str(tmp_path / "marks")
    os.makedirs(mark_dir)
    try:
        spots = [cluster.add_node(resources={"CPU": 4, "spot": 2}),
                 cluster.add_node(resources={"CPU": 4, "spot": 2})]
        rt.init(address=cluster.address)
        cw = get_core_worker()

        num_samples, batch = 2400, 5
        trainer = DataParallelTrainer(
            _make_elastic_train_fn(),
            train_loop_config={
                "w0": 10.0, "num_shards": 8, "shard_elems": 1024,
                "num_samples": num_samples, "batch_size": batch,
                "seed": seed, "step_s": 0.08, "mark_dir": mark_dir,
            },
            scaling_config=ScalingConfig(
                num_workers=4, elastic_min_workers=2,
                resources_per_worker={"spot": 1}),
            run_config=RunConfig(
                name="elastic_soak", storage_path=str(tmp_path),
                failure_config=FailureConfig(max_failures=0)),
        )
        controller = trainer._controller()
        result_box = {}

        def fit():
            result_box["result"] = controller.run()

        t = threading.Thread(target=fit)
        t.start()
        try:
            # 1. wait for real training progress (>= 2 ranks past step 3)
            deadline = time.time() + 120
            while (time.time() < deadline and t.is_alive()
                   and len(os.listdir(mark_dir)) < 2):
                time.sleep(0.1)
            assert len(os.listdir(mark_dir)) >= 2, (
                "training never progressed: "
                f"{result_box.get('result') and result_box['result'].error}")

            # 2. preempt one spot node — but not the one hosting the
            #    rendezvous actor (planned migration would recreate it and
            #    reset generations; a real deployment pins it to the head)
            actors = cw.run_sync(cw.control.call("list_actors", {}), 30)["actors"]
            sync_nodes = {a["node_id"].hex() for a in actors
                          if a.get("name") and "-sync-" in a["name"]
                          and a["node_id"]}
            victim = next(s for s in spots if s.node_id not in sync_nodes)

            assert cw.run_sync(cw.control.call("drain_node", {
                "node_id": bytes.fromhex(victim.node_id),
                "reason": pb.DRAIN_REASON_PREEMPTION,
                "deadline_s": 30.0}, timeout=30), timeout=30)["ok"]

            # 3. the controller must live-shrink inside the drain window
            deadline = time.time() + 90
            while (time.time() < deadline and t.is_alive()
                   and controller.shrinks < 1):
                time.sleep(0.1)
            assert controller.shrinks >= 1, (
                "live shrink never happened: "
                f"{result_box.get('result') and result_box['result'].error}")

            # 4. capacity returns -> regrow (triggered by the node-table
            #    "nodes" pubsub registration notice)
            cluster.add_node(resources={"CPU": 4, "spot": 2})
            deadline = time.time() + 90
            while (time.time() < deadline and t.is_alive()
                   and controller.regrows < 1):
                time.sleep(0.1)
            assert controller.regrows >= 1, (
                "regrow never happened: "
                f"{result_box.get('result') and result_box['result'].error}")
        finally:
            t.join(timeout=240)
        assert not t.is_alive(), "training run never finished"
        result = result_box["result"]

        # zero failure-budget charges, zero teardown rejoins: the whole
        # cycle rode the live-resize path
        assert result.error is None, result.error
        assert controller.failure_count == 0
        assert controller.drain_rejoins == 0
        assert controller.shrinks >= 1 and controller.regrows >= 1

        hist = [m for m in result.metrics_history if "samples" in m]
        assert all(m["shards_ok"] for m in hist)
        worlds = {m["world"] for m in hist}
        assert {4, 2} <= worlds, f"expected both widths, saw {worlds}"
        assert max(m["gen"] for m in hist) >= 2

        # exact batch coverage: every sample of the epoch consumed exactly
        # once across all ranks, generations, and retired workers
        consumed = sorted(s for m in hist if m["epoch"] == 0
                          for s in m["samples"])
        assert consumed == list(range(num_samples)), (
            f"coverage broken: {len(consumed)} consumed, "
            f"{len(set(consumed))} unique")

        # loss-curve continuity: each worker process's loss is monotone
        # non-increasing (the model state survived its resizes), and
        # joiners start from live state, not from scratch
        by_pid = {}
        for m in hist:
            by_pid.setdefault(m["pid"], []).append(m)
        init_loss = (10.0 - 1.0) ** 2
        for pid, ms in by_pid.items():
            losses = [m["loss"] for m in ms]
            assert all(b <= a + 1e-9 for a, b in zip(losses, losses[1:])), (
                f"loss bounced for pid {pid}")
        joiner_first = [ms[0]["loss"] for ms in by_pid.values()
                        if ms[0]["gen"] >= 2]
        assert joiner_first, "no joiner ever reported"
        assert max(joiner_first) < init_loss * 0.64 ** 3, (
            "joiner restarted from scratch instead of absorbing live state")

        # re-shard accounting: every rank always holds a balanced slice of
        # the 8 shards, and the union is complete after every resize
        for m in hist:
            assert 8 // m["world"] <= len(m["shard_keys"]) <= -(-8 // m["world"]) \
                or m["world"] not in (2, 4)
        final_gen = max(m["gen"] for m in hist)
        final = {}
        for m in hist:
            if m["gen"] == final_gen:
                final[m["rank"]] = m["shard_keys"]
        union = sorted(k for keys in final.values() for k in keys)
        assert union == list(range(8)), f"shard union broken: {final}"
    finally:
        try:
            rt.shutdown()
        except Exception:  # noqa: BLE001
            pass
        cluster.shutdown()


# ---------------------------------------------------------------------------
# rendezvous SyncActor pinned off spot/preemptible capacity (PR-5 follow-up)
# ---------------------------------------------------------------------------


def test_sync_actor_placement_selector_unit(monkeypatch):
    """Placement resolution: anti-spot selector when mixed capacity
    exists; unconstrained fallback when EVERY usable node is spot (an
    all-spot cluster must still train); control-store outage -> no
    constraint rather than no actor."""
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.train._worker_group import WorkerGroup

    def fake_nodes(nodes):
        return lambda: nodes

    mixed = [
        {"state": "ALIVE", "drain_reason": "", "labels": {}},
        {"state": "ALIVE", "drain_reason": "", "labels": {"spot": "true"}},
    ]
    monkeypatch.setattr(worker_mod, "nodes", fake_nodes(mixed))
    assert WorkerGroup._sync_actor_placement() == {
        "label_selector": {"spot": "!true", "preemptible": "!true"}}

    all_spot = [
        {"state": "ALIVE", "drain_reason": "", "labels": {"spot": "true"}},
        {"state": "ALIVE", "drain_reason": "",
         "labels": {"preemptible": "true"}},
    ]
    monkeypatch.setattr(worker_mod, "nodes", fake_nodes(all_spot))
    assert WorkerGroup._sync_actor_placement() == {}

    # a draining non-spot node does not count as usable anti-spot capacity
    draining_mix = [
        {"state": "ALIVE", "drain_reason": "preemption", "labels": {}},
        {"state": "ALIVE", "drain_reason": "", "labels": {"spot": "true"}},
    ]
    monkeypatch.setattr(worker_mod, "nodes", fake_nodes(draining_mix))
    assert WorkerGroup._sync_actor_placement() == {}

    def boom():
        raise RuntimeError("control store down")

    monkeypatch.setattr(worker_mod, "nodes", boom)
    assert WorkerGroup._sync_actor_placement() == {}


def test_sync_actor_pinned_off_spot_nodes(tmp_path):
    """Regression (ROADMAP PR-5 follow-up): the rendezvous SyncActor must
    not ride spot capacity — a reclaimed spot node would take the barrier
    actor down mid-resize. Nodes advertising the "spot" resource are
    label-marked by their daemon; the group's sync actor lands elsewhere
    while the (spot-constrained) workers land on the spot nodes."""
    from ray_tpu_torch._private.core_worker import get_core_worker
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.train._worker_group import SyncActor, WorkerGroup

    cluster = Cluster(initialize_head=True, head_resources={"CPU": 2})
    try:
        spot = cluster.add_node(resources={"CPU": 4, "spot": 2})
        rt.init(address=cluster.address)
        cw = get_core_worker()
        # the daemon normalized the "spot" resource into a spot=true label
        labels = {n["node_id"]: n["labels"] for n in rt.nodes()}
        assert labels[spot.node_id].get("spot") == "true"
        # the group's placement resolution picks the anti-spot selector...
        opts = WorkerGroup._sync_actor_placement()
        assert opts == {"label_selector": {"spot": "!true",
                                           "preemptible": "!true"}}
        # ...and the scheduler honors it: the actor lands off the spot node
        sa = SyncActor.options(name="pin-test-sync", namespace="_train",
                               **opts).remote()
        assert rt.get(sa.generation.remote(), timeout=60) == 0
        info = cw.run_sync(cw.control.call(
            "get_actor_info",
            {"actor_id": sa._actor_id.binary()}), 30)["actor"]
        sync_node = info["node_id"].hex()
        assert sync_node != spot.node_id, (
            "rendezvous SyncActor placed on spot capacity")
        assert sync_node == cluster.head_node.node_id
        rt.kill(sa)
    finally:
        try:
            rt.shutdown()
        except Exception:  # noqa: BLE001
            pass
        cluster.shutdown()


# ---------------------------------------------------------------------------
# restart at a new world size (test_elastic_restore.py)
# ---------------------------------------------------------------------------


class ShrinkingPolicy(ScalingPolicy):
    """First incarnation at 3 workers, every restart at 2 — the elastic
    restart-at-a-different-size path."""

    def __init__(self):
        self.sizes = [3, 2]

    def target_size(self, cluster_cpus, resources_per_worker):
        n = self.sizes.pop(0) if len(self.sizes) > 1 else self.sizes[0]
        return ScalingDecision(num_workers=n, reason="shrinking-test")


def test_coordinator_death_restarts_at_new_size(ray_init, tmp_path):
    """Kill the rank-0 (torch.distributed rendezvous) worker mid-step; the
    controller must re-create the WHOLE gang at a different size and resume
    from the consolidated checkpoint (SURVEY hard-part #4)."""
    from ray_tpu_torch.train._checkpoint import CheckpointManager
    from ray_tpu_torch.train._controller import TrainController

    marker = str(tmp_path / "coord_died")
    run_dir = str(tmp_path / "elastic_run")

    def train_fn(config):
        from ray_tpu_torch import train

        ctx = train.get_context()
        start = 0
        ckpt = ctx.get_checkpoint()
        if ckpt is not None:
            # consolidated: works regardless of the world size that saved it
            state = ckpt.load_consolidated({"w": np.zeros(2), "step": 0})
            start = int(state["step"]) + 1
        for step in range(start, 5):
            if (step == 2 and ctx.get_world_rank() == 0
                    and not os.path.exists(config["marker"])):
                deadline = time.time() + 60
                while time.time() < deadline and not any(
                    n.startswith("checkpoint_")
                    for n in os.listdir(config["run_dir"])
                ):
                    time.sleep(0.1)
                open(config["marker"], "w").close()
                os._exit(1)  # coordinator hard-death mid-step
            train.report(
                {"step": step, "world": ctx.get_world_size(),
                 "resumed_from": start},
                checkpoint_state={"w": np.ones(2) * step, "step": step},
            )

    mgr = CheckpointManager(str(tmp_path), "elastic_run", num_to_keep=2)
    os.makedirs(run_dir, exist_ok=True)
    controller = TrainController(
        train_fn=train_fn,
        train_config={"marker": marker, "run_dir": mgr.run_dir},
        scaling_policy=ShrinkingPolicy(),
        failure_policy=FailurePolicy(max_failures=2),
        resources_per_worker={"CPU": 1},
        run_name="elastic_run",
        storage_path=str(tmp_path),
        checkpoint_manager=mgr,
    )
    result = controller.run()
    assert result.error is None, result.error
    assert os.path.exists(marker), "coordinator never died"
    worlds = {m.get("world") for m in result.metrics_history if "world" in m}
    assert worlds == {3, 2}, f"expected both gang sizes, saw {worlds}"
    # the 2-worker incarnation resumed from the 3-worker checkpoint
    resumed = [m for m in result.metrics_history
               if m.get("world") == 2 and m.get("resumed_from", 0) > 0]
    assert resumed, "restarted gang did not resume from checkpoint"
    assert result.metrics["step"] == 4
