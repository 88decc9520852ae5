"""The port's tune (``ray_tpu_torch/tune``) against the JAX package's
``test_tune.py``. Tier 1: its five scheduler and search units, each on the
port, then the same seeded inputs through both packages' variant
generation, ASHA, median stopping, PBT and PB2, whose decisions (and PBT's
and PB2's proposed configs) must be identical, not just close; and its
grid-search ``fit`` on a port cluster whose trials each lease half a GPU
(``trial_resources={"GPU": 0.5}``). The rest of ``test_tune.py`` is
``mid`` in JAX and is mirrored ``mid`` here. The runtime imports no torch,
so these run in the pytest worker.
"""

import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import tune
from ray_tpu_torch._private import chaos
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch.tune._scheduler import CONTINUE, STOP, ASHAScheduler
from ray_tpu_torch.tune._search import generate_variants
from ray_tpu_torch.util.metrics import reset_registry


@pytest.fixture(autouse=True)
def _reset_port_config():
    """The conftest fixture resets the JAX package's registries; this one
    resets the port's."""
    yield
    GLOBAL_CONFIG.reset()
    chaos.reset()
    reset_registry()


@pytest.fixture(scope="module")
def ray_init():
    # one fake GPU: the trials of the grid-search fit lease half of it each
    info = rt.init(num_cpus=8, resources={"GPU": 1})
    yield info
    rt.shutdown()


# ---------------------------------------------------------------------------
# the units of test_tune.py, on the port
# ---------------------------------------------------------------------------


def test_variant_generation():
    space = {
        "a": tune.grid_search([1, 2, 3]),
        "b": tune.grid_search(["x", "y"]),
        "c": tune.uniform(0.0, 1.0),
        "d": 42,
    }
    variants = list(generate_variants(space, num_samples=2, seed=0))
    assert len(variants) == 12  # 3 * 2 grid, twice
    assert all(v["d"] == 42 for v in variants)
    assert all(0.0 <= v["c"] <= 1.0 for v in variants)
    assert {(v["a"], v["b"]) for v in variants} == {
        (a, b) for a in (1, 2, 3) for b in ("x", "y")
    }



def test_asha_stops_bad_trials():
    sched = ASHAScheduler(metric="loss", mode="min", max_t=16,
                          grace_period=2, reduction_factor=2)
    assert sched.milestones == [2, 4, 8]
    # good trial cruises through rungs
    assert sched.on_result("good", {"training_iteration": 2, "loss": 0.1}) == CONTINUE
    # bad trial at the same rung with a worse metric gets cut
    assert sched.on_result("bad", {"training_iteration": 2, "loss": 9.0}) == STOP
    # completion at max_t stops
    assert sched.on_result("good", {"training_iteration": 16, "loss": 0.05}) == STOP



def test_pbt_scheduler_unit():
    from ray_tpu_torch.tune._scheduler import EXPLOIT, PopulationBasedTraining

    pbt = PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=2,
        hyperparam_mutations={"lr": (0.001, 0.1)}, seed=7,
    )
    pbt.register("good", {"lr": 0.05})
    pbt.register("bad", {"lr": 0.002})
    # build up scores: good high, bad low
    assert pbt.on_result("good", {"training_iteration": 2, "score": 10.0}) == CONTINUE
    out = pbt.on_result("bad", {"training_iteration": 2, "score": 1.0})
    assert out == EXPLOIT
    decision = pbt.take_exploit("bad")
    assert decision["donor"] == "good"
    assert 0.001 <= decision["config"]["lr"] <= 0.1



def test_pb2_scheduler_unit():
    """PB2 unit: with history showing high-lr trials improving faster, the
    UCB proposal lands in the high region."""
    from ray_tpu_torch.tune._scheduler import PB2

    pb2 = PB2(metric="acc", mode="max", perturbation_interval=1,
              hyperparam_bounds={"lr": (0.0, 1.0)}, seed=0)
    # synthetic history: reward delta equals lr
    for step in range(1, 4):
        for tid, lr in (("a", 0.1), ("b", 0.5), ("c", 0.9)):
            pb2.register(tid, {"lr": lr})
            pb2._configs[tid] = {"lr": lr}
            pb2.on_result(tid, {"training_iteration": step,
                                "acc": step * lr})
    proposals = [pb2._explore({"lr": 0.1})["lr"] for _ in range(8)]
    assert sum(p > 0.5 for p in proposals) >= 6, proposals



def test_median_stopping_rule_unit():
    """MedianStoppingRule: a trial whose best result is below the median
    of the other trials' running means stops after the grace period."""
    from ray_tpu_torch.tune._scheduler import CONTINUE, STOP, MedianStoppingRule

    rule = MedianStoppingRule(metric="acc", mode="max", grace_period=2,
                              min_samples_required=3)
    # three healthy trials improving steadily
    for step in range(1, 5):
        for tid, slope in (("a", 1.0), ("b", 0.9), ("c", 0.8)):
            assert rule.on_result(
                tid, {"training_iteration": step, "acc": slope * step}
            ) == CONTINUE
    # a straggler far below the median: continues through grace, then stops
    assert rule.on_result("d", {"training_iteration": 1, "acc": 0.01}) \
        == CONTINUE
    assert rule.on_result("d", {"training_iteration": 3, "acc": 0.02}) \
        == STOP
    # a strong newcomer is kept
    assert rule.on_result("e", {"training_iteration": 3, "acc": 50.0}) \
        == CONTINUE


# ---------------------------------------------------------------------------
# parity: the same seeded inputs through both packages
# ---------------------------------------------------------------------------


def _spaces(pkg):
    t = pkg
    return [
        {"a": t.grid_search([1, 2, 3]), "b": t.grid_search(["x", "y"]),
         "c": t.uniform(0.0, 1.0), "d": 42},
        {"lr": t.loguniform(1e-5, 1e-1), "bs": t.choice([16, 32, 64]),
         "layers": t.randint(1, 9), "wd": t.uniform(0.0, 0.1)},
        {"lr": t.grid_search([1e-3, 1e-2]), "seed": t.randint(0, 1000)},
    ]


@pytest.mark.parametrize("seed", [0, 7, 1234])
@pytest.mark.parametrize("space", [0, 1, 2])
def test_generate_variants_parity(space, seed):
    from ray_tpu import tune as jtune
    from ray_tpu.tune._search import generate_variants as jax_variants

    got = list(generate_variants(_spaces(tune)[space], 5, seed=seed))
    want = list(jax_variants(_spaces(jtune)[space], 5, seed=seed))
    assert got == want


def _stream(seed, trials, steps):
    """Seeded (trial, training_iteration, value) results, interleaved as a
    controller would see them."""
    rng = np.random.RandomState(seed)
    out = []
    for t in range(1, steps + 1):
        for i in rng.permutation(trials):
            out.append((f"t{i}", t, float(rng.lognormal(0.0, 1.0) / t)))
    return out


def _decisions(sched, stream, metric="loss"):
    return [sched.on_result(tid, {"training_iteration": t, metric: v})
            for tid, t, v in stream]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("rf,grace,max_t", [(2, 1, 16), (3, 2, 20),
                                             (4, 1, 100)])
def test_asha_parity(seed, rf, grace, max_t):
    from ray_tpu.tune._scheduler import ASHAScheduler as JaxASHA

    kw = dict(metric="loss", mode="min", max_t=max_t, grace_period=grace,
              reduction_factor=rf)
    stream = _stream(seed, 12, 16)
    got = _decisions(ASHAScheduler(**kw), stream)
    want = _decisions(JaxASHA(**kw), stream)
    assert got == want and STOP in got


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["min", "max"])
def test_median_stopping_parity(seed, mode):
    from ray_tpu.tune._scheduler import MedianStoppingRule as JaxRule
    from ray_tpu_torch.tune._scheduler import MedianStoppingRule

    kw = dict(metric="loss", mode=mode, grace_period=2,
              min_samples_required=3)
    stream = _stream(seed, 8, 10)
    got = _decisions(MedianStoppingRule(**kw), stream)
    want = _decisions(JaxRule(**kw), stream)
    assert got == want and STOP in got


def _population(sched, stream, configs):
    """Drive a PBT-family scheduler as Tuner.fit does: register each
    trial, take every exploit it decides on. Returns the decisions and
    the exploits (donor and proposed config)."""
    for tid, cfg in configs.items():
        sched.register(tid, cfg)
    out = []
    for tid, t, v in stream:
        d = sched.on_result(tid, {"training_iteration": t, "score": v})
        out.append(d)
        if d == "EXPLOIT":
            out.append(sched.take_exploit(tid))
    return out


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_pbt_parity(seed):
    from ray_tpu.tune._scheduler import PopulationBasedTraining as JaxPBT
    from ray_tpu_torch.tune._scheduler import PopulationBasedTraining

    kw = dict(metric="score", mode="max", perturbation_interval=2,
              hyperparam_mutations={"lr": (1e-3, 1e-1),
                                    "bs": [16, 32, 64, 128]},
              quantile_fraction=0.25, resample_probability=0.25, seed=seed)
    rng = np.random.RandomState(seed)
    configs = {f"t{i}": {"lr": float(rng.uniform(1e-3, 1e-1)),
                         "bs": int(rng.choice([16, 32, 64, 128]))}
               for i in range(8)}
    stream = _stream(seed, 8, 12)
    got = _population(PopulationBasedTraining(**kw), stream, configs)
    want = _population(JaxPBT(**kw), stream, configs)
    assert got == want and "EXPLOIT" in got


@pytest.mark.parametrize("seed", [0, 5])
def test_pb2_parity(seed):
    from ray_tpu.tune._scheduler import PB2 as JaxPB2
    from ray_tpu_torch.tune._scheduler import PB2

    kw = dict(metric="score", mode="max", perturbation_interval=2,
              hyperparam_bounds={"lr": (1e-3, 1e-1), "wd": (0.0, 0.1)},
              quantile_fraction=0.25, seed=seed)
    rng = np.random.RandomState(seed)
    configs = {f"t{i}": {"lr": float(rng.uniform(1e-3, 1e-1)),
                         "wd": float(rng.uniform(0.0, 0.1))}
               for i in range(6)}
    stream = _stream(seed, 6, 10)
    got = _population(PB2(**kw), stream, configs)
    want = _population(JaxPB2(**kw), stream, configs)
    assert got == want and "EXPLOIT" in got


# ---------------------------------------------------------------------------
# on a port cluster
# ---------------------------------------------------------------------------


def test_grid_search_fit(ray_init):
    """As JAX's, with each trial on half of the GPU: two trials share it
    at a time, and the GPU is whole again when the fit returns."""

    def trainable(config):
        tune.report({"score": config["x"] ** 2})

    grid = tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([-3, -1, 2, 5])},
        # as many trials at once as the GPU holds: fit polls every trial
        # it launched, and a trial still waiting for its lease would hold
        # each poll for its whole timeout
        tune_config=tune.TuneConfig(metric="score", mode="min",
                                    max_concurrent_trials=2),
        trial_resources={"GPU": 0.5},
    )
    results = grid.fit(timeout=120)
    assert len(results) == 4
    assert results.num_errors == 0
    best = results.get_best_result()
    assert best.config["x"] == -1
    assert best.metrics["score"] == 1
    deadline = time.monotonic() + 30
    while (rt.available_resources().get("GPU") != 1.0
           and time.monotonic() < deadline):
        time.sleep(0.1)
    assert rt.available_resources().get("GPU") == 1.0


@pytest.mark.mid
def test_random_search_and_max_concurrency(ray_init):
    def trainable(config):
        for i in range(3):
            tune.report({"loss": config["lr"] * (3 - i)})

    tuner = tune.Tuner(
        trainable,
        param_space={"lr": tune.loguniform(1e-4, 1e-1)},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", num_samples=6,
            max_concurrent_trials=2, seed=7,
        ),
    )
    results = tuner.fit(timeout=180)
    assert len(results) == 6
    assert results.num_errors == 0
    best = results.get_best_result()
    # best = smallest sampled lr (loss is monotonic in lr)
    assert best.metrics["loss"] == min(
        r.metrics["loss"] for r in results if r.metrics
    )
    # every trial ran to completion: 3 reports each
    assert all(len(r.history) == 3 for r in results)


@pytest.mark.mid
def test_asha_early_stops_in_fit(ray_init):
    def trainable(config):
        import time as t

        for i in range(1, 9):
            # bad configs plateau high; good configs descend. The sleep
            # keeps iterations slower than the controller's poll cadence so
            # cooperative stops can land mid-trial.
            t.sleep(0.15)
            loss = config["base"] / i if config["good"] else config["base"]
            tune.report({"loss": loss, "training_iteration": i})

    tuner = tune.Tuner(
        trainable,
        param_space={
            "base": tune.grid_search([1.0, 10.0, 100.0, 1000.0]),
            "good": tune.grid_search([True, False]),
        },
        tune_config=tune.TuneConfig(
            metric="loss", mode="min",
            scheduler=tune.ASHAScheduler(
                max_t=8, grace_period=2, reduction_factor=2),
            max_concurrent_trials=4,
        ),
    )
    results = tuner.fit(timeout=180)
    assert len(results) == 8
    stopped = [r for r in results if r.status == "STOPPED"]
    assert stopped, "ASHA never early-stopped anything"
    best = results.get_best_result()
    assert best.config == {"base": 1.0, "good": True}


@pytest.mark.mid
def test_trial_error_is_isolated(ray_init):
    def trainable(config):
        if config["x"] == 1:
            raise ValueError("boom")
        tune.report({"score": config["x"]})

    tuner = tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([0, 1, 2])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
    )
    results = tuner.fit(timeout=120)
    assert results.num_errors == 1
    errored = [r for r in results if r.status == "ERRORED"][0]
    assert "boom" in errored.error
    assert results.get_best_result().config["x"] == 2


@pytest.mark.mid
def test_checkpoints_recorded(ray_init):
    def trainable(config):
        for i in range(2):
            tune.report({"loss": 1.0 / (i + 1)}, checkpoint={"step": i})

    tuner = tune.Tuner(
        trainable,
        param_space={},
        tune_config=tune.TuneConfig(metric="loss", mode="min"),
    )
    results = tuner.fit(timeout=120)
    assert len(results) == 1
    ckpts = results[0].checkpoints
    assert [c["data"]["step"] for c in ckpts] == [0, 1]


@pytest.mark.mid
def test_pbt_exploit_in_fit(ray_init):
    """Bottom trial copies a top trial's checkpoint+config and continues
    from the donor's progress."""
    def trainable(config):
        start = tune.get_checkpoint() or {"acc": 0.0}
        acc = start["acc"]
        for _ in range(12):
            import time as t

            acc += config["lr"]
            tune.report({"acc": acc}, checkpoint={"acc": acc})
            t.sleep(0.05)

    pbt = tune.PopulationBasedTraining(
        metric="acc", mode="max", perturbation_interval=3,
        hyperparam_mutations={"lr": (0.01, 1.0)},
        quantile_fraction=0.5, seed=3,
    )
    grid = tune.Tuner(
        trainable,
        param_space={"lr": tune.grid_search([0.01, 1.0])},
        tune_config=tune.TuneConfig(metric="acc", mode="max", scheduler=pbt),
    ).fit(timeout=120)
    best = grid.get_best_result()
    # the weak trial (lr=0.01 alone would reach ~0.12) must have been
    # rescued by exploiting the strong one
    accs = sorted(r.metrics.get("acc", 0.0) for r in grid)
    assert accs[0] > 0.5, f"bottom trial never exploited: {accs}"
    assert best.metrics["acc"] > 5.0


@pytest.mark.mid
def test_pb2_learns_good_region(ray_init):
    """PB2 (reference: tune/schedulers/pb2.py): the GP-bandit explore must
    steer exploited trials toward the rewarding hyperparameter region —
    the weak trial gets rescued and the proposed configs respect bounds."""

    def trainable(config):
        from ray_tpu_torch import tune

        acc = 0.0
        for _ in range(12):
            import time as t

            # reward increases with lr in-bounds (peak at 1.0)
            acc += config["lr"]
            tune.report({"acc": acc}, checkpoint={"acc": acc})
            t.sleep(0.05)

    pb2 = tune.PB2(
        metric="acc", mode="max", perturbation_interval=3,
        hyperparam_bounds={"lr": (0.01, 1.0)},
        quantile_fraction=0.5, seed=3,
    )
    grid = tune.Tuner(
        trainable,
        param_space={"lr": tune.grid_search([0.01, 0.9])},
        tune_config=tune.TuneConfig(metric="acc", mode="max", scheduler=pb2),
    ).fit(timeout=120)
    best = grid.get_best_result()
    accs = sorted(r.metrics.get("acc", 0.0) for r in grid)
    assert accs[0] > 0.5, f"bottom trial never exploited: {accs}"
    assert best.metrics["acc"] > 5.0
    # every GP-proposed config stayed in bounds
    for cfg in pb2._configs.values():
        assert 0.01 <= cfg["lr"] <= 1.0
