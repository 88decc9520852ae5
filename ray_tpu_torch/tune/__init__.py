"""ray_tpu_torch.tune — hyperparameter search over trial actors.

The port's counterpart of ``ray_tpu/tune``: the same controller, trial
actors, schedulers and variant generation, whose random draws use Python's
``random`` seeded as there, so a seed gives the same variants and the same
scheduler decisions in both packages. ``trial_resources={"GPU": f}`` places
each trial actor on a card through the runtime's fractional GPU leases, so
1 / f trials share one card; the trainable then runs its torch work there.

Reference surface: python/ray/tune/tuner.py:43 (Tuner.fit), tune_config.py
(TuneConfig), execution/tune_controller.py:72 (trial lifecycle loop),
schedulers/async_hyperband.py (ASHA), search/basic_variant.py (grid/random
variants), result_grid.py (ResultGrid/get_best_result).

Original architecture: the controller is a driver-side polling loop (the
reference's TuneController also runs in the driver process); each trial is
an actor running the trainable on its executor thread, reporting through a
drained buffer; schedulers see every result and stop trials cooperatively.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.tune._scheduler import (
    CONTINUE,
    EXPLOIT,
    PB2,
    STOP,
    ASHAScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
)
from ray_tpu_torch.tune._search import (
    choice,
    generate_variants,
    grid_search,
    loguniform,
    randint,
    uniform,
)
from ray_tpu_torch.tune._session import get_checkpoint
from ray_tpu_torch.tune._trial import TrialActor, report


@dataclass
class TuneConfig:
    """Reference: python/ray/tune/tune_config.py:15."""

    metric: Optional[str] = None
    mode: str = "min"
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    scheduler: Optional[Any] = None
    seed: Optional[int] = None


@dataclass
class Result:
    """One finished trial (reference: ray.tune ResultGrid rows)."""

    trial_id: str
    config: Dict[str, Any]
    metrics: Dict[str, Any] = field(default_factory=dict)
    history: List[Dict[str, Any]] = field(default_factory=list)
    status: str = "PENDING"
    error: str = ""
    checkpoints: List[dict] = field(default_factory=list)


class ResultGrid:
    def __init__(self, results: List[Result], metric: Optional[str], mode: str):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __iter__(self):
        return iter(self._results)

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i):
        return self._results[i]

    @property
    def num_errors(self) -> int:
        return sum(1 for r in self._results if r.status == "ERRORED")

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("metric required (set TuneConfig.metric)")
        sign = 1.0 if mode == "min" else -1.0
        scored = [
            r for r in self._results
            if r.status in ("TERMINATED", "STOPPED") and metric in r.metrics
        ]
        if not scored:
            raise RuntimeError("no completed trial reported the metric")
        return min(scored, key=lambda r: sign * r.metrics[metric])

    def get_dataframe(self):
        rows = [{"trial_id": r.trial_id, **r.config, **r.metrics}
                for r in self._results]
        try:
            import pandas as pd

            return pd.DataFrame(rows)
        except ImportError:  # pragma: no cover
            return rows


@dataclass
class RunConfig:
    """Experiment persistence config (reference: air.RunConfig): with a
    storage_path, Tuner.fit writes the experiment state (per-trial configs,
    final metrics, histories, status) through the StorageContext — local
    dirs or any fsspec URI (memory://, gs://, s3://...)."""

    name: str = "tune_run"
    storage_path: Optional[str] = None


class Tuner:
    """Reference: python/ray/tune/tuner.py:43."""

    def __init__(self, trainable: Callable[[dict], None], *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 trial_resources: Optional[Dict[str, float]] = None):
        self._trainable = trainable
        self._param_space = dict(param_space or {})
        self._cfg = tune_config or TuneConfig()
        self._run_config = run_config
        self._trial_resources = trial_resources

    @staticmethod
    def restore_results(storage_path: str, name: str = "tune_run") \
            -> "ResultGrid":
        """Rebuild a ResultGrid from a persisted experiment state."""
        from ray_tpu_torch.train._storage import get_storage

        storage = get_storage(storage_path)
        state = storage.read_json(
            storage.join(storage_path, name, "experiment_state.json"))
        results = []
        for t in state["trials"]:
            r = Result(trial_id=t["trial_id"], config=t["config"])
            r.metrics = t.get("metrics")
            r.history = t.get("history", [])
            r.status = t.get("status", "TERMINATED")
            r.error = t.get("error")
            results.append(r)
        return ResultGrid(results, state.get("metric"), state.get("mode"))

    def _persist(self, results: List["Result"]):
        rc = self._run_config
        if rc is None or not rc.storage_path:
            return
        from ray_tpu_torch.train._storage import get_storage

        storage = get_storage(rc.storage_path)
        run_dir = storage.join(rc.storage_path, rc.name)
        storage.makedirs(run_dir)
        storage.write_json(
            storage.join(run_dir, "experiment_state.json"),
            {
                "metric": self._cfg.metric,
                "mode": self._cfg.mode,
                "trials": [
                    {"trial_id": r.trial_id, "config": r.config,
                     "metrics": r.metrics, "history": r.history,
                     "status": r.status, "error": r.error}
                    for r in results
                ],
            })

    def fit(self, poll_interval: float = 0.1, timeout: float = 600.0) -> ResultGrid:
        import cloudpickle

        cfg = self._cfg
        scheduler = cfg.scheduler or FIFOScheduler()
        # any scheduler exposing metric/mode inherits the TuneConfig's for
        # fields the user left UNSET — an explicitly-passed scheduler mode
        # must never be clobbered by TuneConfig's default
        if getattr(scheduler, "metric", "absent") is None:
            scheduler.metric = cfg.metric
        if getattr(scheduler, "mode", "absent") is None:
            scheduler.mode = cfg.mode
        variants = list(generate_variants(
            self._param_space, cfg.num_samples, seed=cfg.seed))
        results = [
            Result(trial_id=f"trial_{i:05d}", config=v)
            for i, v in enumerate(variants)
        ]
        fn_blob = cloudpickle.dumps(self._trainable)
        limit = cfg.max_concurrent_trials or len(results)
        pending = list(range(len(results)))
        running: Dict[int, Any] = {}  # result idx -> actor handle
        deadline = time.monotonic() + timeout

        def launch():
            while pending and len(running) < limit:
                i = pending.pop(0)
                opts = {}
                if self._trial_resources:
                    opts["resources"] = dict(self._trial_resources)
                actor = TrialActor.options(**opts).remote(
                    fn_blob, results[i].config)
                running[i] = actor
                results[i].status = "RUNNING"
                if hasattr(scheduler, "register"):
                    scheduler.register(results[i].trial_id, results[i].config)

        trial_index = {r.trial_id: i for i, r in enumerate(results)}

        def exploit(i: int, actor) -> Any:
            """PBT: stop the trial, copy a donor's checkpoint + mutated
            config, and relaunch it mid-run (reference: pbt.py _exploit)."""
            r = results[i]
            decision = scheduler.take_exploit(r.trial_id)
            if decision is None:
                return actor
            donor_i = trial_index.get(decision["donor"])
            checkpoint = None
            donor_actor = running.get(donor_i)
            try:
                if donor_actor is not None:
                    cps = ray_tpu_torch.get(
                        donor_actor.get_checkpoints.remote(), timeout=30)
                elif donor_i is not None:
                    cps = results[donor_i].checkpoints
                else:
                    cps = []
                if cps:
                    checkpoint = cps[-1]["data"]
            except Exception:  # noqa: BLE001 — donor died; explore only
                pass
            try:
                ray_tpu_torch.get(actor.stop.remote(), timeout=30)
            except Exception:  # noqa: BLE001
                pass
            ray_tpu_torch.kill(actor)
            r.config = dict(decision["config"])
            opts = {}
            if self._trial_resources:
                opts["resources"] = dict(self._trial_resources)
            last_t = (r.metrics or {}).get("training_iteration", 0)
            replacement = TrialActor.options(**opts).remote(
                fn_blob, r.config, checkpoint, last_t)
            running[i] = replacement
            return replacement

        launch()
        while running:
            if time.monotonic() > deadline:
                for i, actor in running.items():
                    ray_tpu_torch.kill(actor)
                    results[i].status = "ERRORED"
                    results[i].error = "tune run timeout"
                break
            time.sleep(poll_interval)
            for i, actor in list(running.items()):
                r = results[i]
                try:
                    polled = ray_tpu_torch.get(actor.poll.remote(), timeout=60)
                except Exception as e:  # noqa: BLE001 — actor died
                    r.status = "ERRORED"
                    r.error = f"trial actor died: {e}"
                    del running[i]
                    launch()
                    continue
                stop_now = False
                exploit_now = False
                for metrics in polled["results"]:
                    r.history.append(metrics)
                    r.metrics = metrics
                    decision = scheduler.on_result(r.trial_id, metrics)
                    if decision == STOP:
                        stop_now = True
                    elif decision == EXPLOIT:
                        exploit_now = True
                if exploit_now and polled["status"] == "RUNNING" and not stop_now:
                    actor = exploit(i, actor)
                    continue
                if stop_now and polled["status"] == "RUNNING":
                    try:
                        ray_tpu_torch.get(actor.stop.remote(), timeout=30)
                    except Exception:  # noqa: BLE001
                        pass
                if polled["status"] != "RUNNING" and not polled["results"]:
                    r.status = polled["status"]
                    r.error = polled["error"]
                    try:
                        r.checkpoints = ray_tpu_torch.get(
                            actor.get_checkpoints.remote(), timeout=30)
                    except Exception:  # noqa: BLE001
                        pass
                    ray_tpu_torch.kill(actor)
                    del running[i]
                    launch()
        self._persist(results)
        return ResultGrid(results, cfg.metric, cfg.mode)


__all__ = [
    "ASHAScheduler",
    "FIFOScheduler",
    "MedianStoppingRule",
    "PB2",
    "PopulationBasedTraining",
    "get_checkpoint",
    "Result",
    "ResultGrid",
    "RunConfig",
    "TuneConfig",
    "Tuner",
    "choice",
    "grid_search",
    "loguniform",
    "randint",
    "report",
    "uniform",
]

from ray_tpu_torch._private.usage import record_library_usage as _rlu

_rlu("tune")
del _rlu
