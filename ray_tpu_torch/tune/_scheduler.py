"""Trial schedulers: decide per-result whether a trial continues or stops.

Reference surface: python/ray/tune/schedulers/async_hyperband.py (ASHA) and
trial_scheduler.py (CONTINUE/STOP decisions). Original implementation of the
asynchronous-successive-halving rule: rungs at grace_period * rf^k; a trial
reaching a rung continues only if its metric is in the top 1/rf of results
recorded at that rung so far.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Optional, Union

CONTINUE = "CONTINUE"
STOP = "STOP"
EXPLOIT = "EXPLOIT"


class FIFOScheduler:
    """No early stopping (reference: trial_scheduler.py FIFOScheduler)."""

    def on_result(self, trial_id: str, metrics: dict) -> str:
        return CONTINUE


class ASHAScheduler:
    """Asynchronous successive halving (reference: async_hyperband.py:65)."""

    _default_mode = "min"

    def __init__(self, metric: str = None, mode: Optional[str] = None,
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: float = 4,
                 time_attr: str = "training_iteration"):
        assert max_t >= grace_period > 0
        assert reduction_factor > 1
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        self.time_attr = time_attr
        # rung milestones: grace, grace*rf, grace*rf^2, ... < max_t
        self.milestones: List[int] = []
        t = grace_period
        while t < max_t:
            self.milestones.append(int(t))
            t *= reduction_factor
        # milestone -> recorded metric values of trials that reached it
        self._rungs: Dict[int, List[float]] = {m: [] for m in self.milestones}
        self._reached: Dict[str, set] = {}

    def on_result(self, trial_id: str, metrics: dict) -> str:
        t = metrics.get(self.time_attr)
        value = metrics.get(self.metric)
        if t is None or value is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP  # ran to completion
        sign = 1.0 if (self.mode or self._default_mode) == "min" else -1.0
        reached = self._reached.setdefault(trial_id, set())
        for m in self.milestones:
            if t >= m and m not in reached:
                reached.add(m)
                rung = self._rungs[m]
                rung.append(sign * value)
                rung.sort()
                if len(rung) < self.rf:
                    # fewer than rf results recorded: admit everything — the
                    # first arrivals must not be stopped blind
                    continue
                # continue only in the top 1/rf recorded at this rung
                k = max(1, int(len(rung) / self.rf))
                cutoff = rung[k - 1]
                if sign * value > cutoff:
                    return STOP
        return CONTINUE


class MedianStoppingRule:
    """Median stopping (reference: python/ray/tune/schedulers/
    median_stopping_rule.py, from Vizier): after a grace period, stop a
    trial whose best result so far is worse than the MEDIAN of the running
    averages of every other trial at comparable time — cheap, threshold-
    free early stopping for large sweeps."""

    _default_mode = "min"

    def __init__(self, metric: str = None, mode: Optional[str] = None,
                 time_attr: str = "training_iteration",
                 grace_period: int = 1, min_samples_required: int = 3):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self._history: Dict[str, List[tuple]] = {}  # tid -> [(t, signed v)]

    def on_result(self, trial_id: str, metrics: dict) -> str:
        t = metrics.get(self.time_attr)
        value = metrics.get(self.metric)
        if t is None or value is None:
            return CONTINUE
        sign = 1.0 if (self.mode or self._default_mode) == "max" else -1.0
        self._history.setdefault(trial_id, []).append(
            (float(t), sign * float(value)))
        if t < self.grace_period:
            return CONTINUE
        # compare at COMPARABLE time: other trials' running means over
        # results up to THIS trial's progress — a late starter must be
        # judged against what the cohort looked like at the same step,
        # not against their fully-trained tails
        import numpy as np

        means = []
        for tid, hist in self._history.items():
            if tid == trial_id:
                continue
            upto = [v for (ht, v) in hist if ht <= t]
            if upto:
                means.append(float(np.mean(upto)))
        if len(means) < self.min_samples:
            return CONTINUE
        median_of_means = float(np.median(means))
        best = max(v for (_ht, v) in self._history[trial_id])
        return STOP if best < median_of_means else CONTINUE


class PopulationBasedTraining:
    """PBT (reference: python/ray/tune/schedulers/pbt.py): every
    perturbation_interval, trials in the bottom quantile EXPLOIT a top-
    quantile trial (copy its checkpoint + config) and EXPLORE (mutate
    hyperparameters: continuous ranges scale by 0.8/1.2, categorical lists
    resample), continuing training from the donor's state."""

    _default_mode = "max"

    def __init__(self, metric: str = None, mode: Optional[str] = None,
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 seed: Optional[int] = None):
        assert 0 < quantile_fraction <= 0.5
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = dict(hyperparam_mutations or {})
        self.quantile = quantile_fraction
        self.resample_p = resample_probability
        self._rng = random.Random(seed)
        self._configs: Dict[str, dict] = {}
        self._scores: Dict[str, float] = {}
        self._last_perturb: Dict[str, float] = {}
        self._pending_exploit: Dict[str, dict] = {}

    def register(self, trial_id: str, config: dict):
        self._configs[trial_id] = dict(config)
        self._last_perturb.setdefault(trial_id, 0)

    def on_result(self, trial_id: str, metrics: dict) -> str:
        t = metrics.get(self.time_attr)
        value = metrics.get(self.metric)
        if t is None or value is None:
            return CONTINUE
        self._scores[trial_id] = float(value)
        if t - self._last_perturb.get(trial_id, 0) < self.interval:
            return CONTINUE
        self._last_perturb[trial_id] = t
        lower, upper = self._quantiles()
        if trial_id not in lower or not upper:
            return CONTINUE
        donor = self._rng.choice(upper)
        self._pending_exploit[trial_id] = {
            "donor": donor,
            "config": self._explore(self._configs.get(donor, {})),
        }
        return EXPLOIT

    def take_exploit(self, trial_id: str) -> Optional[dict]:
        decision = self._pending_exploit.pop(trial_id, None)
        if decision is not None:
            self._configs[trial_id] = dict(decision["config"])
        return decision

    def _quantiles(self):
        if len(self._scores) < 2:
            return [], []
        sign = 1.0 if (self.mode or self._default_mode) == "max" else -1.0
        ranked = sorted(self._scores, key=lambda tid: sign * self._scores[tid])
        n = max(1, int(len(ranked) * self.quantile))
        return ranked[:n], ranked[-n:]

    def _explore(self, config: dict) -> dict:
        out = dict(config)
        for name, spec in self.mutations.items():
            cur = out.get(name)
            if callable(spec):
                out[name] = spec()
            elif isinstance(spec, list):
                if self._rng.random() < self.resample_p or cur not in spec:
                    out[name] = self._rng.choice(spec)
                else:
                    # shift one step along the list (explore neighbors)
                    i = spec.index(cur)
                    j = min(len(spec) - 1, max(0, i + self._rng.choice((-1, 1))))
                    out[name] = spec[j]
            elif isinstance(spec, tuple) and len(spec) == 2:
                lo, hi = spec
                if self._rng.random() < self.resample_p or cur is None:
                    out[name] = self._rng.uniform(lo, hi)
                else:
                    out[name] = min(hi, max(lo, cur * self._rng.choice((0.8, 1.2))))
            else:
                raise ValueError(f"unsupported mutation spec for {name!r}")
        return out


class PB2(PopulationBasedTraining):
    """PB2 (reference: python/ray/tune/schedulers/pb2.py, Parker-Holder et
    al. 2020): PBT where EXPLORE fits a Gaussian process on
    (time, hyperparams) -> reward improvement and proposes the exploited
    trial's new config by UCB maximization — sample-efficient for the
    small populations where random perturbation thrashes.

    `hyperparam_bounds` maps each tuned (continuous) hyperparameter to
    (low, high). The GP is exact (RBF kernel) over the bounded history the
    schedule produces — population x intervals points, trivially small."""

    def __init__(self, metric: str = None, mode: Optional[str] = None,
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 4,
                 hyperparam_bounds: Optional[Dict[str, tuple]] = None,
                 quantile_fraction: float = 0.25,
                 ucb_kappa: float = 2.0,
                 seed: Optional[int] = None):
        super().__init__(
            metric=metric, mode=mode, time_attr=time_attr,
            perturbation_interval=perturbation_interval,
            hyperparam_mutations={}, quantile_fraction=quantile_fraction,
            seed=seed)
        if not hyperparam_bounds:
            raise ValueError("PB2 needs hyperparam_bounds={name: (lo, hi)}")
        self.bounds = {k: (float(lo), float(hi))
                       for k, (lo, hi) in hyperparam_bounds.items()}
        self.kappa = ucb_kappa
        self._names = sorted(self.bounds)
        self._data: List[tuple] = []      # (t, xvec, reward delta)
        self._prev_score: Dict[str, float] = {}
        self._max_t_seen = 1.0

    def _xvec(self, t: float, config: dict) -> list:
        row = [t / max(self._max_t_seen, 1.0)]
        for n in self._names:
            lo, hi = self.bounds[n]
            v = float(config.get(n, lo))
            row.append((v - lo) / (hi - lo) if hi > lo else 0.0)
        return row

    def on_result(self, trial_id: str, metrics: dict) -> str:
        t = metrics.get(self.time_attr)
        value = metrics.get(self.metric)
        if t is not None and value is not None:
            self._max_t_seen = max(self._max_t_seen, float(t))
            prev = self._prev_score.get(trial_id)
            if prev is not None:
                sign = 1.0 if (self.mode or self._default_mode) == "max" \
                    else -1.0
                self._data.append(
                    (float(t), self._configs.get(trial_id, {}),
                     sign * (float(value) - prev)))
            self._prev_score[trial_id] = float(value)
        return super().on_result(trial_id, metrics)

    def take_exploit(self, trial_id: str) -> Optional[dict]:
        decision = super().take_exploit(trial_id)
        if decision is not None:
            # the next report's score jump comes from the donor's
            # CHECKPOINT, not the new config — recording it as a reward
            # delta would dominate the GP's y-scale and flatten every
            # genuine per-interval signal
            self._prev_score.pop(trial_id, None)
        return decision

    def _gp_posterior(self, X, y, Xq):
        import numpy as np

        ls, noise = 0.3, 1e-3
        def k(A, B):
            d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
            return np.exp(-d2 / (2 * ls * ls))

        K = k(X, X) + noise * np.eye(len(X))
        Ks = k(Xq, X)
        sol = np.linalg.solve(K, y)
        mu = Ks @ sol
        v = np.linalg.solve(K, Ks.T)
        var = np.clip(1.0 + noise - (Ks * v.T).sum(-1), 1e-9, None)
        return mu, np.sqrt(var)

    def _explore(self, config: dict) -> dict:
        import numpy as np

        out = dict(config)
        cands = []
        for _ in range(64):
            cands.append({n: self._rng.uniform(*self.bounds[n])
                          for n in self._names})
        if len(self._data) >= 4:
            X = np.asarray([self._xvec(t, c) for t, c, _ in self._data])
            y = np.asarray([dy for _, _, dy in self._data], float)
            scale = max(1e-9, float(np.abs(y).max()))
            y = y / scale
            t_next = self._max_t_seen + self.interval
            Xq = np.asarray([self._xvec(t_next, c) for c in cands])
            mu, sd = self._gp_posterior(X, y, Xq)
            best = int(np.argmax(mu + self.kappa * sd))
        else:  # cold start: random search until the GP has data
            best = self._rng.randrange(len(cands))
        for n in self._names:
            out[n] = cands[best][n]
        return out
