"""Connectors-lite: composable transforms between env, module, and learner
— the JAX package's ``rllib/connectors.py``, copied (numpy only; the port
imports nothing of that package).

Reference surface: rllib/connectors/ (ConnectorV2 pipelines —
env_to_module, module_to_env, learner). Miniaturized: a connector is a
callable over a BATCHED dict ({"obs": [B, ...]} on the way in,
{"actions": [B]} on the way out); pipelines compose them. Stateful
connectors (observation normalization) keep per-runner state, like the
reference's per-EnvRunner MeanStdFilter.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import numpy as np

Batch = Dict[str, np.ndarray]


class Connector:
    """One transform stage (reference: ConnectorV2.__call__)."""

    def __call__(self, batch: Batch) -> Batch:  # pragma: no cover - ABC
        raise NotImplementedError


class ConnectorPipeline(Connector):
    """Ordered composition (reference: ConnectorPipelineV2)."""

    def __init__(self, connectors: Sequence[Connector] = ()):
        self.connectors: List[Connector] = list(connectors)

    def append(self, connector: Connector) -> "ConnectorPipeline":
        self.connectors.append(connector)
        return self

    def __call__(self, batch: Batch) -> Batch:
        for c in self.connectors:
            batch = c(batch)
        return batch


class Lambda(Connector):
    """Wrap a plain function over the batch dict."""

    def __init__(self, fn: Callable[[Batch], Batch]):
        self.fn = fn

    def __call__(self, batch: Batch) -> Batch:
        return self.fn(batch)


class FlattenObs(Connector):
    """(B, *shape) observations → (B, prod(shape)) float32."""

    def __call__(self, batch: Batch) -> Batch:
        obs = np.asarray(batch["obs"])
        batch["obs"] = obs.reshape(obs.shape[0], -1).astype(np.float32)
        return batch


class CastObsFloat32(Connector):
    def __call__(self, batch: Batch) -> Batch:
        batch["obs"] = np.asarray(batch["obs"], dtype=np.float32)
        return batch


class NormalizeObs(Connector):
    """Running mean/std observation filter (reference: MeanStdFilter
    connector; state is per-runner and updated online)."""

    def __init__(self, eps: float = 1e-8, clip: float = 10.0):
        self.eps = eps
        self.clip = clip
        self.count = 0
        self.mean: Any = None
        self.m2: Any = None

    def __call__(self, batch: Batch) -> Batch:
        obs = np.asarray(batch["obs"], dtype=np.float64)
        for row in obs:
            self.count += 1
            if self.mean is None:
                self.mean = row.copy()
                self.m2 = np.zeros_like(row)
            else:
                delta = row - self.mean
                self.mean += delta / self.count
                self.m2 += delta * (row - self.mean)
        var = (self.m2 / max(1, self.count - 1)
               if self.count > 1 else np.ones_like(obs[0]))
        out = (obs - self.mean) / np.sqrt(var + self.eps)
        batch["obs"] = np.clip(out, -self.clip, self.clip).astype(np.float32)
        return batch


class ClipActions(Connector):
    """module_to_env: clip continuous actions to the env's bounds."""

    def __init__(self, low: float, high: float):
        self.low = low
        self.high = high

    def __call__(self, batch: Batch) -> Batch:
        batch["actions"] = np.clip(batch["actions"], self.low, self.high)
        return batch
