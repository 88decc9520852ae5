"""Per-process trial session state (reference: ray.tune's session object —
`tune.report` resolves the enclosing trial through it).

Kept in its own module: the TrialActor class is shipped to workers by value
(cloudpickle), and a threading.local referenced from its methods would be
captured unpicklably; a module reference serializes by name instead.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

_local = threading.local()


class StopTrial(Exception):
    """Raised inside the trainable when the scheduler stopped the trial."""


class TrialContext:
    def __init__(self, start_checkpoint: Optional[dict] = None):
        self.results: List[dict] = []
        self.checkpoints: List[dict] = []
        self.iteration = 0
        self.stopped = False
        self.lock = threading.Lock()
        # checkpoint to resume from (PBT exploit / trial restore)
        self.start_checkpoint = start_checkpoint

    def record(self, metrics: Dict[str, Any], checkpoint: Optional[dict]):
        with self.lock:
            self.iteration += 1
            metrics.setdefault("training_iteration", self.iteration)
            self.results.append(metrics)
            if checkpoint is not None:
                self.checkpoints.append(
                    {"iteration": self.iteration, "data": checkpoint})

    def drain(self) -> List[dict]:
        with self.lock:
            out, self.results = self.results, []
            return out


def set_ctx(ctx: Optional[TrialContext]):
    _local.ctx = ctx


def get_ctx() -> Optional[TrialContext]:
    return getattr(_local, "ctx", None)


def get_checkpoint() -> Optional[dict]:
    """Checkpoint to resume from, if the controller restored/exploited one
    (reference: tune.get_checkpoint in function trainables)."""
    ctx = get_ctx()
    return ctx.start_checkpoint if ctx is not None else None


def report(metrics: Dict[str, Any], checkpoint: Optional[dict] = None):
    """Report metrics from inside a trainable (reference: tune.report).
    Auto-fills `training_iteration` (1-based) if absent."""
    ctx = get_ctx()
    if ctx is None:
        raise RuntimeError("tune.report() called outside a Tune trial")
    ctx.record(dict(metrics), checkpoint)
    if ctx.stopped:
        raise StopTrial()
