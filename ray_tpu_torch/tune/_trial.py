"""Trial execution: one actor per trial running the user trainable.

Reference: python/ray/tune/trainable/trainable.py (function trainables
report via session) + execution/tune_controller.py (controller polls trial
results). The trainable runs on the actor's executor thread; `tune.report`
writes into the process-local session buffer the controller drains via RPC,
and a stop flag set by the scheduler unwinds the function at its next
report.
"""

from __future__ import annotations

import threading
import traceback

import ray_tpu_torch
from ray_tpu_torch.tune import _session
from ray_tpu_torch.tune._session import StopTrial, report  # noqa: F401 — re-export


@ray_tpu_torch.remote
class TrialActor:
    """Runs one trial's trainable on a worker thread; the controller polls
    poll() for fresh results and final status."""

    def __init__(self, fn_blob: bytes, config: dict, checkpoint: dict = None,
                 start_iteration: int = 0):
        import cloudpickle

        self._fn = cloudpickle.loads(fn_blob)
        self._config = config
        self._ctx = _session.TrialContext(start_checkpoint=checkpoint)
        # PBT exploit replaces the actor mid-run: the trial's time axis must
        # continue from where the old actor stopped, not restart at 1
        self._ctx.iteration = start_iteration
        self._status = "RUNNING"
        self._error = ""
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        _session.set_ctx(self._ctx)
        try:
            self._fn(self._config)
            self._status = "TERMINATED"
        except _session.StopTrial:
            self._status = "STOPPED"
        except BaseException:  # noqa: BLE001 — recorded as trial error
            self._error = traceback.format_exc()
            self._status = "ERRORED"
        finally:
            _session.set_ctx(None)

    def poll(self) -> dict:
        return {
            "status": self._status,
            "results": self._ctx.drain(),
            "error": self._error,
        }

    def stop(self) -> bool:
        """Cooperative stop: the trainable unwinds at its next report()."""
        self._ctx.stopped = True
        return True

    def get_checkpoints(self) -> list:
        return self._ctx.checkpoints
