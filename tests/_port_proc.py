"""Runs the PyTorch side of the ``test_torch_*.py`` parity tests in one
spawned child process per test module.

The pytest workers import no torch: they go on to run the runtime's
cluster tests, where a worker that has imported torch makes a finaliser
deadlock in the JAX package's reference counter (``ObjectRef.__del__``
re-entering ``ReferenceCounter``'s lock from inside ``add_local``; see
ROADMAP, Queue 3) far more likely. This module imports neither torch nor
the port; ``_port_side`` (imported only in the child) does.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import multiprocessing


def _run(name, args, kwargs):
    import _port_side

    return getattr(_port_side, name)(*args, **kwargs)


@contextlib.contextmanager
def spawn(timeout: float = 300.0):
    """Yields ``call(name, *args, **kwargs)``, which runs
    ``_port_side.<name>`` in the child and returns its result."""
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=1, mp_context=ctx) as ex:
        def call(name, *args, **kwargs):
            return ex.submit(_run, name, args, kwargs).result(timeout=timeout)

        call("launches")  # start the child and import the port up front
        yield call
