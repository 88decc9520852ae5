"""Runs the PyTorch side of the ``test_torch_*.py`` parity tests in one
spawned child process per test module.

The pytest workers import no torch: they go on to run the runtime's
cluster tests, where a worker that has imported torch makes a finaliser
deadlock in the JAX package's reference counter (``ObjectRef.__del__``
re-entering ``ReferenceCounter``'s lock from inside ``add_local``; see
ROADMAP, Queue 3) far more likely. This module imports neither torch nor
the port; ``_port_side`` (imported only in the child) does.

The child leads a process group of its own, which the gloo rank processes
it starts (``_port_ranks``) join. The end of the ``with`` block ends that
whole group: politely first (the pipe closes and the child exits, closing
its ranks), then by SIGKILL after a few seconds. A call that outlasts its
timeout, or finds the child gone, kills the group at once. Nothing here
waits for the child without a limit, so a stuck child cannot hold a pytest
worker past its timeout.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
import signal
import traceback

EXIT_GRACE_S = 5.0  # a child that has not exited by then is killed
START_TIMEOUT_S = 300.0  # the child's start, torch's import included


def _serve(conn):
    """The child: run each ``(name, args, kwargs)`` that arrives on
    ``conn`` as ``_port_side.<name>`` and send back ``(ok, value)``, until
    the parent closes the pipe."""
    os.setsid()  # the child and every process it starts: one group
    import _port_side

    while True:
        try:
            name, args, kwargs = conn.recv()
        except EOFError:
            return
        try:
            reply = (True, getattr(_port_side, name)(*args, **kwargs))
        except Exception as e:  # re-raised in the parent
            reply = (False, (e, traceback.format_exc()))
        try:
            conn.send(reply)
        except Exception:  # an exception or result that does not pickle
            conn.send((False, (RuntimeError(traceback.format_exc()), "")))


def _end(proc, conn, grace: float):
    """End the child and its process group: ``grace`` seconds to exit on
    its own, then SIGKILL to the group."""
    conn.close()
    proc.join(grace)
    try:
        os.killpg(proc.pid, signal.SIGKILL)  # a stuck child, stray ranks
    except (ProcessLookupError, PermissionError):
        pass
    proc.join(EXIT_GRACE_S)


@contextlib.contextmanager
def spawn(timeout: float = 300.0):
    """Yields ``call(name, *args, **kwargs)``, which runs
    ``_port_side.<name>`` in the child and returns its result, re-raises
    its exception, or raises ``TimeoutError`` after ``timeout`` seconds
    (the child is then ended, and later calls raise too). The child's
    start has ``START_TIMEOUT_S``."""
    ctx = multiprocessing.get_context("spawn")
    conn, child_conn = ctx.Pipe()
    # not a daemon: the child starts processes of its own (the gloo ranks)
    proc = ctx.Process(target=_serve, args=(child_conn,))
    proc.start()
    child_conn.close()
    ended = False

    def run(name, args, kwargs, limit):
        nonlocal ended
        if ended:
            raise RuntimeError(f"{name}: the port's child has been ended")
        try:
            conn.send((name, args, kwargs))
            if not conn.poll(limit):
                raise TimeoutError(f"{name}: no result in {limit} s")
            ok, value = conn.recv()
        except (TimeoutError, EOFError, OSError):
            ended = True
            _end(proc, conn, grace=0.0)  # the child is stuck or gone
            raise
        if not ok:
            exc, where = value
            raise exc from RuntimeError(f"in the port's child:\n{where}")
        return value

    def call(name, *args, **kwargs):
        return run(name, args, kwargs, timeout)

    try:
        # start the child and import the port up front
        run("launches", (), {}, START_TIMEOUT_S)
        yield call
    finally:
        if not ended:
            _end(proc, conn, grace=EXIT_GRACE_S)
