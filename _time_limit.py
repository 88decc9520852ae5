"""A time limit for each phase (setup, call, teardown) of every test.

The repo's top-level ``conftest.py`` loads this plugin; an inner pytest
session loads it alone with ``-p _time_limit``. Before a phase it arms
``ITIMER_REAL``; on expiry the SIGALRM handler writes every thread's stack
to the captured stderr, records the phase on the item and raises
:class:`TimeLimitExceeded`. After the phase it disarms the timer and puts
back the handler it found.

A raise inside a finaliser (``__del__`` run by the cyclic GC) is swallowed
by the interpreter and the test would go on to pass, so the report hook
fails the phase from the record, whatever its outcome. The timer repeats
every :data:`LIMIT_S` seconds while the phase runs, so a phase that swallowed
one raise and blocks again is interrupted again.

The bound is per phase: a lock that stays held (say, by a thread that
deadlocked) costs every later phase that waits on it one :data:`LIMIT_S`.
The guard does not arm off the main thread or where SIGALRM does not
exist, and cannot interrupt a block in native code that holds the GIL.
"""

import faulthandler
import io
import signal
import sys
import threading

import pytest

LIMIT_S = 180.0

_OVER = pytest.StashKey[tuple]()


class TimeLimitExceeded(BaseException):
    """A test phase ran past its limit. A ``BaseException``, so that
    ``except Exception`` in the code under test cannot absorb it."""


def _dump_stacks():
    try:
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
    except (AttributeError, ValueError, io.UnsupportedOperation):
        # sys.stderr has no file descriptor (``--capture=sys``)
        faulthandler.dump_traceback(file=sys.__stderr__, all_threads=True)


def _guarded(item, when):
    if (not hasattr(signal, "SIGALRM")
            or threading.current_thread() is not threading.main_thread()):
        yield
        return
    message = f"over its {LIMIT_S:g} s limit in {when}"

    def on_alarm(signum, frame):
        print(f"\n{item.nodeid} {message}; stacks:", file=sys.stderr,
              flush=True)
        _dump_stacks()
        item.stash[_OVER] = (when, message)
        raise TimeLimitExceeded(message)

    previous = signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL, LIMIT_S, LIMIT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(hookwrapper=True, trylast=True)
def pytest_runtest_setup(item):
    yield from _guarded(item, "setup")


@pytest.hookimpl(hookwrapper=True, trylast=True)
def pytest_runtest_call(item):
    yield from _guarded(item, "call")


@pytest.hookimpl(hookwrapper=True, trylast=True)
def pytest_runtest_teardown(item):
    yield from _guarded(item, "teardown")


# the innermost wrapper, so that other makereport hooks (the chaos
# auto-dump in tests/conftest.py) read the failed outcome
@pytest.hookimpl(hookwrapper=True, trylast=True)
def pytest_runtest_makereport(item, call):
    outcome = yield
    rep = outcome.get_result()
    when, message = item.stash.get(_OVER, (None, None))
    if when == rep.when and not rep.failed:
        # the raise was swallowed (in a finaliser) and the phase went on
        rep.outcome = "failed"
        rep.longrepr = (f"{message}; the raise was swallowed and the phase "
                        "went on; its stacks are in the captured stderr")
