"""The per-phase time limit (_time_limit.py), each case in an inner
pytest session that loads the plugin alone, in a subprocess of its own."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Sets a 1 s limit, records each phase's outcome and duration, and at the
# session's end whether SIGALRM's handler and the timer are as they were
# before it.
INNER_CONFTEST = """
import json
import signal

import pytest

import _time_limit

_time_limit.LIMIT_S = 1
BEFORE = signal.getsignal(signal.SIGALRM)
REPORTS = []


# a makereport wrapper besides the guard's, as the chaos auto-dump in
# tests/conftest.py is: it must read the guard's verdict
@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_makereport(item, call):
    rep = (yield).get_result()
    REPORTS.append([item.name, rep.when, rep.outcome, rep.duration])


def pytest_sessionfinish(session):
    with open("result.json", "w") as f:
        json.dump({"reports": REPORTS,
                   "handler_restored":
                       signal.getsignal(signal.SIGALRM) == BEFORE,
                   "timer": signal.getitimer(signal.ITIMER_REAL)}, f)
"""

HEADER = """
import gc
import threading
import time

import pytest

LOCK = threading.Lock()
"""

CASES = {
    # a thread other than the main one deadlocks holding the lock: each
    # later phase that waits on it costs one limit, and the run ends
    "background": ("""
def test_holder_deadlocks():
    def deadlock():
        LOCK.acquire()
        LOCK.acquire()  # blocked line

    threading.Thread(target=deadlock, daemon=True).start()
    while not LOCK.locked():
        time.sleep(0.01)


def test_waits():
    LOCK.acquire()


def test_waits_again():
    LOCK.acquire()


def test_free():
    pass
""", {("test_waits", "call"): "failed",
      ("test_waits_again", "call"): "failed"}, "over its 1 s limit in call"),
    "lock": ("""
def test_blocks():
    LOCK.acquire()
    LOCK.acquire()  # blocked line
""", {("test_blocks", "call"): "failed"}, "over its 1 s limit in call"),
    "finaliser": ("""
class Holder:
    def __del__(self):
        LOCK.acquire()  # blocked line


def test_finaliser():
    gc.disable()
    LOCK.acquire()
    holder = Holder()
    holder.cycle = holder
    del holder
    gc.collect()
    LOCK.release()
    gc.enable()
""", {("test_finaliser", "call"): "failed"}, "over its 1 s limit in call"),
    "teardown": ("""
@pytest.fixture
def stuck():
    yield
    LOCK.acquire()
    LOCK.acquire()  # blocked line


def test_teardown_blocks(stuck):
    pass
""", {("test_teardown_blocks", "call"): "passed",
      ("test_teardown_blocks", "teardown"): "failed"},
        "over its 1 s limit in teardown"),
    "next_test": ("""
def test_blocks():
    LOCK.acquire()
    LOCK.acquire()  # blocked line


def test_next():
    assert LOCK.locked()
""", {("test_blocks", "call"): "failed", ("test_next", "call"): "passed"},
        "over its 1 s limit in call"),
    "in_time": ("""
def test_first():
    time.sleep(0.6)


def test_second():
    time.sleep(0.6)
""", {("test_first", "call"): "passed", ("test_second", "call"): "passed"},
        None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_time_limit(case, tmp_path):
    body, expected, message = CASES[case]
    (tmp_path / "conftest.py").write_text(INNER_CONFTEST)
    source = HEADER + textwrap.dedent(body)
    (tmp_path / "test_inner.py").write_text(source)
    env = dict(os.environ, PYTHONPATH=REPO, PYTEST_DISABLE_PLUGIN_AUTOLOAD="1")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "_time_limit",
         "-p", "no:cacheprovider", "-q", "test_inner.py"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=60)
    out = proc.stdout + proc.stderr
    result = json.loads((tmp_path / "result.json").read_text())
    phases = {(name, when): (outcome, duration)
              for name, when, outcome, duration in result["reports"]}
    for key, outcome in expected.items():
        assert phases[key][0] == outcome, (key, out)
    assert all(outcome == "passed" for (name, when), (outcome, _)
               in phases.items() if (name, when) not in expected), out
    assert result["handler_restored"], out
    assert result["timer"] == [0.0, 0.0], out
    assert proc.returncode == (1 if message else 0), out
    if message is None:
        assert "stacks:" not in out and "Current thread" not in out, out
        return
    assert message in out, out
    # every thread's stack, with the blocked line in it
    blocked = next(n for n, line in enumerate(source.splitlines(), 1)
                   if "# blocked line" in line)
    assert "Current thread" in out, out
    assert f'test_inner.py", line {blocked}' in out, out
    # each failed phase cost one limit
    assert all(0.9 <= duration < 5 for outcome, duration in phases.values()
               if outcome == "failed"), out


def test_the_suite_runs_under_the_guard(request):
    # loaded by the repo's top-level conftest.py
    assert request.config.pluginmanager.has_plugin("_time_limit")
