"""Deterministic fault-injection harness for the event loop and RPC layer.

Capability parity with the reference's chaos testing (reference:
src/ray/asio/asio_chaos.h — RAY_testing_asio_delay_us injects random delays
into asio handlers; src/ray/rpc/rpc_chaos.h — RAY_testing_rpc_failure drops
RPCs at request/response points), extended with the fault classes the
reference exercises via external tooling:

  delay       "method:min_us:max_us[,...]"   pre-handler event-loop delay
  rpc drop    "method:max_failures:req_prob:resp_prob[,...]"
  stall       "method:ms:count[,...]"        server executes, then stalls the
                                             RESPONSE (control-store stalls)
  partition   "src>dst[#count][,...]"        ONE-WAY partition at the RPC
                                             layer: a client in a process
                                             whose chaos role matches `src`
                                             cannot reach peers whose address
                                             (or client label) matches `dst`
  kill        "role:method:nth[,...]"        process whose role matches
                                             os._exit(137)s on the nth
                                             dispatch of `method`

'*' matches anything in every field. Configured by flags
`testing_event_loop_delay_us`, `testing_rpc_failure`, `testing_rpc_stall`,
`testing_rpc_partition`, `testing_process_kill` (env RAY_TPU_*), which every
spawned daemon/control-store/worker inherits; the node daemon and control
store additionally honor a runtime `chaos_set` RPC so tests can aim faults
at one live process (addresses are only known after spawn).

DETERMINISM: `testing_chaos_seed` != 0 seeds a per-process PRNG from
(seed, chaos role) — the role is a stable label like "control", "daemon1",
"daemon1.w3", assigned in spawn order — so every delay length, drop roll,
and jitter draw replays exactly from the seed. Every injected fault is
recorded in a bounded in-process event log (`events()`) for post-mortems.
"""

from __future__ import annotations

import logging
import os
import random
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

from . import config

logger = logging.getLogger(__name__)

_ENV_ROLE = "RT_CHAOS_ROLE"


def _match(pattern: str, value: str) -> bool:
    """Exact match (or '*'). Substring matching would over-aim: 'daemon1'
    must not hit daemon10..19, and a method pattern 'get' must not fire on
    get_actor_info."""
    return pattern == "*" or pattern == value


def _match_role(pattern: str, role: str) -> bool:
    """Role match: exact, or a dot-boundary prefix so 'daemon1' also covers
    the workers it spawned ('daemon1.w3') — but never 'daemon10'."""
    return (pattern == "*" or pattern == role
            or role.startswith(pattern + "."))


class _DelaySpec:
    def __init__(self, spec: str):
        self.rules: Dict[str, Tuple[int, int]] = {}
        for entry in filter(None, (e.strip() for e in spec.split(","))):
            method, lo, hi = entry.rsplit(":", 2)
            self.rules[method] = (int(lo), int(hi))

    def delay_us(self, method: str, rng: random.Random) -> int:
        rule = self.rules.get(method) or self.rules.get("*")
        if rule is None:
            return 0
        lo, hi = rule
        return rng.randint(lo, hi) if hi > lo else lo


class _RpcFailureSpec:
    def __init__(self, spec: str):
        self.rules: Dict[str, list] = {}
        for entry in filter(None, (e.strip() for e in spec.split(","))):
            method, max_failures, req_p, resp_p = entry.rsplit(":", 3)
            self.rules[method] = [int(max_failures), float(req_p), float(resp_p)]

    def roll(self, method: str, rng: random.Random) -> Optional[str]:
        """Returns 'request' (drop before delivery), 'response' (drop reply), or None."""
        rule = self.rules.get(method) or self.rules.get("*")
        if rule is None or rule[0] == 0:
            return None
        r = rng.random()
        if r < rule[1]:
            rule[0] -= 1
            return "request"
        if r < rule[1] + rule[2]:
            rule[0] -= 1
            return "response"
        return None


class _StallSpec:
    """method:ms:count — the handler RUNS, then the reply stalls `ms`
    milliseconds, `count` times (models a wedged-but-alive control store)."""

    def __init__(self, spec: str):
        self.rules: Dict[str, list] = {}
        for entry in filter(None, (e.strip() for e in spec.split(","))):
            method, ms, count = entry.rsplit(":", 2)
            self.rules[method] = [float(ms) / 1e3, int(count)]

    def stall_s(self, method: str) -> float:
        rule = self.rules.get(method) or self.rules.get("*")
        if rule is None or rule[1] == 0:
            return 0.0
        rule[1] -= 1
        return rule[0]


class _PartitionSpec:
    """src>dst[#count] — one-way: this process (role matching src) cannot
    reach peers whose target address/label matches dst ('#' separates the
    count because addresses contain ':'). count omitted = unbounded;
    otherwise the partition HEALS after `count` blocked sends (bounded
    chaos guarantees convergence)."""

    def __init__(self, spec: str):
        self.rules: List[list] = []
        for entry in filter(None, (e.strip() for e in spec.split(","))):
            if ">" not in entry:
                raise ValueError(f"bad partition rule {entry!r}")
            src, dst_count = entry.split(">", 1)
            dst, sep, n_str = dst_count.partition("#")
            n = int(n_str) if sep and n_str and n_str != "inf" else -1
            self.rules.append([src.strip(), dst.strip(), n])

    def blocked(self, role: str, target: str) -> bool:
        for rule in self.rules:
            src, dst, n = rule
            if n == 0:
                continue
            if _match_role(src, role) and _match(dst, target):
                if n > 0:
                    rule[2] = n - 1
                return True
        return False


class _KillSpec:
    """role:method:nth — the nth dispatch of `method` in a process whose
    role matches exits hard (models a crash at a chosen protocol point)."""

    def __init__(self, spec: str):
        self.rules: List[list] = []
        for entry in filter(None, (e.strip() for e in spec.split(","))):
            role, method, nth = entry.rsplit(":", 2)
            self.rules.append([role, method, int(nth)])

    def should_die(self, role: str, method: str) -> bool:
        for rule in self.rules:
            r, m, nth = rule
            if nth <= 0:
                continue
            if _match_role(r, role) and _match(m, method):
                rule[2] = nth - 1
                if rule[2] == 0:
                    return True
        return False


class _PreemptSpec:
    """role:delay_ms:deadline_ms — a node daemon whose role matches gets a
    synthetic preemption notice `delay_ms` after startup and must drain
    within `deadline_ms` (models a GCE maintenance event / spot reclaim;
    the delay makes the notice land mid-workload, deterministically)."""

    def __init__(self, spec: str):
        self.rules: List[list] = []
        for entry in filter(None, (e.strip() for e in spec.split(","))):
            role, delay_ms, deadline_ms = entry.rsplit(":", 2)
            self.rules.append([role, float(delay_ms) / 1e3,
                               float(deadline_ms) / 1e3])

    def notice_for(self, role: str) -> Optional[Tuple[float, float]]:
        for rule in self.rules:
            r, delay_s, deadline_s = rule
            if _match_role(r, role):
                return (delay_s, deadline_s)
        return None


class _PreemptWaveSpec:
    """frac:window_ms:deadline_ms — a correlated spot-reclaim wave: each
    SPOT node draws (seeded, per-role) whether it is in the wave with
    probability `frac`, and victims receive their notice at a deterministic
    offset inside one `window_ms` burst, each with `deadline_ms` until hard
    death. No cross-node coordination needed: the per-role PRNG makes the
    fleet-wide draw reproducible from one integer seed."""

    def __init__(self, spec: str):
        frac, window_ms, deadline_ms = spec.strip().split(":")
        self.frac = float(frac)
        self.window_s = float(window_ms) / 1e3
        self.deadline_s = float(deadline_ms) / 1e3
        if not 0.0 <= self.frac <= 1.0:
            raise ValueError(f"wave fraction {self.frac} outside [0, 1]")

    def notice_for(self, rng: random.Random) -> Optional[Tuple[float, float]]:
        """(offset_s, deadline_s) when this node is in the wave, else None.
        Two draws in a fixed order keep the schedule seed-stable."""
        hit = rng.random() < self.frac
        offset = rng.uniform(0.0, self.window_s)
        if not hit:
            return None
        return (offset, self.deadline_s)


class ChaosController:
    """Per-process chaos state: seeded PRNG, parsed spec caches (keyed by
    the live config string so runtime `chaos_set` updates take effect), and
    a bounded decision log."""

    def __init__(self):
        self._lock = threading.Lock()
        self._role = os.environ.get(_ENV_ROLE, "proc")
        self._rng: Optional[random.Random] = None
        self._rng_seed: Optional[int] = None
        self._cache: Dict[str, tuple] = {}  # flag -> (spec_str, parsed)
        self._events: deque = deque(maxlen=512)

    # -- identity / rng -------------------------------------------------

    @property
    def role(self) -> str:
        return self._role

    def set_role(self, role: str) -> None:
        with self._lock:
            self._role = role
            self._rng = None  # re-derive: the seed mixes in the role

    def rng(self) -> random.Random:
        seed = config.get("testing_chaos_seed")
        with self._lock:
            if self._rng is None or self._rng_seed != seed:
                self._rng_seed = seed
                # seeded from (seed, role): every process draws its own
                # deterministic stream; role assignment is spawn-ordered so
                # the whole cluster's schedule replays from one integer
                self._rng = (random.Random(f"{seed}:{self._role}")
                             if seed else random.Random())
            return self._rng

    # -- spec cache -----------------------------------------------------

    def _spec(self, flag: str, cls):
        spec = config.get(flag)
        if not spec:
            return None
        with self._lock:
            cached = self._cache.get(flag)
            if cached is None or cached[0] != spec:
                cached = (spec, cls(spec))
                self._cache[flag] = cached
            return cached[1]

    def _record(self, kind: str, method: str, detail) -> None:
        self._events.append((kind, method, detail))
        logger.info("chaos[%s] %s %s -> %s", self._role, kind, method, detail)

    def events(self) -> list:
        """Injected-fault log (kind, method, detail), oldest first."""
        return list(self._events)

    def reset(self) -> None:
        with self._lock:
            self._cache.clear()
            self._rng = None
            self._events.clear()


_controller = ChaosController()


def set_role(role: str) -> None:
    """Assign this process's stable chaos role (e.g. 'control', 'daemon1',
    'daemon1.w2', 'driver'); parents pass it via the RT_CHAOS_ROLE env."""
    _controller.set_role(role)


def role() -> str:
    return _controller.role


def rng() -> random.Random:
    """The per-process chaos PRNG — seeded & deterministic when
    `testing_chaos_seed` is set, fresh entropy otherwise. Retry jitter
    draws from here so failing schedules replay from the seed."""
    return _controller.rng()


def events() -> list:
    return _controller.events()


def event_loop_delay_us(method: str) -> int:
    """Delay (microseconds) to inject before running `method`'s handler."""
    spec = _controller._spec("testing_event_loop_delay_us", _DelaySpec)
    if spec is None:
        return 0
    r = _controller.rng()
    with _controller._lock:
        delay = spec.delay_us(method, r)
    if delay:
        _controller._record("delay_us", method, delay)
    return delay


def rpc_failure(method: str) -> Optional[str]:
    """Injected drop for an RPC: 'request', 'response', or None."""
    spec = _controller._spec("testing_rpc_failure", _RpcFailureSpec)
    if spec is None:
        return None
    r = _controller.rng()
    with _controller._lock:
        verdict = spec.roll(method, r)
    if verdict:
        _controller._record("drop", method, verdict)
    return verdict


def response_stall_s(method: str) -> float:
    """Server-side response stall (seconds) AFTER the handler ran — the
    'control store executes but the reply never comes' failure mode."""
    spec = _controller._spec("testing_rpc_stall", _StallSpec)
    if spec is None:
        return 0.0
    with _controller._lock:
        stall = spec.stall_s(method)
    if stall:
        _controller._record("stall_s", method, stall)
    return stall


def partitioned(target: str) -> bool:
    """Client-side one-way partition check: True = this process cannot
    reach `target` (an address or client label) right now."""
    spec = _controller._spec("testing_rpc_partition", _PartitionSpec)
    if spec is None:
        return False
    with _controller._lock:
        blocked = spec.blocked(_controller._role, target)
    if blocked:
        _controller._record("partition", target, "blocked")
    return blocked


def preempt_notice() -> Optional[Tuple[float, float]]:
    """Synthetic preemption notice for THIS process's role: returns
    (delay_s, drain_deadline_s) when `testing_preempt_notice` aims at this
    role, else None. The node daemon checks this once at startup and
    schedules a self-drain — the deterministic counterpart of the GCE
    maintenance-event watcher."""
    spec = _controller._spec("testing_preempt_notice", _PreemptSpec)
    if spec is None:
        return None
    with _controller._lock:
        notice = spec.notice_for(_controller._role)
    if notice:
        _controller._record("preempt_notice", _controller._role, notice)
    return notice


def preempt_wave(is_spot: bool) -> Optional[Tuple[float, float]]:
    """Correlated-wave membership for THIS process: returns (offset_s,
    drain_deadline_s) when `testing_preempt_wave` is set, the node carries
    the spot marker, and the seeded per-role draw lands inside the wave
    fraction — else None. Only SPOT capacity is reclaimed: the fault models
    a provider clawing back its preemptible pool, not an outage."""
    spec = _controller._spec("testing_preempt_wave", _PreemptWaveSpec)
    if spec is None or not is_spot:
        return None
    r = _controller.rng()
    with _controller._lock:
        notice = spec.notice_for(r)
    if notice:
        _controller._record("preempt_wave", _controller._role, notice)
    return notice


def maybe_kill(method: str) -> None:
    """Process-kill fault point (RPC dispatch): exits hard when the spec's
    nth hit lands in a process whose role matches."""
    spec = _controller._spec("testing_process_kill", _KillSpec)
    if spec is None:
        return
    with _controller._lock:
        die = spec.should_die(_controller._role, method)
    if die:
        logger.warning("chaos[%s] killing process at %s (pid %d)",
                       _controller._role, method, os.getpid())
        os._exit(137)


def reset() -> None:
    _controller.reset()
