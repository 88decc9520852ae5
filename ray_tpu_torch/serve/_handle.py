"""DeploymentHandle: client-side router over a deployment's replicas.

Reference: python/ray/serve/handle.py (DeploymentHandle) +
_private/router.py:556 (ReplicaScheduler). Routing is power-of-two-choices
over locally tracked in-flight counts; the replica set refreshes from the
controller periodically and on failure.

Overload/failure plane (reference: Serve's deadline-aware routing +
max_queued_requests admission; envoy-style retry budgets; The Tail at
Scale's hedging/ejection arguments):

- every request may carry an absolute END-TO-END DEADLINE
  (`handle.options(timeout_s=...)`, inherited automatically from the
  in-flight request context inside a replica). Expired requests fail
  HERE, before a replica RPC is spent.
- INGRESS SHED: when every replica's probed queue length is saturated
  (>= max_concurrent + max_queued), `.remote()` raises a typed
  BackpressureError without spending a replica RPC.
- RETRY BUDGET: failovers (replica death, queue rejection) spend from a
  token bucket replenished by successes — a fraction of recent goodput,
  so overload-driven retries can't amplify the overload.
- OUTLIER EJECTION: replicas with consecutive failures/timeouts leave
  the routing set for a probation window; the first request after the
  window is the re-probe.
- GRACEFUL DEGRADATION: a controller (or control store) outage never
  wipes a live routing table — refresh failures and amnesiac fresh
  controllers keep the last-known replica set serving.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.serve._context import DEADLINE_KWARG, get_request_deadline
from ray_tpu_torch.serve._errors import (
    BackpressureError,
    DeadlineExceededError,
    unwrap,
)

_REFRESH_S = 2.0


def _cfg(name: str):
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    return GLOBAL_CONFIG.get(name)


# config-push plumbing (reference: long_poll.py:318): one per-process
# subscription to the controller's "serve" channel; a push invalidates
# every live handle of that deployment so its next request refreshes
# immediately instead of waiting out the TTL (which stays as the fallback
# for missed pushes).
import weakref

_handle_registry: "weakref.WeakSet" = weakref.WeakSet()
# keyed by the CoreWorker instance: a new session's core worker needs its
# own subscription (a bare bool would leave every later session pushless)
_push_cw = None


def _on_serve_push(message):
    import math

    name = (message or {}).get("name")
    for h in list(_handle_registry):
        if h.deployment_name == name:
            # -inf, not 0.0: monotonic() starts at boot, so `now - 0 >= TTL`
            # is FALSE under any TTL larger than the uptime — the push
            # would be silently inert
            h._last_refresh = -math.inf


def _subscribe_push():
    global _push_cw
    try:
        from ray_tpu_torch._private.core_worker import get_core_worker

        cw = get_core_worker()
        if _push_cw is cw:
            return
        cw.control.subscribe_channel("serve", _on_serve_push)

        async def sub():
            await cw.control.call("subscribe", {"channel": "serve"})

        cw.schedule(sub())
        cw.control.on_reconnect(
            lambda: cw.control.call("subscribe", {"channel": "serve"}))
        _push_cw = cw
    except Exception:  # noqa: BLE001 — TTL polling still covers refresh
        pass


class _RetryBudget:
    """Token-bucket retry budget (reference: envoy retry budgets):
    each retry spends one token; each success deposits `ratio` of one,
    capped — sustained failover throughput is at most `ratio` of recent
    goodput plus the initial floor, so an overloaded/flapping backend
    can't be amplified by its own retries."""

    __slots__ = ("_ratio", "_cap", "_tokens")

    def __init__(self, ratio: float, floor: float, cap: float = 100.0):
        self._ratio = ratio
        self._cap = max(cap, floor)
        self._tokens = float(floor)

    def on_success(self):
        self._tokens = min(self._cap, self._tokens + self._ratio)

    def try_spend(self) -> bool:
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False

    def tokens(self) -> float:
        return self._tokens


class _CallSpec:
    """Everything needed to resubmit a request on another replica."""

    __slots__ = ("method", "args", "kwargs", "model_id", "deadline",
                 "affinity_key")

    def __init__(self, method: Optional[str], args, kwargs,
                 model_id: str = "", deadline: float = 0.0,
                 affinity_key: str = ""):
        self.method = method
        self.args = args
        self.kwargs = kwargs
        self.model_id = model_id
        self.deadline = deadline
        self.affinity_key = affinity_key


class DeploymentHandle:
    def __init__(self, deployment_name: str, controller=None):
        self.deployment_name = deployment_name
        # controller may be None for a deserialized handle: resolution is
        # deferred to first use because unpickling can happen on the core
        # event loop (task args), where a blocking get_actor would deadlock
        self._controller = controller
        self._replicas: List[Any] = []
        # per-replica admitted-request capacity (max_concurrent +
        # max_queued), None = unbounded queue -> ingress shedding off
        self._capacity: Optional[int] = None
        # replica actor-id -> issued-not-consumed; keyed by id (not index) so
        # counts survive replica-set changes and periodic refreshes — wiping
        # them would erase the power-of-two-choices load signal every 2 s
        self._inflight: Dict[bytes, int] = {}
        # CROSS-handle load signal (reference: pow_2_router.py:27 queue-len
        # cache): replicas are probed for their true in-flight count in the
        # background; load = probed qlen + requests THIS handle sent since
        # the probe (monotonic counter delta avoids double-counting our own
        # already-reported requests). Without this, two busy handles each
        # see only their own traffic and can pile onto one replica.
        self._qlen_cache: Dict[bytes, tuple] = {}  # rid -> (qlen, sent_snap, ts)
        self._sent: Dict[bytes, int] = {}
        # rid -> probe start time; stale entries (>10s) are retried, so a
        # probe lost to a closing core worker can't disable probing forever
        self._probing: Dict[bytes, float] = {}
        # multiplexing: model id -> replica actor-id that loaded it last
        # (reference: multiplex-aware routing in pow_2_router.py)
        self._model_affinity: Dict[str, bytes] = {}
        # prefix affinity (reference: ray.llm kv_aware routing): session /
        # prompt-prefix key -> replica whose PagedEngine likely still holds
        # the prefix's KV blocks. SOFT, unlike model affinity: a saturated
        # or vanished sticky replica falls back to pow-2 and the key remaps
        # — prefix reuse is a latency optimization, never worth queueing a
        # request behind a hot replica for.
        import collections

        self._prefix_affinity: "collections.OrderedDict[str, bytes]" = (
            collections.OrderedDict())
        # outlier ejection state
        self._fail_streak: Dict[bytes, int] = {}
        self._ejected: Dict[bytes, float] = {}  # rid -> eject-until (monotonic)
        self._budget = _RetryBudget(
            _cfg("serve_retry_budget_ratio"), _cfg("serve_retry_budget_min"))
        # overload-plane observability (asserted in tests / scraped by bench)
        self.overload_stats = {
            "shed_ingress": 0,          # BackpressureError before any RPC
            "expired_before_send": 0,   # deadline dead on arrival
            "retries": 0,               # budget-approved failovers
            "retries_denied": 0,        # budget exhausted
            "ejections": 0,
            "stale_serves": 0,          # refreshes survived on stale set
        }
        self._last_refresh = 0.0
        self._lock = threading.Lock()
        _handle_registry.add(self)
        _subscribe_push()

    def options(self, *, multiplexed_model_id: str = "",
                stream: bool = False,
                timeout_s: Optional[float] = None,
                affinity_key: str = "") -> "_ConfiguredCaller":
        """Per-request options (reference: handle.options):
        multiplexed_model_id routes to a replica that already holds the
        model; stream=True calls the replica's streaming path and returns a
        result iterator; timeout_s sets the request's END-TO-END deadline —
        it propagates to the replica and bounds queue wait, execution, and
        every stream chunk; affinity_key is a SOFT routing hint (session /
        prompt-prefix id) steering same-key requests to the replica that
        served the key last — its prefix-cached KV blocks make the repeat
        prefill cheap — while saturation overflows to power-of-two."""
        if multiplexed_model_id and stream:
            raise ValueError(
                "stream=True with multiplexed_model_id is not supported yet")
        return _ConfiguredCaller(self, model_id=multiplexed_model_id,
                                 stream=stream, timeout_s=timeout_s,
                                 affinity_key=affinity_key)

    def _resolve_controller(self):
        if self._controller is None:
            from ray_tpu_torch.serve._controller import get_or_create_controller

            self._controller = get_or_create_controller()
        return self._controller

    async def _resolve_controller_async(self):
        if self._controller is None:
            from ray_tpu_torch.serve._controller import get_or_create_controller_async

            self._controller = await get_or_create_controller_async()
        return self._controller

    def _stale(self, force: bool) -> bool:
        return force or not self._replicas or (
            time.monotonic() - self._last_refresh >= _REFRESH_S
        )

    def _install(self, info: Any):
        """Install a routing-info reply. Accepts the controller's
        get_routing_info dict or a bare replica list (compat)."""
        if isinstance(info, dict):
            replicas = info.get("replicas") or []
            known = info.get("known", True)
            mq = info.get("max_queued", -1)
            capacity = (info.get("max_concurrent", 0) + mq) if mq >= 0 else None
        else:
            replicas, known, capacity = info, True, None
        if not known and self._replicas:
            # an AMNESIAC controller (auto-recreated after a kill) does not
            # know the deployment: that is an outage, not a deletion —
            # keep serving the last-known set (reference: serve routers
            # ride out controller crashes on their local routing table)
            self._degrade()
            return
        with self._lock:
            self._replicas = replicas
            self._capacity = capacity
            keep = {r._actor_id.binary() for r in replicas}
            for d in (self._inflight, self._qlen_cache, self._sent,
                      self._fail_streak, self._ejected):
                for rid in [rid for rid in d if rid not in keep]:
                    del d[rid]
            self._last_refresh = time.monotonic()

    def _degrade(self):
        """Refresh failed/was non-authoritative: keep the stale replica
        set live and retry at the NORMAL cadence at worst — a degraded
        handle must not recover routing-table freshness slower than a
        healthy one just because the refresh timeout exceeds the TTL."""
        with self._lock:
            self.overload_stats["stale_serves"] += 1
            retry_in = min(_REFRESH_S, _cfg("serve_refresh_timeout_s"))
            self._last_refresh = time.monotonic() - _REFRESH_S + retry_in

    def _refresh_timeout(self, deadline: float = 0.0) -> float:
        t = _cfg("serve_refresh_timeout_s")
        if deadline:
            t = max(0.05, min(t, deadline - time.time()))
        return t

    async def _refresh_async(self, force: bool = False,
                             deadline: float = 0.0):
        """Refresh path for callers on the core event loop (HTTP proxy,
        async actors) where a blocking get would deadlock. Bounded by the
        request deadline like the sync path: a mid-failover refresh must
        not overshoot the caller's budget by the full refresh timeout."""
        if not self._stale(force):
            return
        from ray_tpu_torch._private.core_worker import get_core_worker

        try:
            controller = await self._resolve_controller_async()
            info = await get_core_worker().get_async(
                controller.get_routing_info.remote(self.deployment_name),
                timeout=self._refresh_timeout(deadline))
        except Exception:  # noqa: BLE001 — controller outage
            if self._replicas:
                self._degrade()
                return
            raise
        self._install(info)

    def _refresh(self, force: bool = False, deadline: float = 0.0):
        if not self._stale(force):
            return
        from ray_tpu_torch._private.core_worker import get_core_worker

        cw = get_core_worker()
        if cw._loop_running_here():
            # non-blocking: serve from the current cache, refresh in the
            # background (first use on a loop must go through _refresh_async)
            if self._replicas:
                cw.schedule(self._refresh_async(force=True))
                return
            raise RuntimeError(
                "DeploymentHandle used on the event loop before its replica "
                "cache was primed — await handle._refresh_async() first"
            )
        try:
            controller = self._resolve_controller()
            info = ray_tpu_torch.get(
                controller.get_routing_info.remote(self.deployment_name),
                timeout=self._refresh_timeout(deadline),
            )
        except Exception:  # noqa: BLE001 — controller outage: degrade
            if self._replicas:
                self._degrade()
                return
            raise
        self._install(info)

    _QLEN_TTL_S = 1.0

    def _load(self, rid: bytes) -> int:
        """Replica load estimate: probed queue length + our sends since the
        probe; falls back to handle-local in-flight when never probed."""
        cached = self._qlen_cache.get(rid)
        if cached is None:
            return self._inflight.get(rid, 0)
        qlen, sent_snap, _ts = cached
        return qlen + max(0, self._sent.get(rid, 0) - sent_snap)

    def _maybe_probe(self, rid: bytes, replica) -> None:
        """Schedule a background queue_len probe when the cache entry is
        stale — never on the request's critical path."""
        from ray_tpu_torch._private.core_worker import get_core_worker

        now = time.monotonic()
        cached = self._qlen_cache.get(rid)
        if cached is not None and now - cached[2] < self._QLEN_TTL_S:
            return
        started = self._probing.get(rid)
        if started is not None and now - started < 10.0:
            return
        self._probing[rid] = now

        async def probe():
            cw = get_core_worker()
            try:
                qlen = await cw.get_async(replica.queue_len.remote(),
                                          timeout=10)
                with self._lock:
                    self._qlen_cache[rid] = (
                        int(qlen), self._sent.get(rid, 0), time.monotonic())
            except Exception:  # noqa: BLE001 — replica gone; refresh handles it
                pass
            finally:
                self._probing.pop(rid, None)

        try:
            get_core_worker().schedule(probe())
        except Exception:  # noqa: BLE001 — no core worker yet
            self._probing.pop(rid, None)

    # -- routing --------------------------------------------------------

    def _eligible_locked(self) -> List[tuple]:
        """(rid, replica) candidates with ejected outliers filtered out.
        A replica whose probation window passed re-enters with a streak
        one short of re-ejection: the first request is the re-probe, one
        more failure ejects it again immediately. Fails OPEN: if every
        replica is ejected, all of them are candidates (shedding work on
        a guess of total failure would turn a blip into an outage).

        Replicas THIS worker's actor-state cache already records as DEAD
        are dropped outright (the controller applies the same filter in
        get_replicas, but its routing info is cached between refreshes —
        a death notice landing here mid-TTL must not burn a pick, and
        with the retry budget drained would surface as a hard failure
        with a healthy replica sitting right next to the corpse)."""
        dead = None
        try:
            from ray_tpu_torch._private import protocol as pb
            from ray_tpu_torch._private.core_worker import get_core_worker

            states = get_core_worker()._actor_states
            dead = {r._actor_id.binary() for r in self._replicas
                    if (st := states.get(r._actor_id.binary())) is not None
                    and st.state == pb.ACTOR_DEAD}
        except Exception:  # noqa: BLE001 — no core worker yet: skip filter
            dead = None
        now = time.monotonic()
        threshold = _cfg("serve_outlier_consecutive_failures")
        out = []
        for r in self._replicas:
            rid = r._actor_id.binary()
            if dead and rid in dead:
                continue
            until = self._ejected.get(rid)
            if until is not None:
                if now < until:
                    continue
                del self._ejected[rid]
                self._fail_streak[rid] = max(0, threshold - 1)
            out.append((rid, r))
        if not out:
            out = [(r._actor_id.binary(), r) for r in self._replicas]
        return out

    def _saturated_locked(self, candidates: List[tuple]) -> bool:
        """True when EVERY replica reads at-or-above its admitted-request
        capacity on BOTH signals — this handle's own issued-not-consumed
        count (exact for the proxy's one-handle-per-deployment case) AND
        a fresh probed/pinned queue length (cross-handle truth). That is
        the basis for shedding at ingress before a replica RPC is spent.
        NOT the pow-2 _load() estimate: its sent-since-probe delta counts
        requests that already finished, which over-reads absolute load at
        high throughput and would shed a healthy system. Any stale or
        unknown entry reads as headroom: shedding needs evidence."""
        if self._capacity is None or not _cfg("serve_shed_at_ingress"):
            return False
        if not candidates:
            return False
        now = time.monotonic()
        for rid, _r in candidates:
            if self._inflight.get(rid, 0) < self._capacity:
                return False
            cached = self._qlen_cache.get(rid)
            if cached is None or now - cached[2] > 2 * self._QLEN_TTL_S:
                return False
            if cached[0] < self._capacity:
                return False
        return True

    def _note_saturated(self, rid: bytes):
        """A queue rejection is a load reading: pin the cache at capacity
        so the next pick steers away without waiting out a probe."""
        if self._capacity is None:
            return
        with self._lock:
            self._qlen_cache[rid] = (
                self._capacity, self._sent.get(rid, 0), time.monotonic())

    _PREFIX_AFFINITY_MAX = 4096

    def _pick(self, model_id: str = "", deadline: float = 0.0,
              affinity_key: str = "") -> tuple:
        """Power-of-two-choices on probed queue lengths + local deltas
        (reference: router.py:556 + request_router/pow_2_router.py:27),
        with sticky model affinity, soft prefix affinity, outlier
        filtering, and ingress shed."""
        self._refresh(deadline=deadline)
        with self._lock:
            sampled = shed_scope = None
            if model_id:
                arid = self._model_affinity.get(model_id)
                if arid is not None and arid not in self._ejected:
                    for r in self._replicas:
                        if r._actor_id.binary() == arid:
                            # sticky traffic rides the SAME shed/probe
                            # machinery below — an all-multiplexed workload
                            # must not bypass ingress shedding or starve
                            # the sticky replica's qlen probes. Sticky
                            # requests can ONLY go here, so this replica's
                            # saturation alone justifies the shed.
                            sampled = shed_scope = [(arid, r)]
                            i = 0
                            break
            if sampled is None and affinity_key:
                arid = self._prefix_affinity.get(affinity_key)
                if arid is not None and arid not in self._ejected and (
                        self._capacity is None
                        or self._load(arid) < self._capacity):
                    for r in self._replicas:
                        if r._actor_id.binary() == arid:
                            # SOFT sticky: prefer the replica holding the
                            # prefix's KV blocks, but judge shedding on the
                            # FULL eligible set — an affinity miss routes
                            # elsewhere instead of shedding or queueing
                            sampled = [(arid, r)]
                            shed_scope = self._eligible_locked()
                            i = 0
                            break
            if sampled is None:
                candidates = self._eligible_locked()
                n = len(candidates)
                if n == 0:
                    raise RuntimeError(
                        f"deployment {self.deployment_name!r} has no replicas")
                # shed only when EVERY eligible replica is saturated — two
                # saturated samples with an idle third must route, not shed
                shed_scope = candidates
                if n == 1:
                    sampled = candidates
                    i = 0
                else:
                    a, b = random.sample(range(n), 2)
                    sampled = [candidates[a], candidates[b]]
                    i = 0 if self._load(sampled[0][0]) <= self._load(
                        sampled[1][0]) else 1
            if self._saturated_locked(shed_scope):
                self.overload_stats["shed_ingress"] += 1
                from ray_tpu_torch._private import flight_recorder

                flight_recorder.record(
                    "serve", "shed_ingress",
                    deployment=self.deployment_name,
                    capacity=self._capacity)
                shed = BackpressureError(
                    f"deployment {self.deployment_name}: every replica's "
                    f"probed load >= capacity ({self._capacity}) — shedding "
                    f"at ingress",
                    retry_after_s=_cfg("serve_retry_after_s"))
            else:
                shed = None
            rid, picked = sampled[i]
            if shed is None:
                self._inflight[rid] = self._inflight.get(rid, 0) + 1
                # sends must stay visible to _load()'s probe-delta estimate
                self._sent[rid] = self._sent.get(rid, 0) + 1
                if model_id:
                    self._model_affinity[model_id] = rid
                if affinity_key:
                    # remap on every pick (a saturation overflow moves the
                    # key with the blocks that are about to be cached);
                    # LRU-capped so one handle can't grow without bound
                    self._prefix_affinity[affinity_key] = rid
                    self._prefix_affinity.move_to_end(affinity_key)
                    while len(self._prefix_affinity) > \
                            self._PREFIX_AFFINITY_MAX:
                        self._prefix_affinity.popitem(last=False)
        # probe BOTH sampled candidates: refreshing only the winner lets a
        # stale-high entry starve a drained replica forever (it would never
        # be picked, so never re-probed). Sheds probe too, or the
        # saturation verdict could never un-stick.
        for crid, creplica in sampled:
            self._maybe_probe(crid, creplica)
        if shed is not None:
            raise shed
        return rid, picked

    def _done(self, rid: bytes):
        with self._lock:
            if self._inflight.get(rid, 0) > 0:
                self._inflight[rid] -= 1

    # -- health bookkeeping --------------------------------------------

    def _record_success(self, rid: bytes):
        with self._lock:
            self._fail_streak[rid] = 0
            self._budget.on_success()

    def _record_failure(self, rid: bytes):
        """Death/timeout signal. Enough consecutive ones eject the replica
        from routing for a probation window (reference: outlier detection
        in The Tail at Scale / envoy outlier ejection)."""
        with self._lock:
            streak = self._fail_streak.get(rid, 0) + 1
            self._fail_streak[rid] = streak
            if (rid not in self._ejected
                    and streak >= _cfg("serve_outlier_consecutive_failures")):
                self._ejected[rid] = (
                    time.monotonic() + _cfg("serve_outlier_probation_s"))
                self.overload_stats["ejections"] += 1
                from ray_tpu_torch._private import flight_recorder

                flight_recorder.record(
                    "serve", "outlier_ejected",
                    deployment=self.deployment_name,
                    replica=rid.hex()[:12], streak=streak)
                # drop the stale load reading: the probation re-probe must
                # judge the replica on fresh evidence
                self._qlen_cache.pop(rid, None)

    def _spend_retry(self) -> bool:
        with self._lock:
            if self._budget.try_spend():
                self.overload_stats["retries"] += 1
                return True
            self.overload_stats["retries_denied"] += 1
            return False

    # -- submission -----------------------------------------------------

    def _deadline_for(self, timeout_s: Optional[float]) -> float:
        """Resolve the request deadline: explicit timeout_s, bounded by an
        inherited in-flight deadline (nested handle calls inside a replica
        propagate the ingress deadline automatically); else the inherited
        one; else the configured default."""
        inherited = get_request_deadline()
        if timeout_s is None:
            default = _cfg("serve_default_timeout_s")
            own = time.time() + default if default > 0 else 0.0
        elif timeout_s <= 0:
            # explicit non-positive timeout = NO own deadline (matches the
            # serve_default_timeout_s "0 = no deadline" contract and the
            # HTTP/gRPC header parsers) — an inherited one still applies
            own = 0.0
        else:
            own = time.time() + timeout_s
        if inherited and own:
            return min(inherited, own)
        return inherited or own

    def _submit(self, spec: _CallSpec):
        """Route one unary request; returns a _TrackedRef."""
        if spec.deadline and time.time() >= spec.deadline:
            self.overload_stats["expired_before_send"] += 1
            raise DeadlineExceededError(
                f"deployment {self.deployment_name}: request deadline "
                f"expired before routing")
        from ray_tpu_torch.util import tracing

        with tracing.span(f"handle:pick:{self.deployment_name}"):
            rid, replica = self._pick(model_id=spec.model_id,
                                      deadline=spec.deadline,
                                      affinity_key=spec.affinity_key)
        kwargs = dict(spec.kwargs)
        if spec.model_id:
            kwargs["__serve_model_id"] = spec.model_id
        if spec.deadline:
            kwargs[DEADLINE_KWARG] = spec.deadline
        try:
            if spec.method is None:
                ref = replica.handle_request.remote(*spec.args, **kwargs)
            else:
                ref = replica.call_method.remote(
                    spec.method, *spec.args, **kwargs)
            return _TrackedRef(ref, self, rid, spec)
        except Exception:
            self._done(rid)
            self._refresh(force=True)
            raise

    def _submit_stream(self, spec: _CallSpec) -> "_TrackedStream":
        if spec.deadline and time.time() >= spec.deadline:
            self.overload_stats["expired_before_send"] += 1
            raise DeadlineExceededError(
                f"deployment {self.deployment_name}: request deadline "
                f"expired before routing")
        from ray_tpu_torch.util import tracing

        with tracing.span(f"handle:pick:{self.deployment_name}"):
            rid, replica = self._pick(deadline=spec.deadline,
                                      affinity_key=spec.affinity_key)
        kwargs = dict(spec.kwargs)
        if spec.deadline:
            kwargs[DEADLINE_KWARG] = spec.deadline
        try:
            gen = replica.handle_request_stream.options(
                num_returns="streaming").remote(*spec.args, **kwargs)
            return _TrackedStream(gen, self, rid, deadline=spec.deadline)
        except Exception:
            self._done(rid)
            self._refresh(force=True)
            raise

    def remote(self, *args, **kwargs):
        """Route one request; returns an ObjectRef of the result."""
        return self._submit(
            _CallSpec(None, args, kwargs, deadline=self._deadline_for(None)))

    def method(self, method_name: str) -> "_ConfiguredCaller":
        """Handle for a non-__call__ method (reference: handle.method_name)."""
        return _ConfiguredCaller(self, method=method_name)

    def __reduce__(self):
        return (_rebuild_handle, (self.deployment_name,))


class _ConfiguredCaller:
    """A handle view carrying per-request options (stream / model id /
    timeout) and an optional method name. Chainable: unset fields keep
    their current values across options() calls."""

    __slots__ = ("_handle", "_method", "_model_id", "_stream", "_timeout_s",
                 "_affinity_key")

    def __init__(self, handle: DeploymentHandle, method: Optional[str] = None,
                 model_id: str = "", stream: bool = False,
                 timeout_s: Optional[float] = None,
                 affinity_key: str = ""):
        self._handle = handle
        self._method = method
        self._model_id = model_id
        self._stream = stream
        self._timeout_s = timeout_s
        self._affinity_key = affinity_key

    def options(self, *, multiplexed_model_id: Optional[str] = None,
                stream: Optional[bool] = None,
                timeout_s: Optional[float] = None,
                affinity_key: Optional[str] = None) -> "_ConfiguredCaller":
        merged = _ConfiguredCaller(
            self._handle, self._method,
            self._model_id if multiplexed_model_id is None
            else multiplexed_model_id,
            self._stream if stream is None else stream,
            self._timeout_s if timeout_s is None else timeout_s,
            self._affinity_key if affinity_key is None else affinity_key,
        )
        if merged._model_id and merged._stream:
            raise ValueError(
                "stream=True with multiplexed_model_id is not supported yet")
        return merged

    def method(self, method_name: str) -> "_ConfiguredCaller":
        return _ConfiguredCaller(self._handle, method_name, self._model_id,
                                 self._stream, self._timeout_s,
                                 self._affinity_key)

    def remote(self, *args, **kwargs):
        h = self._handle
        spec = _CallSpec(self._method, args, kwargs,
                         model_id=self._model_id,
                         deadline=h._deadline_for(self._timeout_s),
                         affinity_key=self._affinity_key)
        if self._stream:
            if self._method is not None:
                raise ValueError(
                    "streaming a non-__call__ method is not supported")
            return h._submit_stream(spec)
        return h._submit(spec)


class _TrackedStream:
    """Iterator over a streaming request's item REFS with handle load
    accounting: the replica's in-flight slot frees when the stream ends
    (or is dropped — the generator's release cancels the producer). The
    request deadline is enforced per chunk on the consumer side too, so a
    wedged replica can't hold a caller past its budget."""

    def __init__(self, gen, handle: "DeploymentHandle", rid: bytes,
                 deadline: float = 0.0):
        self._gen = gen
        self._handle = handle
        self._rid = rid
        self._deadline = deadline
        self._finished = False

    def _finish(self, ok: bool = True):
        if not self._finished:
            self._finished = True
            self._handle._done(self._rid)
            if ok:
                self._handle._record_success(self._rid)

    def _check_deadline(self):
        if self._deadline and time.time() >= self._deadline:
            self._finish(ok=False)
            raise DeadlineExceededError(
                "stream deadline expired awaiting the next chunk")

    def note_failure(self, e: BaseException) -> BaseException:
        """Consumer-reported mid-stream failure. The streaming plane can
        deliver a replica's mid-generation exception as the final errored
        ITEM ref, which the consumer awaits OUTSIDE this iterator — the
        proxies call this from their catch so ejection streaks, forced
        refresh, and saturation pinning still happen for streaming-only
        workloads. Idempotent; returns the unwrapped typed error."""
        if self._finished:
            return unwrap(e)
        return self._classify(e)

    def _classify(self, e: BaseException):
        """Mid-stream failure bookkeeping (no retry: items already
        delivered cannot be replayed transparently)."""
        self._finished = True
        self._handle._done(self._rid)
        err = unwrap(e)
        if isinstance(err, (ray_tpu_torch.ActorDiedError,
                            ray_tpu_torch.ActorUnavailableError,
                            DeadlineExceededError)):
            self._handle._record_failure(self._rid)
            self._handle._refresh(force=True)
        elif isinstance(err, BackpressureError):
            # a stream rejected at admission is a load reading: feed the
            # router's cache so the next pick steers away
            self._handle._note_saturated(self._rid)
        return err

    def __iter__(self):
        return self

    def __next__(self):
        self._check_deadline()
        try:
            return next(self._gen)
        except StopIteration:
            self._finish()
            raise
        except BaseException as e:  # noqa: BLE001 — classify + rethrow
            err = self._classify(e)
            raise err from None

    def __aiter__(self):
        return self

    async def __anext__(self):
        self._check_deadline()
        try:
            return await self._gen.__anext__()
        except StopAsyncIteration:
            self._finish()
            raise
        except BaseException as e:  # noqa: BLE001 — classify + rethrow
            err = self._classify(e)
            raise err from None

    def __del__(self):
        try:
            # outcome unknown (consumer abandoned the stream): free the
            # in-flight slot but record neither success nor failure —
            # abandons of a broken stream must not reset its ejection
            # streak or deposit retry budget
            self._finish(ok=False)
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass


def _rebuild_handle(name: str) -> DeploymentHandle:
    # controller resolution is lazy: unpickling may run on the core event
    # loop (task-arg deserialization), where get_actor would deadlock
    return DeploymentHandle(name)


class _TrackedRef:
    """Wraps the result ref so the router's in-flight count drops when the
    result is consumed (or the wrapper is GC'd), and failovers ride the
    retry budget: replica deaths and queue rejections resubmit on another
    replica while budget and deadline allow."""

    __slots__ = ("_ref", "_handle", "_idx", "_consumed", "_spec")

    def __init__(self, ref, handle: DeploymentHandle, idx: bytes,
                 spec: Optional[_CallSpec] = None):
        self._ref = ref
        self._handle = handle
        self._idx = idx
        self._consumed = False
        self._spec = spec

    # -- shared retry logic --------------------------------------------

    async def _await_ref(self):
        return await self._ref

    def _bounded_timeout(self, timeout: Optional[float]) -> Optional[float]:
        d = self._spec.deadline if self._spec else 0.0
        if not d:
            return timeout
        remaining = max(0.05, d - time.time())
        return remaining if timeout is None else min(timeout, remaining)

    def _deadline_spent(self) -> bool:
        d = self._spec.deadline if self._spec else 0.0
        return bool(d) and time.time() >= d

    def _classify(self, e: BaseException) -> tuple:
        """-> (action, err): action in {"raise", "failover", "shed_retry"}.
        Bookkeeping (streaks, budget) happens here, exactly once per
        failure, shared by the sync and async result paths."""
        h = self._handle
        err = unwrap(e)
        if isinstance(err, DeadlineExceededError):
            # slow-to-deadline counts toward ejection like a timeout
            h._record_failure(self._idx)
            return "raise", err
        if isinstance(err, BackpressureError):
            # a queue rejection is load, not ill health: feed the router's
            # cache, not the ejection streak
            h._note_saturated(self._idx)
            if self._spec is not None and not self._deadline_spent() \
                    and h._spend_retry():
                return "shed_retry", err
            return "raise", err
        if isinstance(err, (ray_tpu_torch.ActorDiedError,
                            ray_tpu_torch.ActorUnavailableError)):
            h._record_failure(self._idx)
            if self._spec is not None and not self._deadline_spent() \
                    and h._spend_retry():
                return "failover", err
            return "raise", err
        if isinstance(err, ray_tpu_torch.GetTimeoutError):
            if self._deadline_spent():
                # the get() was bounded by the request deadline, not the
                # caller's own timeout: surface it typed, count it as a
                # replica timeout
                err = DeadlineExceededError(
                    "request deadline expired awaiting the result")
                h._record_failure(self._idx)
            # a caller-side timeout with NO deadline says nothing about
            # replica health (the caller may just be polling) — no streak
            return "raise", err
        if not isinstance(err, Exception):
            # CancelledError (client disconnect), KeyboardInterrupt, ...:
            # not a request outcome — neither success nor failure, or an
            # overload-driven cancellation storm would inflate the retry
            # budget exactly when it must stay tight
            return "raise", err
        # an application exception: the replica did its job
        h._record_success(self._idx)
        return "raise", err

    def _adopt(self, retry: "_TrackedRef"):
        retry._consumed = True  # this wrapper takes the in-flight slot
        self._ref = retry._ref
        self._idx = retry._idx
        self._consumed = False

    def result(self, timeout: Optional[float] = 60.0):
        attempts = 4
        while True:
            try:
                value = ray_tpu_torch.get(self._ref,
                                    timeout=self._bounded_timeout(timeout))
            except BaseException as e:  # noqa: BLE001 — classified below
                self._consume()
                action, err = self._classify(e)
                if action == "raise":
                    raise err from None
                attempts -= 1
                if attempts <= 0:
                    raise err from None
                delay = 0.0 if action == "shed_retry" else 0.5 * (4 - attempts)
                while True:
                    # give the controller's reconcile loop (1 s cadence)
                    # time to replace the dead replica before re-routing
                    if delay:
                        time.sleep(delay)
                    try:
                        self._handle._refresh(
                            force=(action == "failover"),
                            deadline=(self._spec.deadline
                                      if self._spec else 0.0))
                        self._adopt(self._handle._submit(self._spec))
                        break
                    except (RuntimeError, ray_tpu_torch.RayTpuError,
                            BackpressureError):
                        # no replicas at this instant / shed again / the
                        # refresh itself failed on an empty set: keep the
                        # ORIGINAL typed failure as the surfaced error,
                        # within the attempt budget
                        attempts -= 1
                        if attempts <= 0 or self._deadline_spent():
                            raise err from None
                        delay = max(delay, 0.5)
            else:
                self._consume()
                self._handle._record_success(self._idx)
                return value

    async def _result_async(self):
        """Await path with the same failover semantics as result() —
        the HTTP/gRPC proxies live on the event loop and must get the
        same budget-gated retries the sync path has."""
        import asyncio

        async def _await_bounded():
            d = self._spec.deadline if self._spec else 0.0
            if not d:
                return await self._ref
            try:
                return await asyncio.wait_for(
                    self._await_ref(), max(0.05, d - time.time()))
            except (asyncio.TimeoutError, TimeoutError):
                raise DeadlineExceededError(
                    "request deadline expired awaiting the result") from None

        attempts = 4
        while True:
            try:
                value = await _await_bounded()
            except BaseException as e:  # noqa: BLE001 — classified below
                self._consume()
                action, err = self._classify(e)
                if action == "raise":
                    raise err from None
                attempts -= 1
                if attempts <= 0:
                    raise err from None
                delay = 0.0 if action == "shed_retry" else 0.5 * (4 - attempts)
                while True:
                    if delay:
                        await asyncio.sleep(delay)
                    try:
                        await self._handle._refresh_async(
                            force=(action == "failover"),
                            deadline=(self._spec.deadline
                                      if self._spec else 0.0))
                        self._adopt(self._handle._submit(self._spec))
                        break
                    except (RuntimeError, ray_tpu_torch.RayTpuError,
                            BackpressureError):
                        attempts -= 1
                        if attempts <= 0 or self._deadline_spent():
                            raise err from None
                        delay = max(delay, 0.5)
            else:
                self._consume()
                self._handle._record_success(self._idx)
                return value

    def _consume(self):
        if not self._consumed:
            self._consumed = True
            self._handle._done(self._idx)

    # duck-type as an ObjectRef for ray_tpu_torch.get()
    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_ref"), name)

    def __await__(self):
        return self._result_async().__await__()

    def __del__(self):
        try:
            self._consume()
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass
