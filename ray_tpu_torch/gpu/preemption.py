"""GCE preemption watcher: turn the 30-90s of warning a spot or
maintenance-scheduled GPU VM gets into a graceful drain.

The port's counterpart of ``ray_tpu/tpu/preemption.py``. GCE GPU VMs (A3,
H100) expose the same metadata endpoints as TPU VMs, so the endpoints, the
terminal events and the watcher's behaviour are the same.

Reference surface: the GCE metadata server's maintenance-event and
preemption endpoints (the signals python/ray/autoscaler and cloud
training loops poll) plus the ACPI SIGTERM a preempted VM receives.
Redesign: one watcher object owned by the node daemon, speaking the
metadata HTTP surface through a swappable `MetadataTransport` seam so the
exact production path runs offline against `FakeMetadataTransport`.

On a notice the watcher fires exactly once. In legacy (reactive) mode it
invokes `on_notice(reason, deadline_s)` immediately; the daemon's
`_self_drain` routes it through the control store's DrainNode protocol
(stop granting leases, finish running work, replicate primary copies,
migrate actors, exit with an expected-termination record).

With a `publish` callable and `preempt_proactive` on, the watcher instead
publishes a TTL'd `report_preemption_notice{node_id, deadline_s}` into the
control store and keeps re-publishing it every `preempt_republish_period_s`
(idempotent — the store only refreshes the TTL, never extends the deadline,
so the notice also survives a control-store failover mid-window). The node
sits in the reversible PREEMPTING state while the autoscaler pre-provisions
replacement capacity; the drain itself is started by the control plane once
replacements register, and only if that hasn't happened by
`preempt_drain_grace_frac` of the deadline does the watcher force the
legacy self-drain with whatever deadline remains — overlapping node boot
with the drain window instead of serializing them.
"""

from __future__ import annotations

import asyncio
import logging
import signal
from typing import Awaitable, Callable, Optional

from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.protocol import DRAIN_REASON_PREEMPTION

logger = logging.getLogger(__name__)

_METADATA_BASE = ("http://metadata.google.internal/computeMetadata/v1/"
                  "instance")
MAINTENANCE_URL = f"{_METADATA_BASE}/maintenance-event"
PREEMPTED_URL = f"{_METADATA_BASE}/preempted"

# maintenance-event values that mean "this host is about to go away"
_TERMINAL_EVENTS = ("TERMINATE_ON_HOST_MAINTENANCE", "MIGRATE_ON_HOST_MAINTENANCE")


class MetadataTransport:
    """The HTTP seam: get(url) -> response body string (or raise)."""

    def get(self, url: str) -> str:
        raise NotImplementedError


class GceMetadataTransport(MetadataTransport):
    """Real transport against the GCE metadata server."""

    def __init__(self, timeout: float = 2.0):
        self.timeout = timeout

    def get(self, url: str) -> str:
        import urllib.request

        req = urllib.request.Request(
            url, headers={"Metadata-Flavor": "Google"})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return resp.read().decode("utf-8", "replace").strip()


class FakeMetadataTransport(MetadataTransport):
    """Offline simulation: tests flip `maintenance_event`/`preempted` and
    the watcher reacts exactly as it would on a real GPU VM."""

    def __init__(self):
        self.maintenance_event = "NONE"
        self.preempted = "FALSE"
        self.calls = 0

    def schedule_maintenance(self):
        self.maintenance_event = "TERMINATE_ON_HOST_MAINTENANCE"

    def preempt(self):
        self.preempted = "TRUE"

    def clear(self):
        """The scheduled event passed / the reclaim was cancelled (spot
        capacity returned). Pairs with PreemptionWatcher.rearm() in elastic
        soak tests that preempt the same simulated host repeatedly."""
        self.maintenance_event = "NONE"
        self.preempted = "FALSE"

    def get(self, url: str) -> str:
        self.calls += 1
        if url == MAINTENANCE_URL:
            return self.maintenance_event
        if url == PREEMPTED_URL:
            return self.preempted
        raise ValueError(f"FakeMetadataTransport: unhandled {url}")


class PreemptionWatcher:
    """Polls the metadata endpoints (and optionally hooks SIGTERM) and
    fires `on_notice(reason, deadline_s)` once when the host is scheduled
    to die. Owned by the node daemon; runs on its event loop."""

    def __init__(self, on_notice: Callable[[str, float], Awaitable],
                 transport: Optional[MetadataTransport] = None,
                 poll_period_s: Optional[float] = None,
                 drain_deadline_s: Optional[float] = None,
                 hook_sigterm: bool = False,
                 publish: Optional[Callable[[float], Awaitable]] = None,
                 drain_started: Optional[Callable[[], bool]] = None):
        self.on_notice = on_notice
        self.transport = transport or GceMetadataTransport()
        self.poll_period_s = (
            poll_period_s
            if poll_period_s is not None
            else GLOBAL_CONFIG.get("preemption_poll_period_s"))
        self.drain_deadline_s = (
            drain_deadline_s
            if drain_deadline_s is not None
            else GLOBAL_CONFIG.get("drain_deadline_s"))
        self.hook_sigterm = hook_sigterm
        # proactive seam: publish(deadline_remaining_s) files the TTL'd
        # notice at the control store; drain_started() tells the republish
        # loop the control plane has taken over (daemon began its drain)
        self.publish = publish
        self.drain_started = drain_started
        self.fired = False
        self._stopped = False
        # telemetry for tests/bench: how many times the notice was
        # (re-)published, and whether the grace deadline forced the drain
        self.publishes = 0
        self.forced_drains = 0

    def stop(self):
        self._stopped = True

    def rearm(self):
        """Reset the one-shot latch so a NEW `run()` can fire again.

        A GCE maintenance event can be cancelled (or a drain undrained by
        the autoscaler when capacity demand returns) — a watcher that
        stays latched after a survived notice would sleep through the
        NEXT reclaim of the same host. `run()` returns once it fires, so
        the owner must re-arm AND schedule `run()` again (spawn a fresh
        task); rearm alone does not resurrect the finished poll loop. The
        elastic train plane preempts the same node repeatedly across
        shrink/regrow cycles; re-arm after the drain resolves."""
        self.fired = False

    async def _fire(self, cause: str):
        if self.fired:
            return
        self.fired = True
        if self.publish is not None and GLOBAL_CONFIG.get("preempt_proactive"):
            await self._fire_proactive(cause)
            return
        logger.warning("preemption notice (%s): draining node with %.1fs "
                       "deadline", cause, self.drain_deadline_s)
        try:
            await self.on_notice(DRAIN_REASON_PREEMPTION,
                                 self.drain_deadline_s)
        except Exception:  # noqa: BLE001 — the drain path logs its own
            logger.exception("preemption drain callback failed")

    async def _fire_proactive(self, cause: str):
        """Publish-and-wait: keep the TTL'd notice fresh while the control
        plane pre-provisions, force the self-drain at the grace point."""
        loop = asyncio.get_running_loop()
        deadline_ts = loop.time() + self.drain_deadline_s
        grace_frac = GLOBAL_CONFIG.get("preempt_drain_grace_frac")
        grace_ts = loop.time() + self.drain_deadline_s * grace_frac
        period = GLOBAL_CONFIG.get("preempt_republish_period_s")
        logger.warning(
            "preemption notice (%s): publishing PREEMPTING with %.1fs "
            "deadline, drain grace at %.1fs", cause, self.drain_deadline_s,
            self.drain_deadline_s * grace_frac)
        while not self._stopped:
            if self.drain_started is not None and self.drain_started():
                # the control plane started the drain (replacement capacity
                # registered, or an operator drained us) — the daemon's
                # normal drain orchestration owns the exit from here
                return
            now = loop.time()
            if now >= grace_ts:
                break
            try:
                # idempotent: the store refreshes the TTL and keeps
                # min(prior, new) as the deadline — re-publishing every
                # period is also what survives a control-store failover
                # mid-notice (the new primary may have an expired/absent
                # entry until this lands)
                await self.publish(max(0.1, deadline_ts - now))
                self.publishes += 1
            except Exception:  # noqa: BLE001 — store unreachable/failover
                logger.warning("preemption-notice publish failed; retrying",
                               exc_info=True)
            await asyncio.sleep(
                max(0.05, min(period, grace_ts - loop.time())))
        if self._stopped:
            return
        self.forced_drains += 1
        remaining = max(0.1, deadline_ts - loop.time())
        logger.warning("preemption drain grace expired: forcing self-drain "
                       "with %.1fs remaining", remaining)
        try:
            await self.on_notice(DRAIN_REASON_PREEMPTION, remaining)
        except Exception:  # noqa: BLE001 — the drain path logs its own
            logger.exception("preemption drain callback failed")

    def _poll_once(self) -> Optional[str]:
        """Returns the cause string when a terminal notice is present."""
        try:
            ev = self.transport.get(MAINTENANCE_URL)
            if ev in _TERMINAL_EVENTS:
                return f"maintenance-event {ev}"
            pre = self.transport.get(PREEMPTED_URL)
            if pre.upper() == "TRUE":
                return "instance preempted"
        except Exception:  # noqa: BLE001 — metadata server unreachable
            # (not on GCE, or transient): nothing to act on
            return None
        return None

    async def run(self):
        if self.hook_sigterm:
            # a preempted VM gets SIGTERM ~30s before hard power-off; hook
            # it so the drain starts even if the metadata poll is slow
            loop = asyncio.get_running_loop()
            try:
                loop.add_signal_handler(
                    signal.SIGTERM,
                    lambda: loop.create_task(self._fire("SIGTERM")))
            except (NotImplementedError, RuntimeError, ValueError):
                pass  # non-main thread / unsupported platform
        while not self._stopped and not self.fired:
            cause = await asyncio.to_thread(self._poll_once)
            if cause:
                await self._fire(cause)
                return
            await asyncio.sleep(self.poll_period_s)


__all__ = [
    "FakeMetadataTransport",
    "GceMetadataTransport",
    "MetadataTransport",
    "PreemptionWatcher",
]
