"""Control-store HA coordination: leadership lease, fencing epochs, and
client-side failover telemetry.

Leadership (reference: gcs leader election via k8s Lease objects; here the
shared persist dir IS the coordination medium) is two signals layered:

  * an exclusive flock on `<dir>/LEADER` — kernel-released the instant the
    leader process dies, so a standby parked on it wakes with zero polling
    latency on the common kill/crash path;
  * a lease file `<dir>/LEASE.json` `{epoch, pid, ts}` the active leader
    renews every `store_fence_epoch_renew_s` — a WEDGED leader (alive, so
    the flock never frees) goes stale after `store_failover_timeout_s` and
    the standby takes over anyway.

Every takeover bumps the fencing epoch under a short-lived flock on
`<dir>/LEASE.lock` (atomic read-modify-write even between racing standbys).
The old leader discovers the bump at its next renewal — `renew()` returns
False — and must exit immediately; the persistence backends additionally
refuse its late mutations (persistence.FencedError), so even a zombie that
never gets to run its renewal check cannot split-brain the durable state.

Client-side telemetry (`record_store_reconnect`): every control-store
subscriber calls this from its resubscribe path, exporting
`rt_store_reconnect_seconds` (outage observed by that client) and
`rt_store_failovers_total` (reconnects whose subscribe-reply seq proved a
NEW store incarnation, i.e. a restart/failover rather than a TCP blip),
plus a flight-recorder event in every process's ring.
"""

from __future__ import annotations

import fcntl
import json
import logging
import os
import time
from typing import Optional

from ray_tpu_torch._private import flight_recorder

logger = logging.getLogger(__name__)

LEASE_FILE = "LEASE.json"
LEASE_LOCK = "LEASE.lock"
LEADER_LOCK = "LEADER"


class LeaderLease:
    """The epoch-carrying leadership lease over one persist dir."""

    def __init__(self, persist_dir: str):
        self.dir = persist_dir
        os.makedirs(persist_dir, exist_ok=True)
        self.lease_path = os.path.join(persist_dir, LEASE_FILE)
        self.lock_path = os.path.join(persist_dir, LEASE_LOCK)
        self.epoch: Optional[int] = None

    # -- primitives -----------------------------------------------------

    def read(self) -> dict:
        try:
            with open(self.lease_path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def _write(self, lease: dict) -> None:
        tmp = self.lease_path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(lease, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.lease_path)

    def _locked(self):
        f = open(self.lock_path, "a+")
        fcntl.flock(f.fileno(), fcntl.LOCK_EX)
        return f

    # -- protocol -------------------------------------------------------

    def acquire(self) -> int:
        """Bump the fencing epoch and claim the lease. Returns the new
        epoch. Atomic across racing processes (flock'd RMW)."""
        lock = self._locked()
        try:
            prev = self.read()
            epoch = int(prev.get("epoch", 0)) + 1
            self._write({"epoch": epoch, "pid": os.getpid(),
                         "ts": time.time()})
            self.epoch = epoch
            return epoch
        finally:
            lock.close()  # releases the flock

    def renew(self) -> bool:
        """Refresh the lease timestamp. False = FENCED: another process
        bumped the epoch past ours — the caller must stop serving NOW."""
        if self.epoch is None:
            return False
        lock = self._locked()
        try:
            cur = self.read()
            if int(cur.get("epoch", 0)) != self.epoch:
                return False
            self._write({"epoch": self.epoch, "pid": os.getpid(),
                         "ts": time.time()})
            return True
        finally:
            lock.close()

    def staleness_s(self) -> float:
        """Seconds since the current holder last renewed (inf = no lease
        ever written)."""
        cur = self.read()
        ts = cur.get("ts")
        if ts is None:
            return float("inf")
        return max(0.0, time.time() - float(ts))


# ---------------------------------------------------------------------------
# client-side failover telemetry
# ---------------------------------------------------------------------------

def _metrics():
    # constructed per call: Metric.__new__ returns the registered instance
    # on matching re-registration, and a module-level cache would pin
    # orphans across the test harness's registry resets
    from ray_tpu_torch.util.metrics import Counter, Histogram

    return {
        "failovers": Counter(
            "rt_store_failovers_total",
            "Control-store reconnects that landed on a NEW store "
            "incarnation (the resubscribe reply's publish seq/version did "
            "not match the stream this client was on): restarts and "
            "standby failovers, counted once per subscriber.",
            tag_keys=("role",)),
        "reconnect": Histogram(
            "rt_store_reconnect_seconds",
            "Control-store outage as observed by one subscriber: transport "
            "loss to successful resubscribe (detection + takeover + "
            "reconnect, the client half of failover wall time).",
            boundaries=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                        30.0, 60.0),
            tag_keys=("role",)),
    }


def record_store_reconnect(role: str, outage_s: Optional[float],
                           new_incarnation: bool) -> None:
    """Called from every control-store subscriber's resubscribe path after
    a re-established connection."""
    try:
        m = _metrics()
        tags = {"role": role}
        if outage_s is not None:
            m["reconnect"].observe(outage_s, tags=tags)
        if new_incarnation:
            m["failovers"].inc(1, tags=tags)
        flight_recorder.record(
            "store", "reconnect", role=role,
            outage_s=None if outage_s is None else round(outage_s, 4),
            failover=new_incarnation)
    except Exception:  # noqa: BLE001 — telemetry must never wedge recovery
        logger.debug("store-reconnect telemetry failed", exc_info=True)
