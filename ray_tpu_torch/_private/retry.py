"""Unified retry policy: capped exponential backoff with decorrelated
jitter and deadline propagation.

One policy shared by every retried control-plane operation — RPC calls
(`runtime.rpc.RpcClient`), object fetch/reconstruction (`_private.recovery`),
lease requests and task resubmission (`_private.core_worker`) — replacing the
ad-hoc `base * 2**attempt` sleeps that used to be re-derived per call site.
Capability parity with the reference's retryable client (reference:
src/ray/rpc/retryable_grpc_client.h — server_unavailable_timeout +
exponential backoff with jitter).

Jitter is DECORRELATED (AWS architecture-blog style): each delay is drawn
uniformly from [base, prev * 3], capped. Compared to full jitter it keeps a
rising floor (quick first retries) while still desynchronizing retry storms
from many clients hitting one recovering server.

Determinism: when the chaos harness is seeded (`testing_chaos_seed`), jitter
draws come from the per-process seeded chaos PRNG, so a failing schedule
replays exactly from the seed.
"""

from __future__ import annotations

import time
from typing import Optional


class DeadlineExceeded(TimeoutError):
    """The operation's total deadline expired between/through retries."""


class RetryPolicy:
    """Immutable backoff shape: start at `base_s`, cap at `max_s`, widen by
    `multiplier` per attempt (3.0 = decorrelated-jitter sweet spot)."""

    __slots__ = ("base_s", "max_s", "multiplier")

    def __init__(self, base_s: float = 0.2, max_s: float = 5.0,
                 multiplier: float = 3.0):
        if base_s <= 0 or multiplier < 1.0:
            raise ValueError(
                f"bad retry policy: base={base_s} mult={multiplier}")
        self.base_s = base_s
        # clamp rather than raise: these values flow from user config
        # (retry_base_s/retry_max_s) on EVERY rpc call — a cap below the
        # base must degrade to constant-delay retries, not brick the
        # control plane with a ValueError per call
        self.max_s = max(max_s, base_s)
        self.multiplier = multiplier

    def backoff(self, deadline: Optional[float] = None,
                rng=None) -> "Backoff":
        return Backoff(self, deadline=deadline, rng=rng)


DEFAULT_POLICY = RetryPolicy()


class Backoff:
    """Per-operation backoff state. `next_delay()` yields the next sleep;
    a `deadline` (time.monotonic() timestamp) propagates through: delays are
    clipped to the remaining budget and `expired()` flips once it's spent,
    so a caller-level timeout bounds the whole retry chain instead of each
    attempt independently."""

    __slots__ = ("policy", "deadline", "_rng", "_prev", "attempts")

    def __init__(self, policy: RetryPolicy = DEFAULT_POLICY, *,
                 deadline: Optional[float] = None, rng=None):
        self.policy = policy
        self.deadline = deadline
        self._rng = rng
        self._prev = policy.base_s
        self.attempts = 0

    def _random(self):
        if self._rng is None:
            # resolved lazily: the chaos seed may be applied after import
            from ray_tpu_torch._private import chaos

            self._rng = chaos.rng()
        return self._rng

    def remaining(self) -> Optional[float]:
        """Seconds left until the deadline (None = unbounded)."""
        if self.deadline is None:
            return None
        return max(0.0, self.deadline - time.monotonic())

    def expired(self) -> bool:
        rem = self.remaining()
        return rem is not None and rem <= 0.0

    def clamp(self, timeout: Optional[float]) -> Optional[float]:
        """Per-attempt timeout bounded by the remaining total budget."""
        rem = self.remaining()
        if rem is None:
            return timeout
        if timeout is None:
            return rem
        return min(timeout, rem)

    def next_delay(self) -> float:
        """Next backoff delay. Raises DeadlineExceeded when the deadline
        leaves no room for another attempt."""
        p = self.policy
        lo = p.base_s
        hi = max(lo, min(p.max_s, self._prev * p.multiplier))
        delay = lo if hi <= lo else self._random().uniform(lo, hi)
        self._prev = delay
        self.attempts += 1
        rem = self.remaining()
        if rem is not None:
            if rem <= 0.0:
                raise DeadlineExceeded(
                    f"deadline exhausted after {self.attempts} attempt(s)")
            delay = min(delay, rem)
        return delay

    async def sleep(self):
        """Sleep the next backoff delay (asyncio)."""
        import asyncio

        await asyncio.sleep(self.next_delay())


def deadline_from_timeout(timeout: Optional[float]) -> Optional[float]:
    """Convert a relative timeout into an absolute monotonic deadline."""
    return None if timeout is None else time.monotonic() + timeout
