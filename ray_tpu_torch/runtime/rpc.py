"""Asyncio msgpack-framed RPC with retries, pub/sub streams, and chaos injection.

This is the control-plane transport used by the control store, node daemons, and
workers. Capability parity with the reference's RPC layer
(reference: src/ray/rpc/grpc_server.h:94, client_call.h:196, retryable_grpc_client.h)
redesigned on asyncio instead of gRPC completion queues: one length-prefixed
msgpack frame per message over TCP or unix sockets, request/response correlation
by id, server-push frames for subscriptions (replacing the reference's long-poll
pub/sub, src/ray/pubsub/publisher.h:357).

Chaos hooks from `_private.chaos` fire on every dispatch, mirroring
src/ray/rpc/rpc_chaos.h and src/ray/asio/asio_chaos.h.
"""

from __future__ import annotations

import asyncio
from ray_tpu_torch._private.aio import spawn
import itertools
import logging
import struct
import time
from typing import Any, Awaitable, Callable, Dict, Optional, Tuple

import msgpack

from ray_tpu_torch._private import chaos
from ray_tpu_torch._private import fastpath as _fastpath
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.errors import RpcError
from ray_tpu_torch._private.retry import DeadlineExceeded, RetryPolicy


class RpcConnectionLost(RpcError):
    """Transport-level failure: the peer connection dropped (retryable)."""

logger = logging.getLogger(__name__)

_FRAME = struct.Struct("<I")
MAX_FRAME = 512 * 1024 * 1024

# frame kinds
_REQ, _RESP, _ERR, _PUSH = 0, 1, 2, 3

# reserved push "channel" carrying a coalesced batch of (channel, message)
# pairs — one frame per subscriber per flush window instead of one per event
# (the control store's PubSub emits these; _dispatch_frame unwraps them so
# per-channel callbacks never see the envelope)
BATCH_CHANNEL = "_batch"


def _pack(obj) -> bytes:
    payload = msgpack.packb(obj, use_bin_type=True)
    return _FRAME.pack(len(payload)) + payload


async def _read_frame(reader: asyncio.StreamReader, counter=None):
    header = await reader.readexactly(_FRAME.size)
    (length,) = _FRAME.unpack(header)
    if length > MAX_FRAME:
        raise RpcError(f"Frame too large: {length}")
    payload = await reader.readexactly(length)
    if counter is not None:
        counter[0] += _FRAME.size + length
    return msgpack.unpackb(payload, raw=False)


def _drain_splitter(splitter) -> list:
    """Pull every complete frame out of the native splitter, decoded to the
    same (kind, req_id, method, payload) shape _read_frame yields. The C++
    side pre-parses the header; only the payload value goes through the
    msgpack unpacker — and the whole available chunk is handled in one
    event-loop iteration (batched completion dispatch)."""
    out = []
    while True:
        fr = splitter.next()
        if fr is None:
            return out
        kind, req_id, method, payload = fr
        if kind is None:
            # header shape the native parser defers on: unpack whole frame
            kind, req_id, method, decoded = msgpack.unpackb(
                payload, raw=False)
        else:
            method = method.decode()
            decoded = msgpack.unpackb(payload, raw=False)
        out.append((kind, req_id, method, decoded))


Handler = Callable[..., Awaitable[Any]]


class RpcServer:
    """Serves named methods; supports server→client push for subscriptions."""

    def __init__(self, name: str = "rpc"):
        self.name = name
        self._handlers: Dict[str, Handler] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: Dict[int, asyncio.StreamWriter] = {}
        self._conn_counter = itertools.count()
        self._on_disconnect: list[Callable[[int], None]] = []

    def register(self, method: str, handler: Handler) -> None:
        self._handlers[method] = handler

    def register_service(self, service: object) -> None:
        """Register every `rpc_<name>` coroutine method of `service`."""
        for attr in dir(service):
            if attr.startswith("rpc_"):
                self.register(attr[4:], getattr(service, attr))

    def on_disconnect(self, cb: Callable[[int], None]) -> None:
        self._on_disconnect.append(cb)

    async def start(self, host: str = "127.0.0.1", port: int = 0, unix_path: str | None = None):
        if unix_path:
            self._server = await asyncio.start_unix_server(self._handle_conn, path=unix_path)
            self.address = unix_path
            self.port = None
        else:
            self._server = await asyncio.start_server(self._handle_conn, host, port)
            self.port = self._server.sockets[0].getsockname()[1]
            self.address = f"{host}:{self.port}"
        return self.address

    async def stop(self):
        # Close live connections BEFORE wait_closed(): since Python 3.12,
        # Server.wait_closed() also waits for active connection handlers, so
        # awaiting it first deadlocks while clients are still connected.
        for w in list(self._conns.values()):
            w.close()
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    def push(self, conn_id: int, channel: str, message: Any) -> bool:
        """Push a message to a connected client (for subscriptions)."""
        w = self._conns.get(conn_id)
        if w is None or w.is_closing():
            return False
        try:
            w.write(_pack([_PUSH, 0, channel, message]))
            return True
        except (ConnectionError, RuntimeError):
            return False

    def push_batch(self, conn_id: int, items: list) -> bool:
        """Push a coalesced batch of (channel, message) pairs as ONE frame
        (the fanout amortization: a churn wave's worth of notices costs one
        write + one client wakeup per subscriber per flush window)."""
        w = self._conns.get(conn_id)
        if w is None or w.is_closing():
            return False
        try:
            w.write(_pack([_PUSH, 0, BATCH_CHANNEL, items]))
            return True
        except (ConnectionError, RuntimeError):
            return False

    def conn_buffer_size(self, conn_id: int) -> int:
        """Bytes buffered in a subscriber's transport (a stalled consumer
        grows this without bound unless the publisher sheds — see PubSub's
        backlog cap)."""
        w = self._conns.get(conn_id)
        if w is None or w.is_closing():
            return 0
        try:
            return w.transport.get_write_buffer_size()
        except (AttributeError, RuntimeError):
            return 0

    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        conn_id = next(self._conn_counter)
        self._conns[conn_id] = writer
        writer._rt_write_lock = asyncio.Lock()  # serialize drain() across dispatch tasks
        splitter = _fastpath.new_splitter()
        try:
            if splitter is not None:
                # native codec: one read() may carry many frames (pipelined
                # submissions); the C++ splitter carves them all in one pass
                while True:
                    try:
                        data = await reader.read(1 << 18)
                    except (ConnectionError, OSError):
                        break
                    if not data:
                        break
                    try:
                        splitter.feed(data)
                        frames = _drain_splitter(splitter)
                    except ValueError:
                        break  # oversized frame: protocol violation
                    for kind, req_id, method, payload in frames:
                        if kind != _REQ:
                            continue
                        spawn(self._dispatch(
                            conn_id, writer, req_id, method, payload))
            else:
                while True:
                    try:
                        frame = await _read_frame(reader)
                    except (asyncio.IncompleteReadError, ConnectionError):
                        break
                    kind, req_id, method, payload = frame
                    if kind != _REQ:
                        continue
                    spawn(self._dispatch(conn_id, writer, req_id, method, payload))
        finally:
            self._conns.pop(conn_id, None)
            for cb in self._on_disconnect:
                try:
                    cb(conn_id)
                except Exception:
                    logger.exception("on_disconnect callback failed")
            writer.close()

    async def _dispatch(self, conn_id, writer, req_id, method, payload):
        chaos.maybe_kill(method)  # injected process crash at a protocol point
        delay = chaos.event_loop_delay_us(method)
        if delay:
            await asyncio.sleep(delay / 1e6)
        failure = chaos.rpc_failure(method)
        if failure == "request":
            return  # dropped before delivery; client retries
        handler = self._handlers.get(method)
        try:
            if handler is None:
                raise RpcError(f"{self.name}: no handler for {method!r}")
            result = await handler(conn_id, payload)
            if failure == "response":
                return  # executed but reply dropped
            stall = chaos.response_stall_s(method)
            if stall:
                # executed, reply delayed: the wedged-but-alive server mode
                await asyncio.sleep(stall)
            resp = [_RESP, req_id, method, result]
        except Exception as e:  # noqa: BLE001 — errors cross the wire
            if not isinstance(e, RpcError):
                logger.exception("%s: handler %s failed", self.name, method)
            resp = [_ERR, req_id, method, f"{type(e).__name__}: {e}"]
        try:
            writer.write(_pack(resp))
            # drain (serialized across dispatch tasks) only under
            # backpressure; below the high-water mark asyncio flushes the
            # buffered frames itself at the end of the loop iteration
            if writer.transport.get_write_buffer_size() > 256 * 1024:
                async with writer._rt_write_lock:
                    await writer.drain()
        except (ConnectionError, RuntimeError) as e:
            logger.warning(
                "%s: reply to %s (req %s) lost: %s", self.name, method, req_id, e
            )


class RpcClient:
    """Client with request pipelining, reconnect+retry, and push subscriptions."""

    def __init__(self, address: str, name: str = "client", retries: int = 5, retry_delay: float = 0.2):
        self.address = address
        self.name = name
        self.retries = retries
        self.retry_delay = retry_delay
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._pending: Dict[int, asyncio.Future] = {}
        self._req_counter = itertools.count(1)
        self._recv_task: Optional[asyncio.Task] = None
        self._subs: Dict[str, Callable[[Any], None]] = {}
        self._lock = asyncio.Lock()
        self._write_lock = asyncio.Lock()
        self._closed = False
        self._connected_once = False
        self._reconnect_cbs: list = []
        # A single per-call timeout must not tear down a socket other calls
        # share, but a peer that stays connected and never replies (wedged
        # process, half-open TCP) should eventually get a fresh transport.
        self._consecutive_timeouts = 0
        self.timeouts_before_reconnect = 3
        # transfer accounting for the scale bench: push FRAMES vs MESSAGES
        # quantifies pubsub coalescing (one batched frame carries many
        # notices); bytes_received is raw transport inbound
        self.push_frames = 0
        self.push_messages = 0
        self.bytes_received = 0
        # when the transport last died (monotonic), for outage-duration
        # telemetry in reconnect callbacks (rt_store_reconnect_seconds)
        self.last_disconnect_ts: Optional[float] = None

    def on_reconnect(self, cb: Callable[[], Awaitable[None]]):
        """Register an async callback fired after every re-established
        connection (NOT the first connect) — e.g. to replay server-side
        subscriptions lost when the server restarted."""
        self._reconnect_cbs.append(cb)

    async def connect(self):
        async with self._lock:
            await self._ensure_connected()

    async def _ensure_connected(self):
        if self._writer is not None and not self._writer.is_closing():
            return
        if "/" in self.address and ":" not in self.address:
            self._reader, self._writer = await asyncio.open_unix_connection(self.address)
        else:
            host, port = self.address.rsplit(":", 1)
            self._reader, self._writer = await asyncio.open_connection(host, int(port))
        self._recv_task = spawn(self._recv_loop())
        self._consecutive_timeouts = 0  # fresh transport, fresh verdict
        if self._connected_once:
            for cb in self._reconnect_cbs:
                spawn(cb())
        self._connected_once = True

    async def _recv_loop(self):
        splitter = _fastpath.new_splitter()
        try:
            if splitter is not None:
                # native codec: a burst of replies is carved and dispatched
                # in one loop iteration — futures resolve in chunks instead
                # of one coroutine wakeup per frame
                while True:
                    data = await self._reader.read(1 << 18)
                    if not data:
                        raise asyncio.IncompleteReadError(b"", None)
                    self.bytes_received += len(data)
                    splitter.feed(data)
                    frames = _drain_splitter(splitter)
                    if frames:
                        # any inbound frame proves the peer is alive
                        self._consecutive_timeouts = 0
                    for kind, req_id, method, payload in frames:
                        self._dispatch_frame(kind, req_id, method, payload)
            else:
                nbytes = [self.bytes_received]
                while True:
                    frame = await _read_frame(self._reader, counter=nbytes)
                    self.bytes_received = nbytes[0]
                    # any inbound frame proves the peer is alive — short
                    # per-call timeouts on slow methods must not count toward
                    # a reconnect while other replies are flowing
                    self._consecutive_timeouts = 0
                    kind, req_id, method, payload = frame
                    self._dispatch_frame(kind, req_id, method, payload)
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.CancelledError, ValueError) as e:
            logger.debug("%s: recv loop ended: %r", self.name, e)
        finally:
            # Mark the transport dead so call() reconnects instead of writing
            # into a half-open socket after a server-side EOF.
            self.last_disconnect_ts = time.monotonic()
            if self._writer is not None:
                self._writer.close()
                self._writer = None
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(
                        RpcConnectionLost(f"{self.name}: connection to {self.address} lost")
                    )
            self._pending.clear()

    def _dispatch_frame(self, kind, req_id, method, payload):
        if kind == _PUSH:
            # Wire-order fidelity: a reply resolves its future, which only
            # SCHEDULES the awaiting coroutine on the loop's ready queue —
            # so a push callback invoked synchronously here would overtake
            # any reply that arrived BEFORE it in the same read burst.
            # Concretely: a get_nodes_delta full-snapshot reconcile would
            # clear-and-rebuild AFTER a later registration notice had been
            # applied, wiping that node from the view forever (its notice
            # never repeats and the cursor has moved past it). Scheduling
            # pushes through the same call_soon FIFO keeps callback
            # execution in exact wire order relative to reply resumptions.
            self.push_frames += 1
            asyncio.get_running_loop().call_soon(
                self._dispatch_push, method, payload)
            return
        fut = self._pending.pop(req_id, None)
        if fut is None or fut.done():
            return
        if kind == _ERR:
            fut.set_exception(RpcError(payload))
        else:
            fut.set_result(payload)

    def _dispatch_push(self, method, payload):
        if method == BATCH_CHANNEL:
            # coalesced fanout envelope: one frame, many notices —
            # unwrap here so per-channel callbacks are batching-agnostic
            for item in payload:
                channel, message = item[0], item[1]
                self.push_messages += 1
                cb = self._subs.get(channel)
                if cb is None:
                    continue
                try:
                    cb(message)
                except Exception:
                    logger.exception(
                        "%s: push callback for %s failed",
                        self.name, channel)
            return
        self.push_messages += 1
        cb = self._subs.get(method)
        if cb is not None:
            try:
                cb(payload)
            except Exception:
                logger.exception(
                    "%s: push callback for %s failed", self.name, method)

    def subscribe_channel(self, channel: str, callback: Callable[[Any], None]):
        self._subs[channel] = callback

    async def call(self, method: str, payload: Any = None,
                   timeout: float | None = 30.0,
                   deadline: float | None = None) -> Any:
        """Call with retry on connection failure/timeouts (idempotent methods only
        should rely on retries; mutating methods are deduplicated server-side by
        caller-supplied idempotency keys in the payload).

        Retries back off per the unified policy (_private.retry: capped
        exponential + decorrelated jitter). `timeout` bounds each ATTEMPT;
        `deadline` (a time.monotonic() stamp) bounds the WHOLE retry chain —
        per-attempt timeouts and backoff sleeps are clipped to the remaining
        budget, and expiry raises RpcError with DeadlineExceeded as cause."""
        if self._closed:
            raise RpcError(f"{self.name}: client closed")
        backoff = RetryPolicy(
            max(1e-3, self.retry_delay),
            GLOBAL_CONFIG.get("retry_max_s"),
        ).backoff(deadline=deadline)
        last_exc: Exception | None = None
        loop = asyncio.get_running_loop()
        for attempt in range(self.retries + 1):
            req_id = None
            timer = None
            try:
                if chaos.partitioned(self.address):
                    # injected one-way partition: this process cannot reach
                    # the peer (models an unreachable network path)
                    raise RpcConnectionLost(
                        f"{self.name}: chaos partition to {self.address}")
                # lock-free fast path: the connection is usually live
                if self._writer is None or self._writer.is_closing():
                    async with self._lock:
                        await self._ensure_connected()
                req_id = next(self._req_counter)
                fut = loop.create_future()
                self._pending[req_id] = fut
                writer = self._writer
                if writer is None:
                    raise RpcConnectionLost(f"{self.name}: reconnect pending")
                writer.write(_pack([_REQ, req_id, method, payload]))
                # drain only under backpressure: asyncio coalesces buffered
                # writes per loop iteration, and drain() is a no-op (but not
                # a free one) below the high-water mark
                if writer.transport.get_write_buffer_size() > 256 * 1024:
                    async with self._write_lock:
                        await writer.drain()
                attempt_timeout = backoff.clamp(timeout)
                if attempt_timeout is not None:
                    timer = loop.call_later(
                        attempt_timeout, self._expire_pending, req_id)
                result = await fut
                self._consecutive_timeouts = 0
                return result
            except (
                ConnectionError,
                asyncio.TimeoutError,
                asyncio.IncompleteReadError,
                OSError,
                RpcConnectionLost,
            ) as e:
                last_exc = e
                logger.debug(
                    "%s: call %s attempt %d failed: %r", self.name, method, attempt, e
                )
                if req_id is not None:
                    self._pending.pop(req_id, None)
                # only a CONNECTION-level failure poisons the transport; a
                # per-call timeout must not tear down a socket other calls
                # are using — unless timeouts keep coming back-to-back, which
                # means the peer is wedged and only a reconnect can recover
                if isinstance(e, asyncio.TimeoutError):
                    self._consecutive_timeouts += 1
                    if (self._consecutive_timeouts >= self.timeouts_before_reconnect
                            and self._writer is not None):
                        self._consecutive_timeouts = 0
                        self._writer.close()
                        self._writer = None
                elif self._writer is not None:
                    self._writer.close()
                    self._writer = None
                if attempt < self.retries:
                    try:
                        await backoff.sleep()
                    except DeadlineExceeded as d:
                        raise RpcError(
                            f"{self.name}: call {method} to {self.address} "
                            f"deadline exceeded after {attempt + 1} attempt(s)"
                        ) from d
            finally:
                if timer is not None:
                    timer.cancel()
        # classify the terminal failure: connection-level exhaustion raises
        # the retryable subclass so routing layers (lease spillback, owner
        # fetch) re-route instead of burning task retries on a dead peer
        if isinstance(last_exc, (ConnectionError, RpcConnectionLost, OSError,
                                 asyncio.IncompleteReadError)) \
                and not isinstance(last_exc, asyncio.TimeoutError):
            raise RpcConnectionLost(
                f"{self.name}: call {method} to {self.address} failed after "
                f"retries (connection lost)"
            ) from last_exc
        raise RpcError(
            f"{self.name}: call {method} to {self.address} failed after retries"
        ) from last_exc

    async def call_frame(self, build, timeout: float | None = None) -> Any:
        """Single-attempt call whose complete frame (length prefix included)
        comes from `build(req_id)` — the handoff point for the native
        engine's pre-assembled batch frames: one buffer, one write. No
        transport-level retries: building consumes the batch entries, so a
        failure surfaces to the caller, which owns re-submission (the feeder
        requeues specs through the task-retry path)."""
        if self._closed:
            raise RpcError(f"{self.name}: client closed")
        if chaos.partitioned(self.address):
            raise RpcConnectionLost(
                f"{self.name}: chaos partition to {self.address}")
        loop = asyncio.get_running_loop()
        if self._writer is None or self._writer.is_closing():
            async with self._lock:
                await self._ensure_connected()
        req_id = next(self._req_counter)
        fut = loop.create_future()
        self._pending[req_id] = fut
        writer = self._writer
        if writer is None:
            self._pending.pop(req_id, None)
            raise RpcConnectionLost(f"{self.name}: reconnect pending")
        try:
            frame = build(req_id)
            writer.write(frame)
            if writer.transport.get_write_buffer_size() > 256 * 1024:
                async with self._write_lock:
                    await writer.drain()
        except (ConnectionError, RuntimeError, OSError) as e:
            self._pending.pop(req_id, None)
            raise RpcConnectionLost(f"{self.name}: send failed: {e}") from e
        timer = None
        if timeout is not None:
            timer = loop.call_later(timeout, self._expire_pending, req_id)
        try:
            return await fut
        finally:
            if timer is not None:
                timer.cancel()

    def _expire_pending(self, req_id: int):
        fut = self._pending.pop(req_id, None)
        if fut is not None and not fut.done():
            fut.set_exception(asyncio.TimeoutError(f"{self.name}: call timed out"))

    async def close(self):
        self._closed = True
        if self._recv_task:
            self._recv_task.cancel()
        if self._writer:
            self._writer.close()
