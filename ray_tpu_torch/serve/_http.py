"""HTTP ingress for serve deployments.

Reference: python/ray/serve/_private/proxy.py (HTTP proxy actor routing
`/app` paths to deployment handles; streaming responses :1031; draining on
shutdown). aiohttp server inside a detached actor:

- POST /<deployment> with a JSON (or raw bytes) body routes to the
  deployment's __call__ and returns the JSON-encoded result.
- a request carrying `X-Serve-Timeout-S: <float>` (or `?timeout_s=`)
  gets an END-TO-END deadline stamped at ingress; it propagates through
  the handle to the replica, and expiry maps to 504. Admission-control
  rejections (bounded replica queues / ingress shed) map to 503 with a
  Retry-After header.
- a request carrying `?stream=1` or a JSON body with `"stream": true`
  rides the STREAMING path end-to-end: the replica drives the user's
  generator, items flow back over the actor streaming plane, and the proxy
  writes them to the client incrementally as Server-Sent Events
  (`data: <json>\n\n`, terminated by `data: [DONE]`) — the client sees
  tokens before generation completes.
- `drain()` stops admitting requests (503) and resolves once in-flight
  requests finish; `stop()` drains then tears the server down (reference:
  proxy draining in proxy_state.py).
"""

from __future__ import annotations

import asyncio
import json
from typing import Optional

import ray_tpu_torch
from ray_tpu_torch.serve._errors import (
    BackpressureError,
    DeadlineExceededError,
    unwrap,
)

PROXY_NAME = "serve-http-proxy"
SERVE_NAMESPACE = "_serve"
TIMEOUT_HEADER = "X-Serve-Timeout-S"
AFFINITY_HEADER = "X-Serve-Affinity-Key"
_SENTINEL = object()


def _error_response(e: Exception):
    """Map a serve-plane error to (status, headers, body-dict): typed
    overload errors carry their semantics to the client — 503 +
    Retry-After for sheds (retry elsewhere/later), 504 for spent
    deadlines (do NOT retry: the budget is gone)."""
    err = unwrap(e)
    if isinstance(err, BackpressureError):
        return 503, {"Retry-After": str(max(1, round(err.retry_after_s)))}, {
            "error": str(err), "type": "backpressure",
            "retry_after_s": err.retry_after_s}
    if isinstance(err, (DeadlineExceededError, ray_tpu_torch.GetTimeoutError)):
        return 504, {}, {"error": str(err), "type": "deadline_exceeded"}
    return 500, {}, {"error": str(err), "type": "internal"}


# 0-CPU like Ray Serve's proxies: ingress is infrastructure, not workload —
# the every_node fleet must place one on a node whose CPUs replicas already
# hold, or busy nodes silently lose their ingress
@ray_tpu_torch.remote(num_cpus=0)
class HttpProxy:
    def __init__(self, host: str = "127.0.0.1", port: int = 8000):
        # NB: actor constructors run on an executor thread — the server is
        # started lazily from ready() where the event loop is available
        self.host = host
        self.port = port
        self._runner = None
        self._handles = {}
        self._site = None
        self._started = None
        self._inflight = 0
        self._draining = False
        # overload-plane counters surfaced on /-/healthz (and scraped by
        # bench_serve): how much traffic this proxy shed / timed out
        self._shed = 0
        self._deadline_exceeded = 0

    async def _start(self):
        from aiohttp import web

        from ray_tpu_torch.serve._controller import get_or_create_controller_async

        self._controller = await get_or_create_controller_async()
        app = web.Application()
        app.router.add_route("*", "/{deployment}", self._dispatch)
        app.router.add_get("/-/routes", self._routes)
        app.router.add_get("/-/healthz", self._healthz)
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        self._site = web.TCPSite(self._runner, self.host, self.port)
        await self._site.start()
        if self.port == 0:
            # ephemeral bind (proxy fleets on one test host can't share a
            # fixed port): report the real one
            self.port = self._runner.addresses[0][1]
        return True

    async def ready(self) -> str:
        if self._started is None:
            self._started = asyncio.ensure_future(self._start())
        await self._started
        return f"http://{self.host}:{self.port}"

    async def node(self) -> str:
        from ray_tpu_torch._private.core_worker import get_core_worker

        return get_core_worker().node_id_hex

    async def _routes(self, request):
        from aiohttp import web

        deployments = await self._controller.list_deployments.remote()
        return web.json_response(deployments)

    async def _healthz(self, request):
        from aiohttp import web

        return web.json_response(
            {"status": "draining" if self._draining else "ok",
             "inflight": self._inflight,
             "shed": self._shed,
             "deadline_exceeded": self._deadline_exceeded},
            status=503 if self._draining else 200)

    async def _get_handle(self, name: str):
        from ray_tpu_torch.serve._handle import DeploymentHandle

        handle = self._handles.get(name)
        if handle is None:
            handle = DeploymentHandle(name, self._controller)
            await handle._refresh_async(force=True)
            if not handle._replicas:
                return None
            self._handles[name] = handle
        else:
            await handle._refresh_async()
        return handle

    async def _dispatch(self, request):
        from aiohttp import web

        if self._draining:
            return web.json_response(
                {"error": "proxy is draining"}, status=503)
        self._inflight += 1
        try:
            return await self._dispatch_inner(request)
        finally:
            self._inflight -= 1

    async def _dispatch_inner(self, request):
        from aiohttp import web

        name = request.match_info["deployment"]
        handle = await self._get_handle(name)
        if handle is None:
            return web.json_response(
                {"error": f"no deployment {name!r}"}, status=404)
        body = await request.read()
        if request.content_type == "application/json" and body:
            payload = json.loads(body)
        elif body:
            payload = body
        else:
            payload = None
        stream = request.query.get("stream", "") in ("1", "true") or (
            isinstance(payload, dict) and bool(payload.get("stream")))
        timeout_s = self._timeout_from(request)
        caller = (handle if timeout_s is None
                  else handle.options(timeout_s=timeout_s))
        # prefix-affinity hint (session / prompt-prefix id): same-key
        # requests steer to the replica whose engine likely still holds
        # the prefix's KV blocks; saturation overflows to pow-2
        affinity = request.headers.get(AFFINITY_HEADER, "") or (
            payload.get("affinity_key", "")
            if isinstance(payload, dict) else "")
        if affinity:
            caller = caller.options(affinity_key=str(affinity))
        from ray_tpu_torch.util import tracing

        if stream:
            return await self._dispatch_stream(request, caller, payload,
                                               name)
        # ingress span: the root of the request's trace — the handle's
        # pick span and the replica-side admission/batch/execution spans
        # all chain under it (stitched by trace id in timeline())
        with tracing.span(f"ingress:{name}"):
            try:
                result = await caller.remote(payload)
            except Exception as e:  # noqa: BLE001 — typed mapping below
                status, headers, body = _error_response(e)
                if status == 503:
                    self._shed += 1
                elif status == 504:
                    self._deadline_exceeded += 1
                return web.json_response(body, status=status,
                                         headers=headers)
        try:
            return web.json_response({"result": result})
        except TypeError:
            return web.Response(body=bytes(result))

    @staticmethod
    def _timeout_from(request) -> Optional[float]:
        raw = request.headers.get(TIMEOUT_HEADER) or request.query.get(
            "timeout_s")
        if not raw:
            return None
        try:
            t = float(raw)
        except ValueError:
            return None
        return t if t > 0 else None

    async def _dispatch_stream(self, request, handle, payload,
                               name: str = ""):
        """SSE: one `data:` event per generator item, flushed as produced
        (reference: proxy.py:1031 ASGI streaming). Admission failures
        (shed / expired deadline) happen BEFORE the response starts and
        map to real 503/504 statuses; a deadline that expires mid-stream
        can only be an SSE error event — the 200 is already on the wire."""
        from aiohttp import web

        from ray_tpu_torch.util import tracing

        # ingress span: created manually (its END rides the stream outcome,
        # not a lexical scope) and installed as the current context for the
        # whole dispatch so the handle submission chains under it
        ingress_sp = tracing.start_manual_span(f"ingress:{name}")
        with tracing.installed_span(ingress_sp):
            n_chunks = 0
            # Defer the 200/SSE headers until the FIRST item arrives:
            # replica admission control (queue full, spent deadline)
            # rejects a stream on its first chunk, and that must be a clean
            # 503/504 — once the event-stream response has started, only
            # error events remain.
            first = _SENTINEL
            try:
                stream = handle.options(stream=True).remote(payload)
                it = stream.__aiter__()
                try:
                    first = await (await it.__anext__())
                except StopAsyncIteration:
                    pass
            except Exception as e:  # noqa: BLE001 — typed mapping
                tracing.end_manual_span(ingress_sp, error=type(e).__name__)
                status, headers, body = _error_response(e)
                if status == 503:
                    self._shed += 1
                elif status == 504:
                    self._deadline_exceeded += 1
                return web.json_response(body, status=status,
                                         headers=headers)
            resp = web.StreamResponse(headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
                "X-Accel-Buffering": "no",
            })
            await resp.prepare(request)

            def encode(item) -> bytes:
                try:
                    data = json.dumps(item)
                except TypeError:
                    data = json.dumps(str(item))
                return f"data: {data}\n\n".encode()

            try:
                if first is not _SENTINEL:
                    await resp.write(encode(first))
                    n_chunks = 1
                    async for ref in it:
                        await resp.write(encode(await ref))
                        n_chunks += 1
                await resp.write(b"data: [DONE]\n\n")
                tracing.end_manual_span(ingress_sp, chunks=n_chunks)
            except Exception as e:  # noqa: BLE001 — mid-stream error event
                # route the failure through the stream's health
                # bookkeeping: replica errors ride the final ITEM ref,
                # which we await here (outside the iterator), so the
                # iterator can't see them
                err = stream.note_failure(e) if hasattr(
                    stream, "note_failure") else unwrap(e)
                if isinstance(err, DeadlineExceededError):
                    kind = "deadline_exceeded"
                    self._deadline_exceeded += 1
                elif isinstance(err, BackpressureError):
                    kind = "backpressure"
                    self._shed += 1
                else:
                    kind = "error"
                await resp.write(
                    f"data: {json.dumps({'error': str(err), 'type': kind})}"
                    f"\n\n".encode())
                tracing.end_manual_span(ingress_sp, chunks=n_chunks,
                                        error=kind)
            await resp.write_eof()
            return resp

    async def drain(self, timeout: float = 30.0) -> bool:
        """Stop admitting requests; resolve once in-flight ones finish."""
        self._draining = True
        deadline = asyncio.get_running_loop().time() + timeout
        while self._inflight > 0:
            if asyncio.get_running_loop().time() >= deadline:
                return False
            await asyncio.sleep(0.02)
        return True

    async def stop(self, drain_timeout: float = 10.0) -> bool:
        # drain with headroom under the caller's RPC timeout: if this call
        # outlived serve.shutdown()'s get, the swallow there would skip the
        # kill and leak a permanently-draining detached proxy
        await self.drain(timeout=drain_timeout)
        if self._runner is not None:
            await self._runner.cleanup()
        return True
