"""gRPC ingress for serve deployments.

Reference: python/ray/serve/_private/proxy.py:548 (gRPCProxy — a gRPC
server actor routing RPCs to deployment handles, streaming included).

Redesign without generated protos: a generic handler serves method paths

    /ray_tpu_torch.serve.Serve/Call        unary  — request bytes are a JSON
                                     payload, response bytes the JSON result
    /ray_tpu_torch.serve.Serve/CallStream  server-streaming — each generator item
                                     arrives as one JSON message

with the target deployment carried in the `rt-serve-deployment` metadata
key (the reference routes by `application` metadata the same way). Any
gRPC client in any language can call it with bytes in/out — no proto
compilation against this framework needed.
"""

from __future__ import annotations

import asyncio
import json

import ray_tpu_torch
from ray_tpu_torch.serve._errors import (
    BackpressureError,
    DeadlineExceededError,
    unwrap,
)

GRPC_PROXY_NAME = "serve-grpc-proxy"
SERVICE = "ray_tpu_torch.serve.Serve"
DEPLOYMENT_KEY = "rt-serve-deployment"
TIMEOUT_KEY = "rt-serve-timeout-s"


# 0-CPU infrastructure actor, matching HttpProxy
@ray_tpu_torch.remote(num_cpus=0)
class GrpcProxy:
    def __init__(self, host: str = "127.0.0.1", port: int = 9000):
        self.host = host
        self.port = port
        self._server = None
        self._handles = {}
        self._started = None
        self._draining = False

    async def _get_handle(self, name: str):
        from ray_tpu_torch.serve._handle import DeploymentHandle
        from ray_tpu_torch.serve._controller import get_or_create_controller_async

        handle = self._handles.get(name)
        if handle is None:
            controller = await get_or_create_controller_async()
            deployments = await controller.list_deployments.remote()
            if name not in deployments:
                return None  # truly unknown -> NOT_FOUND
            handle = DeploymentHandle(name, controller)
            # a deployment mid-roll may momentarily have zero replicas:
            # it EXISTS, so hand back the handle and let routing retry
            await handle._refresh_async(force=True)
            self._handles[name] = handle
        else:
            await handle._refresh_async()
        return handle

    async def _start(self):
        import grpc

        proxy = self

        class Handler(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                method = handler_call_details.method
                if method == f"/{SERVICE}/Call":
                    return grpc.unary_unary_rpc_method_handler(
                        proxy._call,
                        request_deserializer=bytes,
                        response_serializer=bytes,
                    )
                if method == f"/{SERVICE}/CallStream":
                    return grpc.unary_stream_rpc_method_handler(
                        proxy._call_stream,
                        request_deserializer=bytes,
                        response_serializer=bytes,
                    )
                return None

        self._server = grpc.aio.server()
        self._server.add_generic_rpc_handlers((Handler(),))
        bound = self._server.add_insecure_port(f"{self.host}:{self.port}")
        if bound == 0:
            # add_insecure_port does NOT raise on bind failure
            raise OSError(f"gRPC proxy could not bind {self.host}:{self.port}")
        self.port = bound  # port=0 auto-picks
        await self._server.start()
        return True

    async def ready(self) -> str:
        if self._started is None:
            self._started = asyncio.ensure_future(self._start())
        await self._started
        return f"{self.host}:{self.port}"

    def _deployment_from(self, context):
        for key, value in context.invocation_metadata():
            if key == DEPLOYMENT_KEY:
                return value
        return None

    @staticmethod
    def _timeout_from(context):
        """End-to-end deadline: the rt-serve-timeout-s metadata key, or
        the client's own gRPC deadline (time_remaining) — whichever is
        tighter propagates to the replica so work the caller will never
        see is not done."""
        meta = None
        for key, value in context.invocation_metadata():
            if key == TIMEOUT_KEY:
                try:
                    meta = float(value)
                except (TypeError, ValueError):
                    pass
        native = context.time_remaining()
        bounds = [t for t in (meta, native) if t is not None and t > 0]
        return min(bounds) if bounds else None

    async def _abort_typed(self, context, e: Exception):
        import grpc

        err = unwrap(e)
        if isinstance(err, BackpressureError):
            await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(err))
        if isinstance(err, (DeadlineExceededError, ray_tpu_torch.GetTimeoutError)):
            await context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(err))
        await context.abort(grpc.StatusCode.INTERNAL, str(err))

    async def _resolve(self, request: bytes, context):
        import grpc

        if self._draining:
            await context.abort(grpc.StatusCode.UNAVAILABLE,
                                "proxy is draining")
        name = self._deployment_from(context)
        if not name:
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"missing {DEPLOYMENT_KEY!r} metadata")
        handle = await self._get_handle(name)
        if handle is None:
            await context.abort(grpc.StatusCode.NOT_FOUND,
                                f"no deployment {name!r}")
        try:
            payload = json.loads(request) if request else None
        except ValueError:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                                "request body must be JSON")
        return handle, payload

    async def _call(self, request: bytes, context):
        handle, payload = await self._resolve(request, context)
        timeout_s = self._timeout_from(context)
        caller = (handle if timeout_s is None
                  else handle.options(timeout_s=timeout_s))
        try:
            result = await caller.remote(payload)
        except Exception as e:  # noqa: BLE001 — typed gRPC status mapping
            await self._abort_typed(context, e)
        return json.dumps({"result": result}, default=str).encode()

    async def _call_stream(self, request: bytes, context):
        handle, payload = await self._resolve(request, context)
        timeout_s = self._timeout_from(context)
        caller = (handle if timeout_s is None
                  else handle.options(timeout_s=timeout_s))
        stream = None
        try:
            stream = caller.options(stream=True).remote(payload)
            async for ref in stream:
                item = await ref
                yield json.dumps(item, default=str).encode()
        except Exception as e:  # noqa: BLE001
            # replica errors arrive on the awaited item ref, outside the
            # iterator — report them so ejection/refresh still happen
            if stream is not None and hasattr(stream, "note_failure"):
                e = stream.note_failure(e)
            await self._abort_typed(context, e)

    async def drain(self) -> bool:
        self._draining = True
        return True

    async def stop(self) -> bool:
        await self.drain()
        if self._server is not None:
            await self._server.stop(grace=5)
        return True


def start_grpc(host: str = "127.0.0.1", port: int = 9000) -> str:
    """Start the gRPC ingress; returns host:port (reference:
    serve.start(grpc_options=...))."""
    from ray_tpu_torch.serve._controller import SERVE_NAMESPACE

    try:
        proxy = ray_tpu_torch.get_actor(GRPC_PROXY_NAME, namespace=SERVE_NAMESPACE)
    except ValueError:
        proxy = GrpcProxy.options(
            name=GRPC_PROXY_NAME, namespace=SERVE_NAMESPACE,
            lifetime="detached", max_concurrency=256,
        ).remote(host=host, port=port)
    return ray_tpu_torch.get(proxy.ready.remote(), timeout=60)
