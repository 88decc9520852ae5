"""ray_tpu_torch.serve — scalable model serving on the actor plane.

Reference surface: python/ray/serve/api.py (deployment decorator, run,
start, shutdown, get_deployment_handle). A detached controller actor
reconciles replica gangs and autoscales on in-flight request counts; handles
route power-of-two-choices; an aiohttp ingress exposes deployments over HTTP.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.serve._controller import (
    CONTROLLER_NAME,
    SERVE_NAMESPACE,
    get_or_create_controller,
)
from ray_tpu_torch.serve._batching import batch
from ray_tpu_torch.serve._context import get_request_deadline, remaining_s
from ray_tpu_torch.serve._errors import BackpressureError, DeadlineExceededError
from ray_tpu_torch.serve._handle import DeploymentHandle
from ray_tpu_torch.serve._multiplex import get_multiplexed_model_id, multiplexed


class Deployment:
    """A configured-but-not-deployed callable (reference: serve.Deployment)."""

    def __init__(self, target: Callable, name: str,
                 num_replicas: int = 1,
                 autoscaling_config: Optional[dict] = None,
                 ray_actor_options: Optional[dict] = None,
                 max_concurrent_queries: int = 100,
                 init_args: tuple = (), init_kwargs: Optional[dict] = None,
                 version: Optional[str] = None,
                 max_queued_requests: Optional[int] = None):
        self._target = target
        self.name = name
        self.num_replicas = num_replicas
        self.autoscaling_config = autoscaling_config
        self.ray_actor_options = dict(ray_actor_options or {})
        self.max_concurrent_queries = max_concurrent_queries
        # bounded replica queue (reference: serve max_queued_requests):
        # admitted-but-not-running requests beyond this are rejected with
        # BackpressureError. None = the serve_max_queued_requests config
        # flag; -1 = explicitly unbounded.
        self.max_queued_requests = max_queued_requests
        self._init_args = init_args
        self._init_kwargs = dict(init_kwargs or {})
        # Stable code identity: redeploying with the same version is a pure
        # replica-count/options update (in-place rescale, replica state
        # kept); a changed version forces a rolling restart. Without it the
        # controller falls back to comparing pickle bytes, which cloudpickle
        # does not guarantee deterministic (reference: serve version=).
        self.version = version

    def options(self, **overrides) -> "Deployment":
        cfg = dict(
            num_replicas=self.num_replicas,
            autoscaling_config=self.autoscaling_config,
            ray_actor_options=self.ray_actor_options,
            max_concurrent_queries=self.max_concurrent_queries,
            max_queued_requests=self.max_queued_requests,
            init_args=self._init_args,
            init_kwargs=self._init_kwargs,
            name=self.name,
            version=self.version,
        )
        cfg.update(overrides)
        name = cfg.pop("name")
        return Deployment(self._target, name, **cfg)

    def bind(self, *args, **kwargs) -> "Deployment":
        """Bind constructor args (reference: deployment.bind for app graphs)."""
        return Deployment(
            self._target, self.name,
            num_replicas=self.num_replicas,
            autoscaling_config=self.autoscaling_config,
            ray_actor_options=self.ray_actor_options,
            max_concurrent_queries=self.max_concurrent_queries,
            max_queued_requests=self.max_queued_requests,
            init_args=args, init_kwargs=kwargs,
            version=self.version,
        )


def deployment(_target=None, *, name: Optional[str] = None,
               num_replicas: int = 1,
               autoscaling_config: Optional[dict] = None,
               ray_actor_options: Optional[dict] = None,
               max_concurrent_queries: int = 100,
               version: Optional[str] = None,
               max_queued_requests: Optional[int] = None):
    """`@serve.deployment` decorator (reference: serve.api.deployment)."""

    def wrap(target):
        return Deployment(
            target, name or target.__name__,
            num_replicas=num_replicas,
            autoscaling_config=autoscaling_config,
            ray_actor_options=ray_actor_options,
            max_concurrent_queries=max_concurrent_queries,
            version=version,
            max_queued_requests=max_queued_requests,
        )

    if _target is not None:
        return wrap(_target)
    return wrap


def run(dep: Deployment, *, wait_for_ready: bool = True,
        timeout: float = 120.0,
        _local_testing_mode: bool = False):
    """Deploy (or redeploy) and return a routing handle (reference:
    serve.run). `_local_testing_mode=True` constructs the callable
    IN-PROCESS and returns a LocalHandle — deployment logic becomes unit-
    testable without a cluster (reference: local_testing_mode.py)."""
    if _local_testing_mode:
        from ray_tpu_torch.serve._local import run_local

        return run_local(dep)
    import cloudpickle

    controller = get_or_create_controller()
    ok = ray_tpu_torch.get(
        controller.deploy.remote(
            dep.name,
            cloudpickle.dumps(dep._target),
            cloudpickle.dumps((dep._init_args, dep._init_kwargs)),
            dep.num_replicas,
            autoscaling=dep.autoscaling_config,
            actor_options=dep.ray_actor_options,
            max_concurrent=dep.max_concurrent_queries,
            version=dep.version,
            max_queued=dep.max_queued_requests,
        ),
        timeout=timeout,
    )
    if not ok:
        raise RuntimeError(f"deploying {dep.name} failed")
    handle = DeploymentHandle(dep.name, controller)
    if wait_for_ready:
        handle._refresh(force=True)
    return handle


def get_deployment_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name, get_or_create_controller())


def status() -> Dict[str, Any]:
    controller = get_or_create_controller()
    return ray_tpu_torch.get(controller.list_deployments.remote(), timeout=30)


def start_grpc(grpc_host: str = "127.0.0.1", grpc_port: int = 9000) -> str:
    """Start the gRPC ingress (reference: gRPCProxy, proxy.py:548)."""
    from ray_tpu_torch.serve._grpc import start_grpc as _start

    return _start(grpc_host, grpc_port)


def start(http_host: str = "127.0.0.1", http_port: int = 8000,
          proxy_location: Optional[str] = None) -> str:
    """Start the HTTP ingress; returns a base URL (reference:
    serve.start(http_options=..., proxy_location=...)).

    proxy_location=None resolves from the `serve_proxy_location` config
    flag. "head" (flag default): one proxy on this node, fixed port —
    the dev mode. "every_node": the controller maintains one proxy PER
    ALIVE node (reference: proxy.py one-proxy-per-node + proxy_state.py),
    healing the fleet as nodes come and go; requests can enter through any
    node (front them with any TCP load balancer). With http_port=0 each
    fleet proxy binds an ephemeral port (required when several daemons
    share one test host); see serve.proxy_urls() for the full map."""
    if proxy_location is None:
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        proxy_location = GLOBAL_CONFIG.get("serve_proxy_location")
    if proxy_location not in ("head", "every_node"):
        raise ValueError(
            f"proxy_location must be 'head' or 'every_node', "
            f"got {proxy_location!r}")
    if proxy_location == "every_node":
        controller = get_or_create_controller()
        urls = ray_tpu_torch.get(
            controller.ensure_proxies.remote(http_host, http_port),
            timeout=120)
        if not urls:
            raise RuntimeError("no alive nodes to host serve proxies")
        return sorted(urls.values())[0]
    from ray_tpu_torch.serve._http import PROXY_NAME, HttpProxy

    try:
        proxy = ray_tpu_torch.get_actor(PROXY_NAME, namespace=SERVE_NAMESPACE)
    except ValueError:
        proxy = HttpProxy.options(
            name=PROXY_NAME, namespace=SERVE_NAMESPACE, lifetime="detached",
            max_concurrency=256,
        ).remote(host=http_host, port=http_port)
    return ray_tpu_torch.get(proxy.ready.remote(), timeout=60)


def proxy_urls() -> Dict[str, str]:
    """{node_id_hex: url} for the per-node proxy fleet (empty in the
    single-proxy dev mode)."""
    controller = get_or_create_controller()
    return ray_tpu_torch.get(controller.proxy_urls.remote(), timeout=30)


def delete(name: str):
    controller = get_or_create_controller()
    ray_tpu_torch.get(controller.delete_deployment.remote(name), timeout=60)


def shutdown():
    """Tear down all deployments, the controller, and the proxy."""
    from ray_tpu_torch.serve._http import PROXY_NAME

    gproxy = None
    try:
        from ray_tpu_torch.serve._grpc import GRPC_PROXY_NAME

        gproxy = ray_tpu_torch.get_actor(GRPC_PROXY_NAME, namespace=SERVE_NAMESPACE)
        ray_tpu_torch.get(gproxy.stop.remote(), timeout=15)
    except Exception:  # noqa: BLE001 — gRPC proxy never started / stop hung
        pass
    if gproxy is not None:
        # ALWAYS kill once the actor exists (same rule as the HTTP proxy)
        try:
            ray_tpu_torch.kill(gproxy)
        except Exception:  # noqa: BLE001 — already dead
            pass
    proxy = None
    try:
        proxy = ray_tpu_torch.get_actor(PROXY_NAME, namespace=SERVE_NAMESPACE)
        ray_tpu_torch.get(proxy.stop.remote(), timeout=30)
    except Exception:  # noqa: BLE001 — proxy never started / drain overran
        pass
    if proxy is not None:
        # ALWAYS kill once the actor exists: a drain overrunning the RPC
        # timeout must not leak a permanently-draining detached proxy
        try:
            ray_tpu_torch.kill(proxy)
        except Exception:  # noqa: BLE001 — already dead
            pass
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME, namespace=SERVE_NAMESPACE)
        ray_tpu_torch.get(controller.shutdown.remote(), timeout=60)
        ray_tpu_torch.kill(controller)
    except Exception:  # noqa: BLE001 — controller never started
        pass


from ray_tpu_torch.serve.schema import build_config, deploy_config  # noqa: E402

__all__ = [
    "batch",
    "build_config",
    "deploy_config",
    "multiplexed",
    "get_multiplexed_model_id",
    "get_request_deadline",
    "remaining_s",
    "BackpressureError",
    "DeadlineExceededError",
    "Deployment",
    "DeploymentHandle",
    "deployment",
    "run",
    "start",
    "start_grpc",
    "status",
    "delete",
    "shutdown",
    "get_deployment_handle",
]

from ray_tpu_torch._private.usage import record_library_usage as _rlu

_rlu("serve")
del _rlu
