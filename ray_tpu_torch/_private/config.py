"""Env-overridable typed flag registry.

Capability parity with the reference's RAY_CONFIG system
(reference: src/ray/common/ray_config.h:60, ray_config_def.h — 249 flags, each
overridable by env `RAY_<name>` or the `_system_config` dict passed at init).

Here every flag declared with `_flag()` is overridable by env `RAY_TPU_<name>`
or by `ray_tpu_torch.init(system_config={...})`. Flags include the day-1 chaos hooks
(`testing_event_loop_delay_us`, `testing_rpc_failure`) mirroring the reference's
asio/rpc chaos (src/ray/asio/asio_chaos.h, src/ray/rpc/rpc_chaos.h).
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict

_ENV_PREFIX = "RAY_TPU_"


def _parse_bool(v: str) -> bool:
    return v.strip().lower() in ("1", "true", "yes", "on")


_PARSERS: Dict[type, Callable[[str], Any]] = {
    bool: _parse_bool,
    int: int,
    float: float,
    str: str,
}


@dataclass
class _Flag:
    name: str
    default: Any
    type: type
    doc: str = ""


class ConfigRegistry:
    """Singleton registry of typed flags with env + runtime override tiers.

    Priority (highest wins): runtime `system_config` > env `RAY_TPU_<name>` > default.
    """

    def __init__(self):
        self._flags: Dict[str, _Flag] = {}
        self._overrides: Dict[str, Any] = {}
        self._lock = threading.Lock()
        # resolved-value memo: get() sits on per-task hot paths (submission,
        # lease pools), and an os.environ miss costs a thrown KeyError every
        # call. Invalidated by reset()/apply_system_config()/declare() — code
        # that mutates RAY_TPU_* env at runtime must call reset() (the test
        # fixture already does).
        self._cache: Dict[str, Any] = {}

    def declare(self, name: str, default: Any, doc: str = "") -> None:
        self._flags[name] = _Flag(name, default, type(default), doc)
        self._cache.pop(name, None)

    def get(self, name: str) -> Any:
        try:
            return self._cache[name]
        except KeyError:
            pass
        flag = self._flags[name]
        # resolve AND cache under one lock: caching the env/default value
        # outside it could race apply_system_config and pin a stale value
        # over the override for the process lifetime
        with self._lock:
            if name in self._overrides:
                value = self._overrides[name]
            else:
                env = os.environ.get(_ENV_PREFIX + name)
                if env is not None:
                    try:
                        value = _PARSERS[flag.type](env)
                    except (ValueError, KeyError):
                        raise ValueError(
                            f"Bad value {env!r} for flag {name} "
                            f"(expects {flag.type.__name__})"
                        ) from None
                else:
                    value = flag.default
            self._cache[name] = value
        return value

    def apply_system_config(self, system_config: Dict[str, Any]) -> None:
        for k, v in system_config.items():
            if k not in self._flags:
                raise KeyError(f"Unknown system_config key: {k}")
            flag = self._flags[k]
            if not isinstance(v, flag.type) and not (
                flag.type is float and isinstance(v, int)
            ):
                raise TypeError(
                    f"system_config[{k!r}] expects {flag.type.__name__}, got {type(v).__name__}"
                )
            with self._lock:
                self._overrides[k] = v
                self._cache.pop(k, None)

    def serialize_overrides(self) -> str:
        """Serialize overrides so spawned daemons/workers inherit them (the
        reference passes --raylet_config JSON to child binaries)."""
        with self._lock:
            return json.dumps(self._overrides)

    def load_overrides(self, payload: str) -> None:
        self.apply_system_config(json.loads(payload))

    def reset(self) -> None:
        with self._lock:
            self._overrides.clear()
            self._cache.clear()

    def all_flags(self) -> Dict[str, _Flag]:
        return dict(self._flags)


GLOBAL_CONFIG = ConfigRegistry()
_flag = GLOBAL_CONFIG.declare

# --- core runtime ---
_flag("object_store_memory_bytes", 512 * 1024 * 1024, "Per-node shm object store size.")
_flag("inline_object_max_bytes", 100 * 1024, "Objects <= this ride RPC replies inline; larger go to the shm store (reference: plasma promotion threshold, core_worker store_provider).")
_flag("worker_pool_prestart", -1, "Workers to prestart per node; -1 = one per CPU, capped at 16 (reference: worker_pool.h prestarts num_cpus workers for the first job so a cold pool never serializes a parallel burst behind worker spawn).")
_flag("worker_pool_max_idle", 4, "Idle workers cached per node before reaping.")
_flag("worker_register_timeout_s", 30.0, "Seconds to wait for a spawned worker to register.")
_flag("lease_spillback_max_hops", 8, "Max scheduler spillback hops for one lease request.")
_flag("health_check_period_s", 1.0, "Control-store node liveness probe period.")
_flag("health_check_timeout_s", 10.0, "Node declared dead after this long without heartbeat.")
_flag("pull_retry_initial_delay_s", 0.2, "Object transfer pull retry initial backoff.")
_flag("pull_retry_max_delay_s", 10.0, "Object transfer pull retry max backoff.")
_flag("object_chunk_bytes", 1024 * 1024, "Chunk size for node-to-node object push.")
_flag("max_task_retries_default", 3, "Default retries for idempotent tasks.")
_flag("actor_max_restarts_default", 0, "Default actor restarts.")
_flag("memory_store_max_bytes", 256 * 1024 * 1024, "Per-process in-memory store cap.")
_flag("cgroup_isolation_enabled", False, "Isolate system vs worker processes in a cgroup2 hierarchy (reference: common/cgroup2/cgroup_manager.h). No-op when cgroupfs is unwritable.")
_flag("cgroup_system_reserved_memory_bytes", 0, "memory.min reservation for the system cgroup (daemon/store processes).")
_flag("cgroup_worker_memory_high_bytes", 0, "memory.high throttle for the workers cgroup (0 = unset).")
_flag("cgroup_worker_memory_max_bytes", 0, "memory.max hard cap for the workers cgroup (0 = unset).")
_flag("cgroup_worker_cpu_weight", 0, "cpu.weight for the workers cgroup (0 = unset).")
_flag("task_event_buffer_max", 10000, "Profile/task events buffered per worker before drop.")
_flag("telemetry_flush_period_s", 1.0, "Task-event + metrics flush cadence to the control store.")

# --- observability plane (tracing, per-hop decomposition, flight recorder,
# metrics aggregation) ---
_flag("tracing_enabled", False, "Distributed tracing + per-hop latency decomposition: spans propagate through task specs, execution spans are recorded into the task-event plane, and every hop of the task path (submit encode, ring wait, frame build, wire RTT, lease grant, worker dequeue, user fn, completion delivery) folds into rt_task_hop_seconds{hop=...}. The legacy RT_TRACING_ENABLED env var is kept as an override; enable_tracing() sets both.")
_flag("flight_recorder_ring_size", 2048, "Per-process flight-recorder ring capacity (coarse control-plane events: state transitions, RPC edges, lease grants, recovery/drain/resize decisions). Dump on demand via ray_tpu_torch.util.state.dump_flight_recorder(); the chaos harness auto-dumps failing scenarios and crash paths dump to the log dir.")
_flag("metrics_node_series_max", 4096, "Cardinality cap on the per-node metric pre-aggregation: distinct series (name+tags) beyond this are dropped at the node daemon (counted in rt_metrics_series_dropped_total) instead of flooding the control store.")
_flag("control_store_port", 0, "Port for the control store (0 = auto).")
_flag("scheduler_spread_threshold", 0.5, "Hybrid policy: pack below this utilization, then spread (reference: hybrid_scheduling_policy.h:50).")
_flag("log_to_driver", True, "Forward worker stdout/stderr to the driver.")
_flag("actor_creation_timeout_s", 120.0, "Control store waits this long for a daemon to lease+create an actor.")
_flag("lease_request_timeout_s", 30.0, "Per-attempt deadline on a worker-lease RPC; timed-out requests are retried idempotently by request key (a lease may legitimately stay queued across many attempts).")
_flag("placement_group_timeout_s", 60.0, "Placement group scheduling deadline before marked unschedulable.")
_flag("actor_ordering_gap_timeout_s", 120.0, "Ordered actor task fails (never reorders) after waiting this long for a missing predecessor sequence number. Generous: a predecessor may be legitimately slow to ARRIVE (its args still computing upstream in an actor DAG, first-call jit compiles); the timeout only exists to reclaim liveness when a caller died mid-retry and the hole is permanent.")
_flag("borrow_reaper_strikes", 3, "Consecutive failed liveness probes before a borrower is declared dead (one missed ping may just be a stalled event loop).")
_flag("borrow_reaper_period_s", 30.0, "Owner-side borrower liveness probe period: borrows held by unreachable borrower processes are dropped so their objects can free (reference: reference_counter borrower-death cleanup).")
_flag("object_spill_enabled", True, "Spill cold sealed objects to disk under store memory pressure (reference: raylet local_object_manager spilling).")
_flag("object_spill_high_water", 0.7, "Store fullness fraction that triggers spilling.")
_flag("object_spill_low_water", 0.5, "Spill until store fullness drops below this fraction.")
_flag("object_spill_check_period_s", 0.25, "Spill loop poll period.")
_flag("object_store_full_delay_s", 0.05, "Initial backoff between create retries while the object store is full (reference: plasma CreateRequestQueue retry cadence).")
_flag("object_store_full_timeout_s", 30.0, "Total time a create waits for store capacity (spill + consumers freeing) before ObjectStoreFullError surfaces (reference: create_request_queue.h oom_grace_period).")
_flag("memory_monitor_interval_s", 1.0, "Daemon memory-monitor poll period; <= 0 disables OOM worker killing (reference: memory_monitor.h).")
_flag("memory_usage_threshold", 0.95, "Memory usage fraction above which the daemon kills a worker per interval (reference: RAY_memory_usage_threshold).")
_flag("memory_limit_bytes", 0, "Memory budget for the OOM monitor; 0 = node total (psutil). When set, usage is measured as the sum of worker-tree RSS against this budget (testable), else system-wide usage fraction.")
_flag("usage_stats_enabled", True, "Record cluster metadata + library-usage tags in the control store KV and <session>/usage_stats.json (reference: RAY_USAGE_STATS_ENABLED). Zero egress: nothing leaves the cluster; set 0 to disable entirely.")
_flag("resource_gossip_period_s", 0.5, "Peer-to-peer resource-view gossip period (reference: ray_syncer.h:91 bidi resource-view streams between raylets); 0 disables — the control-store heartbeat piggyback remains the baseline sync.")
_flag("resource_gossip_fanout", 2, "Random peers contacted per gossip round.")
_flag("object_store_destructive_eviction", False, "Let a full store DESTROY LRU unpinned objects on create (cache semantics). Default off: full stores backpressure creators and rely on spilling — destroying a sole copy of an owned object is silent data loss (reference: plasma never evicts primary copies).")
_flag("control_store_persist", False, "Persist control-store state (nodes/actors/PGs/KV/jobs/worker-death records) to a WAL+snapshot in the session dir; a restarted control store recovers it (reference: gcs redis/rocksdb store clients).")
_flag("control_store_wal_compact_every", 512, "WAL records between snapshot compactions.")

# --- control-store HA (pluggable persistence, warm-standby failover,
# epoch fencing — _private/persistence.py, store_ha.py) ---
_flag("control_store_backend", "file", "Persistence backend behind the control store's WAL/snapshot: 'file' (msgpack snapshot + append-only WAL files, the default) or 'sqlite' (one embedded store.sqlite3 with seq-keyed WAL rows and transactional epoch fencing — the rocksdb-style shape of the reference's gcs store clients). Both support warm-standby tailing and fencing.")
_flag("store_standby_enabled", False, "Spawn a warm-standby control store next to the primary (implies control_store_persist): the standby tails the shared WAL into live tables and takes over at the primary's address on its death (flock release, instant) or wedge (lease stale past store_failover_timeout_s), bumping the fencing epoch so the old primary cannot apply a late mutation. Subscribers ride their cursor reconcile to resubscribe with zero lost notices (reference: GCS HA via store-backed state + leader election).")
_flag("store_failover_timeout_s", 10.0, "Standby takeover threshold for a WEDGED primary: the leadership lease going unrenewed this long declares the leader dead even though its process (and flock) lives. Outright process death frees the flock and fails over without waiting this out. Keep well above store_fence_epoch_renew_s.")
_flag("store_fence_epoch_renew_s", 1.0, "Cadence of the active leader's lease renewal AND the standby's staleness/tail poll. A leader whose renewal discovers a newer fencing epoch exits immediately (it has been superseded); the persistence backends independently refuse its late WAL mutations.")
_flag("lineage_cache_max_tasks", 4096, "Completed task specs kept per owner for lineage reconstruction of lost shm objects (reference: task_manager lineage pinning).")
_flag("max_lineage_reconstructions", 3, "Times one lost object may be recomputed from lineage before get() raises ObjectLostError (reference: object_recovery_manager.h retry cap).")
_flag("max_pending_lease_requests", 16, "In-flight lease requests per scheduling key (reference: normal_task_submitter.h:57 LeaseRequestRateLimiter) — recycled leases serve queued submissions; fetchers only prime the pump.")
_flag("worker_lease_idle_s", 0.5, "Cached worker leases idle past this are returned to the daemon (reference: normal_task_submitter lease pools + idle lease timeout).")
_flag("lease_pool_max_idle", 16, "Max granted-but-idle leases cached per scheduling key before extras are returned immediately.")
_flag("push_batch_max", 64, "Max task specs coalesced into one push_task_batch RPC to a leased worker (reference: normal_task_submitter.h:226 pipelined PushNormalTask — amortizes per-RPC framing and event-loop wakeups across queued same-shaped tasks).")
_flag("push_feeders_per_key", 16, "Max concurrent lease-holding batch feeders per scheduling key; each feeder drains the key's ready queue onto one leased worker at a time.")
_flag("device_object_transport", True, "The device object plane (experimental/rdt.py; reference: python/ray/experimental/rdt): a tensor put into the object plane stays registered in its producer, so a get in that process returns the original tensor (unchanged since the put) with no copy; other processes rebuild it from its host-staged bytes on their device. Off: every get rebuilds.")
_flag("native_fastpath", True, "Use the C++ submission/completion engine (native/fastpath.cc: templated spec encoding, lock-free submission ring, batched frame build + reply splitting) on the control-plane hot path (reference: the _raylet.pyx submit_task seam). Falls back to the pure-Python path when the build fails or no compiler exists — set 0 to force the fallback.")
_flag("fastpath_ring_slots", 65536, "Capacity of each lock-free submission ring (one ring per scheduling key); a full ring overflows gracefully onto the Python queue.")

# --- control-plane scale (simnode harness + 1000-node fixes; see
# _private/simnode.py and bench_scale.py) ---
_flag("heartbeat_period_s", 0.0, "Node-daemon heartbeat period; 0 = follow health_check_period_s. Decoupled so a 1000-node cluster can beat slower than the liveness probe granularity of a 4-node one.")
_flag("heartbeat_jitter", 0.1, "Fractional jitter applied to every heartbeat sleep (period * (1 +/- jitter * U)): de-phases a register storm's worth of daemons so 1000 beats don't land on the same control-store event-loop tick.")
_flag("pubsub_flush_window_ms", 0.0, "Control-store pubsub coalescing window: >0 buffers notices per subscriber and ships ONE batched push frame per subscriber per window (a churn wave costs frames proportional to windows, not events). 0 = legacy immediate per-event frames. Subscribers detect any coalescing-drop gaps via per-channel _seq and reconcile from the node-table delta cursor.")
_flag("pubsub_max_backlog", 1000, "Bound on the per-subscriber pubsub backlog: buffered notices beyond this (coalescing mode) are dropped OLDEST-first, and a subscriber whose transport write buffer exceeds ~1KiB * this cap (immediate mode) has notices dropped instead of growing the buffer without bound. Drops count in rt_pubsub_dropped_total{channel=} and surface to the subscriber as a _seq gap -> cursor reconcile.")
_flag("node_delta_retention", 1024, "Node-table delta-log retention (entries): subscribers reconcile from a version cursor via get_nodes_delta instead of full get_all_nodes snapshots; a cursor older than the retained window falls back to one full snapshot.")
_flag("node_dead_retention", 512, "DEAD node records kept in the node table (oldest evicted with a persisted tombstone): bounds get_all_nodes payloads, the WAL/snapshot, and death-record memory under node churn. Live nodes are never evicted.")
_flag("node_table_delta_sync", True, "Use the versioned node-table delta protocol: daemons/workers reconcile pubsub gaps from their version cursor (get_nodes_delta) and heartbeat replies carry only availability CHANGES since the daemon's cursor instead of the full O(nodes) view. Off = legacy full-snapshot reads everywhere (the bench_scale A/B lever).")
_flag("heartbeat_pending_shapes_max", 32, "Cap on pending-lease resource shapes one daemon heartbeat carries (infeasible shapes ride a quarter of the budget); the uncounted tail still rides the pending count, which the demand-driven autoscaler treats as generic worker-sized demand.")
_flag("simnode_count", 100, "Default simulated-node count for the scale harness (_private/simnode.py): protocol-faithful node-daemon speakers with no worker pools, hundreds per process, for control-plane scale testing.")
_flag("simnode_seed", 0, "Seed for the simnode plane's deterministic node ids and jitter draws; 0 = fresh entropy.")

# --- job plane (job_submission/: durable JobManager + per-tenant
# fair-share admission; the job table lives in the control store) ---
_flag("job_poll_period_s", 0.5, "JobManager reconcile cadence: supervisor liveness polls, queued-job admission, and store job-table writes all run on this period.")
_flag("job_default_tenant", "default", "Tenant key assigned to submissions that carry none; quota/weight defaults below apply to tenants never configured explicitly via set_tenant.")
_flag("job_tenant_max_running", 8, "Default per-tenant cap on concurrently RUNNING (admitted) jobs; a tenant's queued burst beyond the cap waits in the fair-share queue instead of flooding the cluster.")
_flag("job_tenant_weight", 1.0, "Default fair-share weight for unconfigured tenants: admission order charges each tenant virtual time = job cost / weight, so completed-work share converges to the weight ratio under contention.")
_flag("job_stop_grace_s", 5.0, "Seconds between SIGTERM and SIGKILL when stopping a job's driver process group.")
_flag("job_supervisor_poll_timeout_s", 10.0, "Deadline on one JobManager->JobSupervisor liveness poll; expiry counts as a supervisor death (job FAILED or requeued under its max_retries).")

# --- autoscaler (demand-driven reconciler; autoscaler/) ---
_flag("autoscaler_poll_period_s", 1.0, "Autoscaler reconcile loop period (AutoscalingConfig.poll_period_s default).")
_flag("autoscaler_idle_timeout_s", 10.0, "Nodes idle this long are drained (reversibly), then terminated if still idle on a later poll (AutoscalingConfig.idle_timeout_s default).")
_flag("autoscaler_max_workers", 2, "Default cap on autoscaler-launched worker nodes (AutoscalingConfig.max_workers default).")
_flag("autoscaler_demand_driven", True, "Scale on the full demand aggregate — pending lease shapes, unplaced placement-group bundles, QUEUED/PENDING job resources from the job table, and reported demand (elastic-train target width). Off = legacy liveness-reactive mode: only heartbeat-reported pending leases drive scale-up (the bench_jobs A/B lever).")
_flag("autoscaler_job_shapes_max", 256, "Cap on queued-job resource shapes included in one get_cluster_load reply; the uncounted tail still rides the pending_jobs_total count.")
_flag("report_demand_ttl_s", 10.0, "Default expiry on report_demand entries (elastic-train target width and other pushed demand sources); reporters refresh on their own cadence, so a dead reporter's demand ages out instead of holding nodes forever.")

# --- retry policy (shared by RPC calls, object fetch, lease requests) ---
_flag("retry_base_s", 0.2, "Unified retry policy: first backoff delay (reference: retryable_grpc_client backoff base).")
_flag("retry_max_s", 5.0, "Unified retry policy: backoff cap (decorrelated jitter draws in [base, prev*3] clipped here).")
_flag("shutdown_timeout_s", 30.0, "Total deadline on ray_tpu_torch.shutdown(): bounds job-finish + close so a drain or control-store failover in progress cannot hang driver exit (deadline machinery from _private.retry).")

# --- serve overload plane (serve/_replica.py, _handle.py, _http.py) ---
_flag("serve_max_queued_requests", 1000, "Default bounded queue per serve replica: admitted-but-not-running requests beyond this are rejected with BackpressureError (HTTP 503 + Retry-After). Per-deployment override: @serve.deployment(max_queued_requests=); -1 = unbounded (reference: serve max_queued_requests admission control).")
_flag("serve_default_timeout_s", 0.0, "Default end-to-end request deadline applied by handles when the caller sets none (0 = no deadline). Explicit handle.options(timeout_s=) / the X-Serve-Timeout-S HTTP header / rt-serve-timeout-s gRPC metadata always win.")
_flag("serve_retry_after_s", 1.0, "Suggested client backoff carried on BackpressureError and emitted as the HTTP Retry-After header on 503 sheds.")
_flag("serve_retry_budget_ratio", 0.2, "Serve handle retry budget: tokens deposited per successful request (each failover retry spends one) — sustained retry throughput is capped at this fraction of recent goodput so overload can't amplify itself (reference: envoy retry budgets).")
_flag("serve_retry_budget_min", 3, "Initial retry-budget floor per handle: failovers available before any success has been observed (cold handles must still ride out one replica death).")
_flag("serve_outlier_consecutive_failures", 3, "Consecutive failures/timeouts on one replica before the handle ejects it from the routing set (reference: envoy outlier detection).")
_flag("serve_outlier_probation_s", 5.0, "How long an ejected replica stays out of the routing set; the first request after the window is the probation re-probe (one more failure re-ejects immediately).")
_flag("serve_shed_at_ingress", True, "Shed at the handle/proxy BEFORE spending a replica RPC when every replica's freshly probed load is at capacity (max_concurrent + max_queued). Requires a bounded queue; stale probes read as headroom.")
_flag("serve_refresh_timeout_s", 5.0, "Deadline on one handle->controller routing-table refresh attempt; expiry (controller outage) keeps the last-known replica set serving and retries on this cadence instead of the full refresh TTL.")
_flag("serve_health_probe_timeout_s", 10.0, "Serve controller reconcile-loop replica health/stats probe deadline; a probe that expires marks the replica unhealthy (wedged replicas are killed and replaced instead of freezing the deployment's reconcile forever).")
_flag("serve_replica_init_timeout_s", 60.0, "Deadline on a new replica's construction gate (first health probe); a replica wedged in __init__ is reaped instead of holding the controller's scale lock forever.")

# --- serve autoscaling plane (serve/_autoscaling.py; reference: Serve AutoscalingStateManager) ---
_flag("serve_autoscale_target_ongoing_requests", 2.0, "Default per-replica load target for the replica autoscaler: desired replicas = total load (ongoing + queued, peak-of-window) / this. Per-deployment override via @serve.deployment(autoscaling_config={'target_ongoing_requests': ...}).")
_flag("serve_autoscale_upscale_delay_s", 0.0, "How long demand must exceed the current replica count before scaling UP. 0 = immediate (spikes pull replicas on the next reconcile tick); raise to ride out sub-second blips at the cost of spike latency.")
_flag("serve_autoscale_downscale_delay_s", 10.0, "Scale-down cooldown: the autoscaler only sheds replicas after demand has stayed below the current count for this long, and sizes to the PEAK demand seen inside the window — hysteresis so a sawtooth load doesn't thrash replica churn.")
_flag("serve_autoscale_demand_report", True, "Publish pending (unplaceable) replica resource shapes through the report_demand plane so the node autoscaler launches capacity for replicas that don't fit anywhere — spike -> replicas -> nodes in one reconcile pass. Off = replicas above current cluster capacity wait for unrelated capacity to appear.")

# --- LLM prefix cache (llm/_prefix_cache.py; reference: vLLM automatic prefix caching / ray.llm kv_aware routing) ---
_flag("llm_prefix_cache_enabled", True, "Block-granular prompt-prefix KV reuse in PagedEngine: full prompt blocks are content-hashed and refcounted across requests, so a shared-prefix request prefills only its suffix (the bench_llm A/B lever). Off = every request prefills from scratch.")
_flag("llm_prefix_cache_max_entries", 4096, "Cap on cached prefix-block entries per engine (refcounted blocks in active use are never evicted; zero-ref LRU subtrees go first). Bounds host-side cache bookkeeping, not device KV memory — the paged pool itself is the real limit.")

# --- serve ingress (proxy fleet; reference: Serve proxy_location) ---
_flag("serve_proxy_location", "head", "Where serve.start() places HTTP ingress proxies when the caller passes none: 'head' = one proxy on the driver (one CPython event loop is the single-ingress SSE ceiling), 'every_node' = one 0-CPU proxy pinned per serving node (the bench_llm proxy-fleet lever: the fleet splits ingress dispatch across nodes).")

# --- graceful drain & preemption (reference: DrainNode protocol, NodeDeathInfo) ---
_flag("drain_deadline_s", 30.0, "Default drain deadline: how long a draining node lets running work finish before it replicates primaries, migrates actors, and exits with an expected-termination record.")
_flag("drain_replicate_max_objects", 4096, "Max primary object copies a draining node proactively replicates to live peers before exiting (objects beyond the cap fall back to lineage reconstruction).")
_flag("preemption_watcher_enabled", False, "Run the GCE maintenance-event/preemption watcher on each node daemon; a notice triggers an automatic drain with reason=preemption (reference: spot TPU-VM preemption gives 30-90s of warning).")
_flag("preemption_poll_period_s", 1.0, "Preemption watcher metadata-server poll period.")
_flag("preempt_proactive", True, "Proactive preemption survival (the bench_preempt A/B lever): a preemption notice puts the node in PREEMPTING (still scheduling) instead of draining immediately; the autoscaler treats its committed load as demand NOW, pre-provisions replacement capacity in the same tranche machinery, and only starts the reversible drain once replacements register or the deadline forces it — overlapping node boot with the drain window. Off = legacy reactive mode: notice -> immediate self-drain, replacement launches only after the death.")
_flag("preempt_notice_ttl_s", 60.0, "Expiry on a published preemption notice: a PREEMPTING node whose notice ages out without a drain or death (reclaim cancelled, publisher gone) returns to ALIVE and stops counting as proactive demand. Publishers refresh on preempt_republish_period_s, so a live notice never ages out.")
_flag("preempt_republish_period_s", 5.0, "Node-daemon cadence for refreshing its published preemption notice until the drain starts. Re-publishing (idempotent) keeps the TTL fresh AND survives a control-store failover mid-notice — the new primary rebuilds the notice even if the WAL record raced the takeover.")
_flag("preempt_drain_grace_frac", 0.5, "Fraction of the notice deadline a PREEMPTING daemon waits for the control plane to start the drain (replacement capacity registered) before forcing the self-drain anyway — the local failsafe that bounds how much of the warning window proactive provisioning may consume.")

# --- elastic training (train/_controller.py, train/_elastic.py) ---
_flag("train_max_drain_rejoins", 16, "Bound on planned-removal rejoins/resizes per training run: drain-triggered recoveries never charge the failure budget, so a pathological drain loop is bounded separately by this.")
_flag("train_expected_death_fresh_s", 120.0, "How long an expected-death node record counts as 'fresh': within this window a worker loss on that node is classified as planned (checkpoint-then-rejoin / live shrink, budget untouched) and the node's resources are excluded from elastic sizing. Shared by the controller's planned-failure detection and the regrow trigger's usable-capacity read.")
_flag("train_live_resize", True, "Elastic runs resize the live gang on planned node removal/return instead of teardown+checkpoint-restore: survivors pause at a step barrier, lost shards re-shard over the object plane, ranks renumber under a new generation. Requires the train fn to drive ElasticClient.sync(); falls back to checkpoint-restore when workers never park.")
_flag("train_resize_park_timeout_s", 20.0, "How long a live resize waits for every worker to park at its step boundary (and for joiners/survivors to absorb their payload) before aborting back to the checkpoint-restore path. Keep under the drain deadline: the doomed ranks must publish and be released before their node exits.")
_flag("train_node_watch_period_s", 0.5, "Train controller node-table poll period for resize triggers (drain notices -> shrink, returned capacity -> regrow). The 'nodes' pubsub listener short-circuits the wait; this is the floor under notice loss.")
_flag("train_regrow_cooldown_s", 2.0, "Minimum spacing between regrow attempts so a flapping node can't thrash the gang through resize churn.")

# --- chaos / fault injection (day 1, per SURVEY §4) ---
_flag("testing_chaos_seed", 0, "Seed for the per-process chaos PRNG (mixed with the process's chaos role). 0 = fresh entropy. A seeded run replays every injected delay/drop/jitter draw exactly — reproduce any chaos failure from its seed.")
_flag("testing_event_loop_delay_us", "", "Inject delays into event-loop handlers. Format: 'method:min_us:max_us,...' ('*' matches all). Mirrors RAY_testing_asio_delay_us.")
_flag("testing_rpc_failure", "", "Inject RPC failures. Format: 'method:max_failures:req_prob:resp_prob,...' ('*' matches all). Mirrors RAY_testing_rpc_failure.")
_flag("testing_rpc_stall", "", "Server-side RESPONSE stalls: 'method:ms:count,...' — the handler runs, then the reply stalls ms milliseconds, count times (models a wedged-but-alive control store).")
_flag("testing_rpc_partition", "", "One-way RPC-layer partition: 'src>dst#count,...' — a client in a process whose chaos role matches src cannot reach peers whose address matches dst; heals after count blocked sends (omit for unbounded).")
_flag("testing_process_kill", "", "Process-kill fault: 'role:method:nth,...' — the nth dispatch of method in a process whose chaos role matches exits hard (os._exit 137).")
_flag("testing_preempt_notice", "", "Seeded preemption-notice fault: 'role:delay_ms:deadline_ms,...' — a node daemon whose chaos role matches receives a synthetic preemption notice delay_ms after startup and drains itself with the given deadline (models a GCE maintenance event / spot reclaim, deterministically).")
_flag("testing_preempt_wave", "", "Correlated spot-reclaim wave fault: 'frac:window_ms:deadline_ms' — a seeded draw preempts frac of the SPOT fleet (labels.spot=true), each victim receiving its notice at a deterministic offset inside one window_ms burst with deadline_ms until hard death. Models the real-world correlated reclaim that single-notice faults cannot: an elastic gang shrinking below min_workers or a serve deployment losing every replica at once.")

# --- GPU (the tpu_* flags' counterparts) ---
_flag("gpus_per_host", 0, "Override detected CUDA devices per host (0 = autodetect). Counterpart of tpu_chips_per_host.")
_flag("gpu_visible_devices", "", "Restrict the node's workers to these CUDA device ids (comma-separated), as CUDA_VISIBLE_DEVICES does: detection (RT_GPU_AUTODETECT) keeps only these, each of which it must have found, and every worker's CUDA_VISIBLE_DEVICES names them. Counterpart of tpu_visible_chips.")
_flag("gpu_topology", "", "The NVLink domain this node belongs to, as 'HxG': H hosts of G CUDA devices each (e.g. '1x8' for one 8-GPU node, '18x4' for an NVL72 rack). Empty: the node is a domain of its own, '1x<its device count>'. Counterpart of tpu_topology; the domain's name and this host's index in it come from GPU_DOMAIN_NAME and GPU_WORKER_ID (TPU_NAME, TPU_WORKER_ID).")


def get(name: str) -> Any:
    return GLOBAL_CONFIG.get(name)
