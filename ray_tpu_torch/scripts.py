"""Cluster CLI: `python -m ray_tpu_torch.scripts <command>`.

Reference surface: python/ray/scripts/scripts.py (`ray start` :800,
`ray stop` :1341, `ray status`, `ray job submit/status/logs/list/stop`,
`ray serve`). Head state (address + pids)
persists in a state file so `stop`/`status` work from a fresh shell; it is
not the JAX package's file, so neither CLI stops the other's nodes.

`start` gives a node `--num-gpus` CUDA devices as its "GPU" resource; without
it the node daemon detects them when RT_GPU_AUTODETECT is set. `job submit
--resources '{"GPU": 1}'` leases the job a card. `up cluster.yaml` starts a
head and the autoscaler (``autoscaler/launcher.py``), which brings GPU
workers and NVLink domains up and down with demand; `down` tears it down.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile
import time

STATE_FILE = os.path.join(tempfile.gettempdir(), "ray_tpu_sessions",
                          "torch_cluster_state.json")


def _save_state(state: dict):
    os.makedirs(os.path.dirname(STATE_FILE), exist_ok=True)
    with open(STATE_FILE, "w") as f:
        json.dump(state, f)


def _load_state() -> dict:
    try:
        with open(STATE_FILE) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}


def cmd_start(args) -> int:
    from ray_tpu_torch._private import node as node_mod
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    if args.system_config:
        GLOBAL_CONFIG.apply_system_config(json.loads(args.system_config))
    resources = json.loads(args.resources) if args.resources else {}
    if args.num_cpus is not None:
        resources["CPU"] = float(args.num_cpus)
    if args.num_gpus is not None:
        resources["GPU"] = float(args.num_gpus)

    session_dir = node_mod.new_session_dir()
    pids = []
    if args.head:
        cs_proc, control_address = node_mod.start_control_store(
            session_dir, port=args.port)
        pids.append(cs_proc.pid)
    else:
        if not args.address:
            print("--address required for a non-head node", file=sys.stderr)
            return 2
        control_address = args.address
    nd_proc, nd_info = node_mod.start_node_daemon(
        control_address, session_dir,
        resources=resources or None,
        labels=json.loads(args.labels) if args.labels else None,
    )
    pids.append(nd_proc.pid)
    state = _load_state()
    nodes = state.get("nodes", [])
    nodes.append({"pids": pids, "session_dir": session_dir,
                  "address": control_address, "head": args.head})
    _save_state({"address": control_address, "nodes": nodes})
    print(f"ray_tpu_torch {'head' if args.head else 'node'} started")
    print(f"  address:     {control_address}")
    print(f"  session dir: {session_dir}")
    print(f"  connect:     ray_tpu_torch.init(address={control_address!r})")
    if args.block:
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            return cmd_stop(args)
    return 0


def cmd_stop(_args) -> int:
    state = _load_state()
    stopped = 0
    for node in state.get("nodes", []):
        for pid in node.get("pids", []):
            try:
                os.killpg(os.getpgid(pid), signal.SIGTERM)
                stopped += 1
            except (ProcessLookupError, PermissionError):
                pass
    try:
        os.unlink(STATE_FILE)
    except OSError:
        pass
    print(f"stopped {stopped} processes")
    return 0


def _resolve_address(args) -> str:
    addr = getattr(args, "address", None) or os.environ.get("RT_ADDRESS", "")
    if not addr:
        addr = _load_state().get("address", "")
    if not addr:
        print("no running cluster found (pass --address)", file=sys.stderr)
        raise SystemExit(2)
    return addr


def cmd_status(args) -> int:
    import ray_tpu_torch

    ray_tpu_torch.init(address=_resolve_address(args))
    try:
        nodes = ray_tpu_torch.nodes()
        total = ray_tpu_torch.cluster_resources()
        avail = ray_tpu_torch.available_resources()
        print(f"{len(nodes)} node(s):")
        for n in nodes:
            print(f"  {n['node_id'][:12]}  {n['state']:6s}  {n['address']}"
                  f"  {n['resources']}")
        print(f"resources: {avail} available / {total} total")
    finally:
        ray_tpu_torch.shutdown()
    return 0


def cmd_job(args) -> int:
    import ray_tpu_torch
    from ray_tpu_torch.job_submission import JobSubmissionClient

    client = JobSubmissionClient(_resolve_address(args))
    try:
        if args.job_cmd == "submit":
            import shlex

            runtime_env = {}
            if args.working_dir:
                runtime_env["working_dir"] = args.working_dir
            if args.env_vars:
                runtime_env["env_vars"] = json.loads(args.env_vars)
            argv = list(args.entrypoint)
            if argv and argv[0] == "--":
                argv = argv[1:]
            sid = client.submit_job(
                entrypoint=shlex.join(argv), runtime_env=runtime_env,
                tenant=args.tenant,
                resources=json.loads(args.resources)
                if args.resources else None,
                max_retries=args.max_retries)
            print(f"submitted job {sid}")
            if not args.no_wait:
                for chunk in client.tail_job_logs(sid):
                    sys.stdout.write(chunk)
                    sys.stdout.flush()
                status = client.get_job_status(sid)
                print(f"\njob {sid} finished: {status}")
                return 0 if status == "SUCCEEDED" else 1
        elif args.job_cmd == "status":
            print(client.get_job_status(args.id))
        elif args.job_cmd == "logs":
            print(client.get_job_logs(args.id))
        elif args.job_cmd == "stop":
            client.stop_job(args.id)
            print(f"stopped {args.id}")
        elif args.job_cmd == "list":
            for j in client.list_jobs(offset=args.offset, limit=args.limit,
                                      tenant=args.tenant):
                print(f"{j['submission_id']}  {j['status']:10s} "
                      f"{j.get('tenant', ''):12s} {j['entrypoint']}")
    finally:
        ray_tpu_torch.shutdown()
    return 0


def cmd_serve(args) -> int:
    """`serve run|deploy|status|shutdown` (reference: the serve CLI
    in python/ray/serve/scripts.py driving config-file deploys)."""
    import json
    import time

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.schema import deploy_config

    ray_tpu_torch.init(address=_resolve_address(args))
    if args.serve_cmd in ("run", "deploy"):
        handles = deploy_config(args.config)
        base = handles.pop("_http", "")
        print(json.dumps({"applications": sorted(handles),
                          "http": base}))
        if args.serve_cmd == "run" and not args.non_blocking:
            try:
                while True:
                    time.sleep(3600)
            except KeyboardInterrupt:
                serve.shutdown()
        return 0
    if args.serve_cmd == "status":
        print(json.dumps(serve.status(), indent=2, default=str))
        return 0
    serve.shutdown()
    return 0


def cmd_up(args) -> int:
    """Config-driven cluster launch (reference: `ray up`,
    autoscaler/_private/commands.py). Blocks hosting the autoscaler loop —
    the reconciler AND the provisioned-resource handles live in this
    process, so exiting it must (and does) tear the cluster down: Ctrl-C
    or a `down` from another shell (which SIGTERMs this pid) both run the
    full shutdown, terminating autoscaler-launched workers/domains too."""
    from ray_tpu_torch.autoscaler.launcher import (cluster_up,
                                                   load_cluster_config,
                                                   save_launch_state)

    cfg = load_cluster_config(args.config)
    cluster = cluster_up(cfg)
    state = _load_state()
    nodes = state.get("nodes", [])
    entry = {"pids": [p.pid for p in cluster.head_procs],
             "session_dir": cluster.session_dir,
             "address": cluster.control_address, "head": True,
             "up_pid": os.getpid()}
    nodes.append(entry)
    _save_state({"address": cluster.control_address, "nodes": nodes})
    if args.state_file:
        save_launch_state(cluster, args.state_file)
    print(f"cluster {cfg['cluster_name']} up")
    print(f"  address: {cluster.control_address}")
    print(f"  connect: ray_tpu_torch.init(address="
          f"{cluster.control_address!r})")
    print("  stop:    Ctrl-C here, or `down` from another shell", flush=True)

    def _teardown():
        print("shutting down cluster")
        cluster.shutdown()  # terminates provisioned workers/domains too
        state = _load_state()
        remaining = [n for n in state.get("nodes", [])
                     if n.get("up_pid") != os.getpid()]
        if remaining:
            _save_state({"address": remaining[-1]["address"],
                         "nodes": remaining})
        else:
            try:
                os.unlink(STATE_FILE)
            except OSError:
                pass

    def _on_sigterm(_sig, _frame):
        _teardown()
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        while True:
            time.sleep(5)
    except KeyboardInterrupt:
        _teardown()
        return 0


def cmd_down(args) -> int:
    """Tear down clusters: `up` processes get SIGTERM (their handler runs
    the full shutdown incl. provisioned cloud resources), `start` nodes'
    process groups are killed directly (reference: `ray down`)."""
    state = _load_state()
    for node in state.get("nodes", []):
        pid = node.get("up_pid")
        if pid:
            try:
                os.kill(pid, signal.SIGTERM)
                print(f"signalled `up` process {pid} to tear down")
            except (ProcessLookupError, PermissionError):
                pass
    time.sleep(2)  # give the up processes their clean shutdown window
    return cmd_stop(args)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ray_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser(
        "up", help="launch a cluster from a YAML config (head + autoscaler; "
                   "blocks — Ctrl-C or `down` tears it down)")
    sp.add_argument("config")
    sp.add_argument("--state-file", default="")
    sp.set_defaults(fn=cmd_up)

    sp = sub.add_parser("down", help="tear down a cluster started by `up`")
    sp.set_defaults(fn=cmd_down)

    sp = sub.add_parser("start", help="start a head or worker node")
    sp.add_argument("--head", action="store_true")
    sp.add_argument("--address", default="")
    sp.add_argument("--port", type=int, default=0)
    sp.add_argument("--num-cpus", type=float, default=None)
    sp.add_argument("--num-gpus", type=float, default=None)
    sp.add_argument("--resources", default="")
    sp.add_argument("--labels", default="")
    sp.add_argument("--system-config", default="")
    sp.add_argument("--block", action="store_true")
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("stop", help="stop all locally started nodes")
    sp.set_defaults(fn=cmd_stop)

    sp = sub.add_parser("status", help="show cluster nodes + resources")
    sp.add_argument("--address", default="")
    sp.set_defaults(fn=cmd_status)

    sp = sub.add_parser("job", help="submit and manage jobs")
    sp.add_argument("--address", default="")
    jsub = sp.add_subparsers(dest="job_cmd", required=True)
    js = jsub.add_parser("submit")
    js.add_argument("--working-dir", default="")
    js.add_argument("--env-vars", default="")
    js.add_argument("--no-wait", action="store_true")
    js.add_argument("--tenant", default=None,
                    help="tenant key for quota/fair-share accounting")
    js.add_argument("--resources", default="",
                    help='job resource request as JSON, e.g. \'{"GPU": 1}\'')
    js.add_argument("--max-retries", type=int, default=0,
                    help="resubmissions allowed after supervisor loss")
    js.add_argument("entrypoint", nargs=argparse.REMAINDER)
    for name in ("status", "logs", "stop"):
        j = jsub.add_parser(name)
        j.add_argument("id")
    jl = jsub.add_parser("list")
    jl.add_argument("--offset", type=int, default=0)
    jl.add_argument("--limit", type=int, default=100)
    jl.add_argument("--tenant", default=None)
    sp.set_defaults(fn=cmd_job)

    sp = sub.add_parser(
        "serve", help="deploy serve applications from a config file")
    sp.add_argument("--address", default="")
    ssub = sp.add_subparsers(dest="serve_cmd", required=True)
    sr = ssub.add_parser("run", help="deploy a config and block")
    sr.add_argument("config")
    sr.add_argument("--non-blocking", action="store_true")
    sd = ssub.add_parser("deploy", help="deploy a config and return")
    sd.add_argument("config")
    ssub.add_parser("status")
    ssub.add_parser("shutdown")
    sp.set_defaults(fn=cmd_serve)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
