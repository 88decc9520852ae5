"""Worker process entry point.

Capability parity with the reference's worker main (reference:
python/ray/_private/workers/default_worker.py:323 →
CoreWorkerProcess::RunTaskExecutionLoop core_worker_process.cc:124):
connects to the node daemon and control store using env vars injected by the
daemon's worker pool, then serves push_task RPCs until killed.
"""

from __future__ import annotations

import asyncio
import logging
import os
import signal
import sys


def amain():
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch._private.core_worker import CoreWorker, MODE_WORKER, set_core_worker
    from ray_tpu_torch._private.ids import JobID, WorkerID
    from ray_tpu_torch._private.task_executor import TaskExecutor
    from ray_tpu_torch.runtime.rpc import RpcClient

    async def run():
        config_json = os.environ.get("RT_CONFIG_JSON", "")
        if config_json and config_json != "{}":
            GLOBAL_CONFIG.load_overrides(config_json)
        job_hex = os.environ["RT_JOB_ID"]
        cw = CoreWorker(
            mode=MODE_WORKER,
            control_address=os.environ["RT_CONTROL_ADDR"],
            daemon_address=os.environ["RT_DAEMON_ADDR"],
            store_name=os.environ["RT_STORE_NAME"],
            node_id_hex=os.environ["RT_NODE_ID"],
            job_id=JobID(bytes.fromhex(job_hex)) if job_hex else JobID.nil(),
            loop=asyncio.get_running_loop(),
            worker_id=WorkerID.from_hex(os.environ["RT_WORKER_ID"]),
        )
        cw.executor = TaskExecutor(cw)
        set_core_worker(cw)
        await cw.start()
        # register with the daemon's worker pool
        reg = RpcClient(os.environ["RT_DAEMON_ADDR"], name="worker->daemon")
        await reg.connect()
        reply = await reg.call(
            "worker_ready",
            {"worker_id": cw.worker_id.binary(), "address": cw.address},
        )
        await reg.close()
        if not reply.get("ok"):
            logging.error("daemon rejected worker registration: %s", reply)
            sys.exit(1)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        loop.add_signal_handler(signal.SIGTERM, stop.set)

        def dump_tasks():
            # `kill -USR2 <pid>`: print every live coroutine's await stack to
            # the worker log (hang forensics; faulthandler only sees threads).
            # Task.get_stack returns ONE frame for a suspended coroutine, so
            # walk the cr_await chain for the full await stack.
            for t in asyncio.all_tasks(loop):
                lines = []
                obj = t.get_coro()
                depth = 0
                while obj is not None and depth < 32:
                    frame = getattr(obj, "cr_frame", None) or getattr(
                        obj, "gi_frame", None) or getattr(obj, "ag_frame", None)
                    if frame is not None:
                        lines.append(
                            f'  File "{frame.f_code.co_filename}", line '
                            f"{frame.f_lineno}, in {frame.f_code.co_name}")
                    obj = getattr(obj, "cr_await", None) or getattr(
                        obj, "gi_yieldfrom", None) or getattr(
                        obj, "ag_await", None)
                    depth += 1
                logging.warning(
                    "TASK %s\n%s", t.get_name(),
                    "\n".join(lines) or "  <no frame>")

        loop.add_signal_handler(signal.SIGUSR2, dump_tasks)
        await stop.wait()
        await cw.close()

    asyncio.run(run())


def main():
    logging.basicConfig(
        level=os.environ.get("RT_LOG_LEVEL", "INFO"),
        format="%(asctime)s %(levelname)s worker %(message)s",
    )
    # hang forensics: `kill -USR1 <worker pid>` dumps all thread stacks to
    # the worker's stderr log (reference: ray worker SIGTERM stack dumps)
    import faulthandler

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    # perf forensics: RT_WORKER_PROFILE_DIR=<dir> cProfiles the worker's loop
    # thread, dumping <dir>/worker_<pid>.pstats at exit (reference: the
    # dashboard's on-demand py-spy profiling fills this role)
    profile_dir = os.environ.get("RT_WORKER_PROFILE_DIR")
    prof = None
    if profile_dir:
        import cProfile

        prof = cProfile.Profile()
        prof.enable()
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"worker_{os.getpid()}.pstats")

        def dump_profile(_sig, _frame):
            # `kill -PROF <pid>`: snapshot the profile mid-run. Signal
            # handlers run on the main (profiled) thread, keeping cProfile
            # state consistent; the pool reaps workers with SIGKILL, so an
            # at-exit-only dump would never run.
            prof.disable()
            prof.dump_stats(path)
            prof.enable()

        signal.signal(signal.SIGPROF, dump_profile)
    try:
        amain()
    except KeyboardInterrupt:
        pass
    except BaseException:
        # fatal worker crash: leave the flight-recorder ring next to the
        # worker logs before propagating (RT_SESSION_DIR is set by the
        # daemon's worker pool)
        from ray_tpu_torch._private import flight_recorder

        flight_recorder.crash_dump("worker_fatal")
        raise
    finally:
        if prof is not None:
            prof.disable()
            prof.dump_stats(
                os.path.join(profile_dir, f"worker_{os.getpid()}.pstats"))


if __name__ == "__main__":
    main()
