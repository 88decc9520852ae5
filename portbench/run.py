"""Runs one cell of the port's benchmark once and prints its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell is made of is found by name: the cell in
``workloads/<name>.json`` (its configuration, traffic mix, driver, engine
sizes and correctness limits), the configuration in
``configs/<config>.json``, the traffic mix in ``traffic/<traffic>.json``,
the driver in ``drivers/<driver>.py`` and each metric that
``BENCHMARK.json`` gives the cell in ``metrics/<metric>.py``. With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profile of a steady
stretch of the window. The last line on standard output is the result;
the numbers that decided ``correct`` come last in it (``checks``) and as
the last lines on standard error.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Any, Dict, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "ray_tpu")


def cache_env():
    """Fixed cache directories inside the checkout, set before torch loads,
    so that only a checkout's first run builds or compiles. The kernels'
    own libraries stay where the program keeps them
    (``ray_tpu_torch/_build/``, also inside the checkout)."""
    cache = os.path.join(HERE, ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(cache, "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def _path_setup():
    for p in (ROOT, HERE):
        if p not in sys.path:
            sys.path.insert(0, p)


def load_json(*parts) -> Dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name}".replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


@dataclass
class Run:
    """One run of one cell, as the driver gets it."""
    name: str
    cell: Dict
    mc: Dict
    mix: Dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    tmpdir: str
    t0: float = T0
    # {"control": True}: also read the control (``calibrate.py``)
    extra: Dict = field(default_factory=dict)


def cell_metrics(bench: Dict, name: str, traced: bool):
    """The names of the metrics that ``BENCHMARK.json`` gives a cell's
    line: its end-to-end metrics, or with a trace its per-layer ones."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not traced:
        return [m["name"] for m in e2e]
    e2e_names = {m["name"] for m in e2e}
    return [m["name"] for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in e2e_names
                             else [])]


def run_cell(name: str, seed: int, seconds: float, traced: bool, device,
             overrides: Optional[Dict] = None,
             extra: Optional[Dict] = None) -> Dict:
    """Drive one run and assemble its result (without printing it).
    ``overrides`` replaces parts of the cell, its configuration or its mix
    (the tests' tiny sizes)."""
    _path_setup()
    overrides = overrides or {}
    cell = {**load_json("workloads", f"{name}.json"), **overrides.get("cell", {})}
    mc = {**load_json("configs", f"{cell['config']}.json"),
          **overrides.get("config", {})}
    mix = {**load_json("traffic", f"{cell['traffic']}.json"),
           **overrides.get("traffic", {})}
    bench = load_bench()
    tmp = tempfile.mkdtemp(prefix="portbench-")
    run = Run(name, cell, mc, mix, int(seed), float(seconds), bool(traced),
              device, tmp, extra=extra or {})
    out = load_module("drivers", cell["driver"]).run(run)
    ctx = out["ctx"]
    ctx.update(mc=mc, mix=mix)
    if traced:
        import devtrace

        ctx["trace"] = devtrace.Trace(out["trace_path"])
    metrics = {}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    for m in cell_metrics(bench, name, traced):
        value = load_module("metrics", m).read(ctx)
        if value is not None:
            metrics[m] = {"value": value, "unit": units[m]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": device_info(device, out["memory_peak_bytes"])}
    if traced:
        tr = ctx["trace"]
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = {k: {"value": v, "must_be": op, "limit": lim}
                        for k, (v, op, lim) in out["checks"].items()}
    result["_extra"] = out.get("extra", {})
    return result


def load_bench() -> Dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def device_info(device, peak) -> Dict:
    import torch

    if getattr(device, "type", str(device)) != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": int(peak)}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(peak)}
    try:
        info["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "unknown"
    return info


def report(result: Dict):
    """The numbers compared, each beside its limit, as the last lines on
    standard error; the result as the last line on standard output."""
    result = {k: v for k, v in result.items() if k != "_extra"}
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} must be {c['must_be']} "
              f"{c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    _path_setup()
    cell = load_json("workloads", f"{args.workload}.json")
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['chips']} cards wanted, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    found = banned_modules()
    if found:
        print(f"portbench: loaded {found} in the measured process",
              file=sys.stderr)
        return 4
    report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
