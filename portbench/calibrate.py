"""Reads on the card the numbers that a cell's correctness limits are set
from: the program's readings over many seeds, and on some of them the
control (the reference in float8 in the program's place) and, for
training, the faults of half the batch left out (the reference on half the
rows in the program's place) and of the update applied with the wrong sign
(the reference at the negated learning rate). All seeds run in one process, one after the
other, each as a full run of the cell (set-up, window, check).

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        --control-seeds 1,2 --seconds 30 --out <file.jsonl>

One JSON line a seed goes to ``--out`` and to standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import run as harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    harness.cache_env()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    with open(args.out, "a") as f:
        for seed in (int(s) for s in args.seeds.split(",")):
            res = harness.run_cell(args.workload, seed, args.seconds, False,
                                   torch.device("cuda", 0),
                                   extra={"control": seed in controls})
            extra = res["_extra"]
            line = {"workload": args.workload, "seed": seed,
                    "correct": res["correct"],
                    "checks": {k: c["value"] for k, c in res["checks"].items()},
                    "metrics": {k: m["value"] for k, m in res["metrics"].items()},
                    "peak": res["device"]["memory_peak_bytes"]}
            for k in ("gaps", "control", "half_batch", "sign_flipped",
                      "sampled", "finished", "kv_blocks_held"):
                if k in extra:
                    line[k] = extra[k]
            f.write(json.dumps(line) + "\n")
            f.flush()
            print(json.dumps(line), flush=True)
            del res, extra
            gc.collect()
            torch.cuda.empty_cache()
    found = harness.banned_modules()
    if found:
        print(f"calibrate: loaded {found}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
