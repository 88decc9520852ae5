"""State CLI: `python -m ray_tpu_torch.util.state.state_cli list actors --address ...`

Reference surface: python/ray/util/state/state_cli.py (`ray list tasks`,
`ray summary tasks`, `ray timeline`). Connects to a running cluster by
address and prints table or JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _print_rows(rows, as_json: bool):
    if as_json:
        print(json.dumps(rows, indent=2, default=str))
        return
    if not rows:
        print("(none)")
        return
    cols = list(rows[0].keys())
    widths = {
        c: max(len(c), *(len(str(r.get(c, ""))) for r in rows)) for c in cols
    }
    print("  ".join(c.ljust(widths[c]) for c in cols))
    for r in rows:
        print("  ".join(str(r.get(c, "")).ljust(widths[c]) for c in cols))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ray_tpu_torch-state")
    ap.add_argument("--address", default=os.environ.get("RT_ADDRESS", ""),
                    help="cluster address host:port (or RT_ADDRESS env)")
    ap.add_argument("--json", action="store_true", dest="as_json")
    sub = ap.add_subparsers(dest="cmd", required=True)
    lp = sub.add_parser("list")
    lp.add_argument("what", choices=[
        "actors", "nodes", "tasks", "jobs", "placement-groups", "workers"])
    sp = sub.add_parser("summary")
    sp.add_argument("what", choices=["tasks", "objects"])
    tp = sub.add_parser("timeline")
    tp.add_argument("filename")
    args = ap.parse_args(argv)

    if not args.address:
        ap.error("--address (or RT_ADDRESS) required")
    import ray_tpu_torch
    from ray_tpu_torch.util import state

    ray_tpu_torch.init(address=args.address)
    try:
        if args.cmd == "list":
            fn = {
                "actors": state.list_actors,
                "nodes": state.list_nodes,
                "tasks": state.list_tasks,
                "jobs": state.list_jobs,
                "placement-groups": state.list_placement_groups,
                "workers": state.list_actors,  # workers ~ actor processes
            }[args.what]
            _print_rows(fn(), args.as_json)
        elif args.cmd == "summary":
            if args.what == "tasks":
                print(json.dumps(state.summarize_tasks(), indent=2))
            else:
                _print_rows(state.summarize_objects(), args.as_json)
        elif args.cmd == "timeline":
            out = state.timeline(args.filename)
            print(f"wrote {out}")
    finally:
        ray_tpu_torch.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
