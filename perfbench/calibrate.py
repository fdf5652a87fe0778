"""Readings the limits of a cell are set from: for each seed, the compared
numbers of the program, of the control one precision below the
configuration's, and of each planted fault the cell's driver knows; one
JSON line a seed, then the largest program reading and the smallest
control and fault readings of each number.

    python3 -m perfbench.calibrate --workload <cell> --seeds 11,12,13 [--out FILE]

It runs on the card (or with `--device cpu`), in one process for all the
seeds; the benchmark's runs never run it."""

from __future__ import annotations

import argparse
import json
import time

from perfbench import registry
from perfbench.harness import Context


def calibrate(workload: str, seeds, device="cuda", root=registry.ROOT) -> dict:
    cell = registry.find_cell(workload, root)
    drv = registry.driver(cell)
    per_seed, leaves = {}, {}
    for seed in seeds:
        t0 = time.perf_counter()
        ctx = Context(cell, seed, 0.0, False, device, t0)
        per_seed[seed] = drv.calibration(ctx)
        if "_leaves" in per_seed[seed]:
            leaves[seed] = per_seed[seed].pop("_leaves")
        print(json.dumps({"seed": seed, "seconds": time.perf_counter() - t0,
                          **per_seed[seed]}), flush=True)
    summary = {}
    for kind in next(iter(per_seed.values())):
        for k in cell.limits:
            vals = [r[kind][k] for r in per_seed.values()]
            summary.setdefault(k, {})[kind] = max(vals) if kind == "program" else min(vals)
    return {"workload": workload, "seeds": list(seeds), "per_seed": per_seed,
            "summary": summary, "leaves": leaves}


def main(argv=None):
    ap = argparse.ArgumentParser(description="readings for a cell's limits")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = calibrate(args.workload, [int(s) for s in args.seeds.split(",")], args.device)
    print(json.dumps(out["summary"]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
