"""Repeated runs of cells, each in its own process as the check makes
them, and the spread of each metric.

    python3 portbench/sweep.py --workload <cell> [--workload ...] \
        --seeds 11,12,13 [--seconds S] [--trace 0|1] [--out DIR]

Runs `run.py` once per (cell, seed), in the order given, with the
cell's `run_seconds` unless `--seconds` is given; appends every result
line (with the cell, seed, exit code and wall time) to
`<out>/sweep.jsonl` and each run's standard error to `<out>/sweep.err`;
then prints, per cell and metric, the median and the spread: the
distance between the first and third quartiles
(`statistics.quantiles(values, n=4)`) as a share of the median.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "build" / "portbench"))
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    seconds = args.seconds or bench["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []
    for cell in args.workload:
        for seed in seeds:
            cmd = [sys.executable, str(ROOT / "portbench" / "run.py"),
                   "--workload", cell, "--seed", str(seed),
                   "--seconds", str(seconds), "--trace", str(args.trace)]
            t = time.perf_counter()
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                                  text=True)
            wall = time.perf_counter() - t
            with open(out / "sweep.err", "a") as f:
                f.write(f"### {cell} seed {seed} rc {proc.returncode}\n")
                f.write(proc.stderr[-20000:])
            lines = proc.stdout.strip().splitlines()
            try:
                res = json.loads(lines[-1]) if lines else None
            except json.JSONDecodeError:
                res = None
            row = {"cell": cell, "seed": seed, "rc": proc.returncode,
                   "wall_s": wall, "result": res}
            rows.append(row)
            with open(out / "sweep.jsonl", "a") as f:
                f.write(json.dumps(row) + "\n")
            brief = {} if res is None else {
                "correct": res["correct"], "calls": len(res["call_s"]),
                **{k: v["value"] for k, v in res["metrics"].items()},
                **{k: v["value"] for k, v in res["checks"].items()}}
            print(f"{cell} seed={seed} rc={proc.returncode} "
                  f"wall={wall:.1f} {json.dumps(brief)}", flush=True)
    for cell in args.workload:
        done = [r["result"] for r in rows
                if r["cell"] == cell and r["result"] is not None]
        names = sorted({k for r in done for k in r["metrics"]})
        for name in names:
            vals = [r["metrics"][name]["value"] for r in done
                    if name in r["metrics"]]
            if len(vals) >= 2:
                print(f"{cell} {name}: n={len(vals)} "
                      f"median={statistics.median(vals):.6g} "
                      f"spread={spread(vals):.5f} "
                      f"min={min(vals):.6g} max={max(vals):.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
