"""The port's benchmark: one run of one cell of `BENCHMARK.json`.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA GPU. Prints
each window call's seconds, then the numbers compared beside their
limits as the last lines of standard error, and one JSON object as the last line of standard output: with
`--trace 0` the cell's end-to-end metrics, with `--trace 1` its
per-layer metrics, the device trace's busy and window seconds and a
breakdown. Exits non-zero, printing no result, without enough CUDA
devices, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _paths():
    """The port's sources and the benchmark's package on the path; the
    program's build and kernel caches inside the checkout."""
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    cache = ROOT / "build" / "portbench"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "extensions"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    import torch
    from portbench import cell, harness
    spec = cell.load(args.workload)
    need = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: needs {need} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(spec, args.seed, args.seconds,
                              bool(args.trace), "cuda", T0)
    return report(result)


def report(result: dict) -> int:
    """Refuse a process that loaded JAX; else print the checks on
    standard error and the result line on standard output."""
    from portbench import harness
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {found[:8]}",
              file=sys.stderr)
        return 3
    print(f"portbench: {len(result['call_s'])} calls of "
          f"{[round(x, 4) for x in result['call_s']]} s", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
