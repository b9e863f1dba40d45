"""Readings that the limits of a cell's comparison are set from, and the
proof that its control fails them: per seed, the program's numbers as a
run compares them, and the lower-precision control's, each judged
against the cell's own limits (`limits/<cell>.json`).

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds S]

In one process, per seed: the cell's weights from the seed, the window's
calls of the cell's entry at its own batch and lengths, in order, until
`S` seconds have passed (by default the first call alone), and on the
sample of sequences a run compares: the program's logit gaps against
the float32 reference, and the control's, the reference itself with
every weight product rounded through float8 e4m3 (the gap of the token
it puts first). In a paged cell also the store's ledger against the
NumPy reference in float32 (the program's) and the reference's own
ledger in bfloat16 against it (the control of the ledger comparison).
One JSON line per seed on standard output, with each side's verdict;
exits 1 if the control comes out correct on any seed or the program
does not.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(spec: dict, seed: int, device, seconds: float = 0.0) -> dict:
    """The program's and the control's numbers on `seed`, and their
    verdicts against the cell's limits."""
    import torch

    from portbench import cell, harness, judge
    from portbench.reference import store
    cfg, tr = spec["config"], spec["traffic"]
    b = tr["batch"]
    arch = cell.port_arch(cfg)
    weights = cell.make_weights(cfg, seed, device)
    params = cell.port_params(weights, cfg)
    entry = harness.make_entry(spec, arch, params, device)
    calls, start = [], time.perf_counter()
    while not calls or time.perf_counter() - start < seconds:
        p, n = cell.call_lengths(tr, len(calls))
        prompts = torch.as_tensor(cell.prompts(seed, len(calls), b, p,
                                               cfg["vocab_size"]),
                                  device=device)
        tokens, led = entry(prompts, n)
        calls.append((tokens, led, p))
    sizes = [(t.shape[0], t.shape[1] - p) for t, _, p in calls]
    picks = cell.sample(seed, sizes, tr["sample_sequences"])
    ref = cell.reference(cfg)
    prog, ctrl = [], []
    for c in sorted({c for c, _ in picks}):
        tokens, _, p = calls[c]
        rows = [r for cc, r in picks if cc == c]
        for i in range(0, len(rows), 4):
            block = tokens[rows[i:i + 4]]
            f32 = ref.logits(weights, cfg, block[:, :-1])
            low = ref.logits(weights, cfg, block[:, :-1], quant="fp8")
            prog.append(judge.served_gaps(f32, block, p).flatten().cpu())
            ctrl.append(judge.control_gaps(f32, low, p).flatten().cpu())
    prog, ctrl = torch.cat(prog), torch.cat(ctrl)
    values = {"logit_gap": float(prog.max()),
              "logit_gap_mean": float(prog.mean())}
    control = {"logit_gap": float(ctrl.max()),
               "logit_gap_mean": float(ctrl.mean())}
    out = {"seed": seed, "calls": len(calls), "served": int(prog.numel()),
           "tokens_off": int((prog > 0).sum()),
           "control_tokens_off": int((ctrl > 0).sum())}
    if calls[0][1] is not None:
        lengths = [(p, t.shape[1] - p) for t, _, p in calls]
        want = harness.store_refs(spec, lengths)
        g = cell.store_geometry(spec)
        lows = {k: store.simulate(g, b, *k, tr["paged"]["window_pages"],
                                  tr["paged"]["pages_per_seq"],
                                  rounding="bfloat16")[0] for k in want}
        pairs = [(led, want[k][0], lows[k]) for (_, led, _), k in
                 zip(calls, lengths)]
        values["ledger_mismatch"] = float(max(
            len(judge.ledger_mismatch(led, w)) for led, w, _ in pairs))
        values["stall_rel_gap"] = max(judge.stall_rel_gap(led, w)
                                      for led, w, _ in pairs)
        control["ledger_mismatch"] = float(max(
            len(judge.ledger_mismatch(lo, w)) for _, w, lo in pairs))
        control["stall_rel_gap"] = max(judge.stall_rel_gap(lo, w)
                                       for _, w, lo in pairs)
    out["program"], out["control"] = values, control
    out["program_correct"], _ = judge.verdict(values, spec["limits"])
    out["control_correct"], out["control_checks"] = judge.verdict(
        control, spec["limits"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench import cell
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    spec = cell.load(args.workload)
    failed = False
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        row = readings(spec, seed, "cuda", args.seconds)
        row["seconds"] = time.perf_counter() - t
        print(json.dumps(row), flush=True)
        failed |= row["control_correct"] or not row["program_correct"]
        torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
