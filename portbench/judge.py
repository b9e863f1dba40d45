"""The comparison that decides `correct`.

- `logit_gap`: over a sample of the window's served sequences, run the
  plain reference once over each prompt with its served tokens; the
  widest gap by which a served token's reference logit lies below the
  reference's best logit at that position (0 where the program chose the
  reference's best). Greedy decoding, so a sound program reads the
  rounding of its own precision and nothing more.
- `logit_gap_mean`: the same gaps averaged over every sampled served
  token; steadier from seed to seed than the widest, where a few
  discrete choices inside the model (an expert's routing) can flip on
  rounding alone.
- `ledger_mismatch`: the store's counts and bytes of every completed
  call (hits, requests, lines, pages, wire and uncompressed bytes,
  writebacks, evictions, each module's bytes) against the NumPy
  reference's: the number of entries that differ. Exact: limit 0.
- `stall_rel_gap`: the summed movement-plane stall against the
  reference's, as a share of the reference's.

Each number is printed beside its limit; the run is correct when every
number is at or under its limit.
"""
from __future__ import annotations

import numpy as np
import torch

EXACT_KEYS = ("sub_block_fetches", "page_moves", "wire_bytes",
              "uncompressed_bytes", "local_hits", "requests",
              "writeback_bytes", "dirty_evicts", "evictions")


def served_gaps(ref_logits: torch.Tensor, tokens: torch.Tensor,
                prompt: int) -> torch.Tensor:
    """ref_logits (S, T-1, V) over tokens[:, :-1]; tokens (S, T). The
    gap of each served token (positions prompt..T-1), (S, T - prompt)."""
    pred = ref_logits[:, prompt - 1:]
    served = tokens[:, prompt:].long().to(pred.device)
    best = pred.max(dim=-1).values
    got = pred.gather(-1, served[..., None])[..., 0]
    return best - got


def control_gaps(ref_logits: torch.Tensor, low_logits: torch.Tensor,
                 prompt: int) -> torch.Tensor:
    """The gap in the reference of the token the lower-precision control
    puts first, at each served position."""
    pred = ref_logits[:, prompt - 1:]
    first = low_logits[:, prompt - 1:].argmax(dim=-1)
    return pred.max(dim=-1).values - pred.gather(-1, first[..., None])[..., 0]


def ledger_mismatch(got: dict, want: dict) -> list:
    """Names of the exactly compared ledger entries that differ."""
    bad = [k for k in EXACT_KEYS if got[k] != want[k]]
    if list(got["module_bytes"]) != list(want["module_bytes"]):
        bad.append("module_bytes")
    return bad


def stall_rel_gap(got: dict, want: dict) -> float:
    ref = want["stall_steps"]
    return abs(got["stall_steps"] - ref) / max(abs(ref), 1e-30)


def verdict(values: dict, limits: dict):
    """(correct, checks): each number the cell's limits name, beside its
    limit; a named number without a limit (null) or without a value
    fails."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = values.get(name, float("nan"))
        checks[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and bool(np.isfinite(value)) \
            and value <= limit
    return ok, checks
