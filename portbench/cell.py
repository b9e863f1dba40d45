"""A cell of the benchmark, found by name: its entry in `BENCHMARK.json`,
its configuration (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`) and the limits of its comparison
(`limits/<cell>.json`); the port's architecture it runs, checked against
the configuration's published sizes; the configuration's plain
reference (`reference/<reference>.py`, by default its `family`), which
lists the weights to draw and maps them onto the port's parameter
tree; and the inputs made from the seed: the weights, on the device in
a few large draws, and the prompts. A configuration is thus its file,
its reference module, a traffic mix and a limits file per cell: new
files, with no edit of this module or of the harness.

A traffic mix lists its calls' lengths (`calls`: [prompt tokens, new
tokens] per call, in the order they run, every seed the same); the
window cycles through them, and each call's B prompts share its lengths.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# configuration key -> the port's ArchConfig field it must equal
_ARCH_KEYS = {"num_hidden_layers": "num_layers", "hidden_size": "d_model",
              "num_attention_heads": "num_heads",
              "num_key_value_heads": "num_kv_heads", "head_dim": "head_dim",
              "intermediate_size": "d_ff", "vocab_size": "vocab_size",
              "rope_theta": "rope_theta", "torch_dtype": "dtype",
              "num_experts": "num_experts",
              "num_experts_per_tok": "experts_per_token"}


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def load(name: str, root: Path = ROOT) -> dict:
    """Everything the harness needs to run cell `name`."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]

    def applies(metric):
        return name in metric.get("workloads", [name])

    return {"cell": cell,
            "config": _json(HERE / "configs" / f"{cell['config']}.json"),
            "traffic": _json(HERE / "traffic" / f"{cell['traffic']}.json"),
            "limits": _json(HERE / "limits" / f"{name}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}


def port_arch(cfg: dict):
    """The port's ArchConfig named by the configuration, with its
    `port_overrides`; raises unless it has the configuration's sizes."""
    from repro_torch.configs import get_config
    arch = get_config(cfg["port_config"])
    arch = dataclasses.replace(arch, **cfg.get("port_overrides", {}))
    for key, field in _ARCH_KEYS.items():
        want = cfg.get(key, 0)
        have = getattr(arch, field)
        if key == "head_dim":
            have = arch.resolved_head_dim
        if want != have:
            raise ValueError(f"{cfg['name']}: {key} is {want} in the "
                             f"configuration, {have} in repro_torch")
    if cfg["family"] != arch.family:
        raise ValueError(f"{cfg['name']}: family {cfg['family']} against "
                         f"repro_torch's {arch.family}")
    return arch


def store_geometry(spec: dict) -> dict:
    """The configuration's store, with the traffic's overrides."""
    return {**spec["config"]["store"], **spec["traffic"].get("store", {})}


def padded_vocab(vocab: int) -> int:
    return -(-vocab // 512) * 512


def reference(cfg: dict):
    """The configuration's plain reference, `reference/<name>.py`: the
    module its `reference` key names, by default its `family`. It gives
    the leaves the seed draws, their place in the port's parameter tree
    and the logits the comparison holds the program to."""
    return importlib.import_module(
        f"portbench.reference.{cfg.get('reference', cfg['family'])}")


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The model's weights from `seed`, drawn on `device` one stacked
    leaf at a time as the configuration's reference lists them (its
    `leaves`: name, shape, scale, dtype). With `tie_word_embeddings`
    one table, drawn as the output head is in the embedding's place, is
    both the embedding and the output head. A flat dict by name."""
    gen = torch.Generator(device=device).manual_seed(seed)
    leaves = reference(cfg).leaves(cfg, padded_vocab(cfg["vocab_size"]))
    tied = cfg.get("tie_word_embeddings", False)
    if tied:
        head = next(leaf for leaf in leaves if leaf[0] == "unembed")
        leaves = [("embed", *head[1:]) if leaf[0] == "embed" else leaf
                  for leaf in leaves if leaf[0] != "unembed"]
    w = {name: torch.randn(shape, generator=gen, device=device,
                           dtype=dtype).mul_(scale)
         for name, shape, scale, dtype in leaves}
    if tied:
        w["unembed"] = w["embed"]
    return w


def port_params(w: dict, cfg: dict) -> dict:
    """The same tensors in repro_torch's parameter tree, without copies
    (the configuration's reference's `port_params`)."""
    return reference(cfg).port_params(w)


WARM_CALL = 1 << 21      # the warm call's prompt stream, past every call's


def call_lengths(traffic: dict, call: int) -> tuple:
    """(prompt tokens, new tokens) of window call `call` (0-based): the
    mix's `calls` in order, over and over."""
    p, n = traffic["calls"][call % len(traffic["calls"])]
    return p, n


def warm_lengths(traffic: dict) -> tuple:
    """The lengths of the set-up's warm call: the mix's shortest call."""
    p, n = min(traffic["calls"], key=lambda c: (c[0] + c[1], c))
    return p, n


def prompts(seed: int, call: int, batch: int, length: int,
            vocab: int) -> np.ndarray:
    """Call `call`'s (batch, length) prompt token ids, uniform over the
    vocabulary; the same seed gives the same prompts."""
    rng = np.random.default_rng([seed, call])
    return rng.integers(0, vocab, size=(batch, length), dtype=np.int64)


def sample(seed: int, sizes: list, k: int):
    """`k` (call, row) pairs of the completed calls (`sizes`: each
    call's (batch, new tokens)), drawn from the seed without replacement
    (a stream of its own, past every call's): one row of the call with
    the most new tokens, the rest from all calls."""
    rng = np.random.default_rng([seed, 1 << 20])
    rows = [(c, r) for c, (b, _) in enumerate(sizes) for r in range(b)]
    longest = max(range(len(sizes)), key=lambda c: (sizes[c][1], -c))
    first = (longest, int(rng.integers(sizes[longest][0])))
    rest = [x for x in rows if x != first]
    picks = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return sorted([first] + [rest[int(i)] for i in picks])
