"""Quickstart: build a reduced model, train a few steps, decode a few
tokens — the port's public API in a few lines.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, get_shape
from repro_torch.core.compute_plane import tree_leaves
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.models.model import ModelOptions, init_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime.serve_loop import ServeConfig, serve_batch
from repro_torch.runtime.train_loop import TrainConfig, make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu, or the card when left out")
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config("qwen3-1.7b").reduced()     # any of the 10 archs
    opt = ModelOptions(remat="none", flash_threshold=10_000)
    params = init_model(cfg, torch.Generator(device=device).manual_seed(0))
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"model: {cfg.name}, {n / 1e6:.2f}M params, on {device}")

    step = make_train_step(cfg, opt, TrainConfig(adamw=AdamWConfig(lr=3e-3),
                                                 warmup_steps=2))
    opt_state = adamw_init(params)
    losses = []
    for s in range(args.steps):
        batch = synthetic_batch(cfg, get_shape("smoke_train"), DataConfig(),
                                s, device=device)
        params, opt_state, m = step(params, opt_state, batch, s)
        losses.append(float(m["loss"]))
        print(f"step {s}: loss={losses[-1]:.4f}")

    prompts = torch.tensor([[2, 5, 9, 11]], dtype=torch.int32)
    out = serve_batch(params, cfg, prompts, ServeConfig(max_new_tokens=8),
                      device=device)
    print("generated:", out[0].tolist())
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return {"losses": losses, "tokens": out.cpu()}


if __name__ == "__main__":
    main()
