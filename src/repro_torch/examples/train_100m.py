"""End-to-end example: train a dense LM on synthetic data with checkpoints,
resume and straggler tracking.

Defaults are sized for a quick run (a ~25M model, 60 steps); ``--full``
is the ~100M-parameter, 300-step run. ``--ckpt-dir`` names where the
checkpoints go (a fresh temporary directory when left out); run again
with the same directory to resume from its latest checkpoint.

  PYTHONPATH=src python -m repro_torch.examples.train_100m \
      [--full] [--steps N] [--ckpt-dir DIR] [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.compute_plane import tree_leaves
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.models.model import ModelOptions, init_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime.fault import StragglerDetector
from repro_torch.runtime.train_loop import TrainConfig, make_train_step


def make_cfg(full: bool) -> ArchConfig:
    if full:  # ~103M params (12L x 640d + 32k vocab, untied)
        return ArchConfig(name="repro-100m", family="dense", num_layers=12,
                          d_model=640, num_heads=10, num_kv_heads=5,
                          head_dim=64, d_ff=1708, vocab_size=32768,
                          dtype="float32")
    return ArchConfig(name="repro-25m", family="dense", num_layers=8,
                      d_model=320, num_heads=5, num_kv_heads=5,
                      head_dim=64, d_ff=856, vocab_size=16384,
                      dtype="float32")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new temporary "
                         "one)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cpu, or the card when left out")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_100m_ckpt_")
    cfg = make_cfg(args.full)
    steps = args.steps or (300 if args.full else 60)
    shape = ShapeConfig("e2e", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    opt = ModelOptions(remat="none", flash_threshold=10_000)
    tcfg = TrainConfig(adamw=AdamWConfig(lr=6e-4), warmup_steps=20,
                       total_steps=steps)
    params = init_model(cfg, torch.Generator(device=device).manual_seed(0))
    opt_state = adamw_init(params)
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"[e2e] {cfg.name}: {n / 1e6:.1f}M params, {steps} steps, "
          f"{shape.tokens} tok/step, on {device}, checkpoints in {ckpt_dir}")

    mgr = CheckpointManager(CheckpointConfig(ckpt_dir, keep=2))
    restored, start, _ = mgr.restore({"params": params, "opt": opt_state})
    if restored is not None:
        params, opt_state = restored["params"], restored["opt"]
        print(f"[e2e] resumed from step {start}")
    else:
        start = 0

    step_fn = make_train_step(cfg, opt, tcfg)
    det = StragglerDetector()
    dcfg = DataConfig(seed=7)
    first_loss = loss = None
    advised = 0
    for s in range(start, steps):
        t0 = time.time()
        batch = synthetic_batch(cfg, shape, dcfg, s, device=device)
        params, opt_state, m = step_fn(params, opt_state, batch, s)
        loss = float(m["loss"])
        _sync(device)
        advised += int(det.observe(time.time() - t0))
        if first_loss is None:
            first_loss = loss
        if s % 10 == 0 or s == steps - 1:
            print(f"[e2e] step {s:4d} loss={loss:.4f} "
                  f"({time.time() - t0:.2f}s)")
        if (s + 1) % args.ckpt_every == 0:
            mgr.save(s + 1, {"params": params, "opt": opt_state})
    mgr.save(steps, {"params": params, "opt": opt_state})
    mgr.wait()
    if first_loss is not None:
        print(f"[e2e] loss {first_loss:.3f} -> {loss:.3f} "
              f"({'DECREASED' if loss < first_loss else 'FLAT'}), "
              f"straggler advisories {advised}")
    return {"start": start, "first_loss": first_loss, "loss": loss,
            "ckpt_dir": ckpt_dir}


if __name__ == "__main__":
    main()
