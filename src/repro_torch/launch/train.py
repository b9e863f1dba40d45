"""Training launcher of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \
      --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --batch 4 --seq 1024 --ckpt-dir ckpt --ckpt-every 25

Mirrors ``repro.launch.train``: random f32 parameters from a seed,
synthetic batches (with the frontend stub's embeddings for whisper-base
and internvl2-26b), the train step with the step watchdog and straggler
detector around it. It runs on the card unless given ``--device cpu``.
Remat is "full", or "none" with ``--reduced``, as the reference's
launcher sets it; the train step is the reference's default (no pod
split), and the int8 pod-gradient sync is driven through ``TrainConfig``
(``dp_compress="int8"``, ``num_pods``). Fault tolerance as the
reference's: with ``--ckpt-dir`` it saves every ``--ckpt-every`` steps
and at the end (written on a worker thread; an in-flight save is
finished even when a step fails), and resumes from the latest
checkpoint there.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.configs import get_config, get_shape
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.compute_plane import tree_leaves
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.models.model import ModelOptions, init_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime.fault import StepWatchdog, StragglerDetector
from repro_torch.runtime.train_loop import TrainConfig, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--shape", default="smoke_train")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=0,
                    help="override global batch")
    ap.add_argument("--seq", type=int, default=0, help="override seq len")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = get_shape(args.shape)
    if args.batch or args.seq:
        shape = ShapeConfig(shape.name, args.seq or shape.seq_len,
                            args.batch or shape.global_batch, "train")
    opt = ModelOptions(triangular_flash=True,
                       remat="none" if args.reduced else "full")
    tcfg = TrainConfig(adamw=AdamWConfig(lr=args.lr),
                       warmup_steps=max(1, args.steps // 20),
                       total_steps=args.steps)
    dcfg = DataConfig(seed=args.seed)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_model(cfg, gen)
    opt_state = adamw_init(params)
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] {cfg.name}: {n/1e6:.1f}M params, "
          f"batch={shape.global_batch} seq={shape.seq_len} device={device}")

    start = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(CheckpointConfig(args.ckpt_dir))
        restored, step, _ = mgr.restore({"params": params,
                                         "opt": opt_state})
        if restored is not None:
            params, opt_state = restored["params"], restored["opt"]
            start = step
            print(f"[train] resumed from step {start}")
        del restored

    step_fn = make_train_step(cfg, opt, tcfg)
    watchdog = StepWatchdog(deadline_s=3600.0)
    straggler = StragglerDetector()
    m = None
    try:
        for s in range(start, args.steps):
            t0 = time.time()
            batch = synthetic_batch(cfg, shape, dcfg, s, device)
            params, opt_state, m = step_fn(params, opt_state, batch, s)
            loss = float(m["loss"])           # waits for the step
            dt = time.time() - t0
            watchdog.check(dt, s)
            if straggler.observe(dt):
                print(f"[train] step {s}: straggler detected "
                      f"(median {straggler.median:.2f}s)")
            if s % args.log_every == 0 or s == args.steps - 1:
                print(f"[train] step {s:5d} loss={loss:.4f} "
                      f"lr={float(m['lr']):.2e} "
                      f"gnorm={float(m['grad_norm']):.2f} {dt:.2f}s")
            if mgr and (s + 1) % args.ckpt_every == 0:
                mgr.save(s + 1, {"params": params, "opt": opt_state})
        if mgr:
            mgr.save(args.steps, {"params": params, "opt": opt_state})
    finally:
        if mgr:
            mgr.wait()
    print("[train] done")
    return m


if __name__ == "__main__":
    main()
