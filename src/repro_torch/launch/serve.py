"""Serving launcher of the port: batched decode with a (reduced) model.

  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \
      --reduced --device cpu          # or whisper-base, internvl2-26b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --batch 8 --prompt-len 32 --new-tokens 32

Mirrors ``repro.launch.serve``, with the same flags plus ``--device``;
``--arch`` takes any of the ten registered archs (the frontend stubs'
archs serve text only, as the reference's launcher does):
random parameters from a seed (bf16 storage at full width, f32 with
``--reduced``), prompts from a seeded ``torch.Generator``, then
`serve_batch`. It runs on the card unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.models.model import init_model
from repro_torch.runtime.serve_loop import ServeConfig, serve_batch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dtype = torch.float32 if args.reduced else torch.bfloat16
    params = init_model(cfg, torch.Generator(device=device).manual_seed(
        args.seed), dtype=dtype)
    prompts = torch.randint(
        2, min(1000, cfg.vocab_size), (args.batch, args.prompt_len),
        generator=torch.Generator(device=device).manual_seed(args.seed + 1),
        device=device, dtype=torch.int32)
    t0 = time.perf_counter()
    out = serve_batch(params, cfg, prompts,
                      ServeConfig(max_new_tokens=args.new_tokens,
                                  temperature=args.temperature,
                                  seed=args.seed), device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total_new = args.batch * args.new_tokens
    print(f"[serve] {cfg.name} on {device}: {total_new} tokens in "
          f"{dt:.2f}s ({total_new / dt:.1f} tok/s)")
    for row in out[:2]:
        print("  ", row.tolist())
    return out


if __name__ == "__main__":
    main()
