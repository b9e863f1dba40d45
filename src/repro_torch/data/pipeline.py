"""Deterministic synthetic data pipeline.

PyTorch counterpart of ``repro.data.pipeline``: the same Zipf unigram
over the vocabulary, the same document structure (BOS, token 1, at a
per-row offset every `doc_len` positions) and the same ``{tokens,
labels, mask}`` layout, plus the stubbed frontends' ``frontend`` input
(f32 N(0, 0.02^2) embeddings: ``vision_stub`` patches (B, F, D),
``audio_stub`` frames (B, T_enc, D)). Each batch is drawn from a
``torch.Generator`` seeded from ``(seed, step)``, so a batch is
reproducible from its step alone (a resumed job re-reads the same
stream) and is generated on the device it is used on. The token draw
runs in torch's deterministic mode: on the card `multinomial` otherwise
sums its distribution with a scan whose float order changes from run
to run, and with it the tokens drawn. The numbers differ
from ``jax.random``'s; tests that compare the two packages feed the
reference's batches through numpy.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Iterator

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import fake_mode, resolve_device


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    doc_len: int = 512
    zipf_alpha: float = 1.1


def _zipf_logits(vocab: int, alpha: float, device=None):
    ranks = torch.arange(1, vocab + 1, dtype=torch.float32, device=device)
    return -alpha * torch.log(ranks)


@contextlib.contextmanager
def _deterministic():
    """torch's deterministic mode for the enclosed ops, restored after."""
    was = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_only)


def _generator(seed: int, step: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) << 32) + int(step))


def synthetic_batch(cfg: ArchConfig, shape: ShapeConfig, dcfg: DataConfig,
                    step: int, device=None):
    """One global batch {tokens (B,S) int32, labels, mask (B,S) f32, and
    for a stubbed frontend `frontend` (B, F or T_enc, D) f32} on `device`
    (the card unless told otherwise)."""
    device = resolve_device(device)
    gen = _generator(dcfg.seed, step, device)
    b, s = shape.global_batch, shape.seq_len
    probs = torch.softmax(_zipf_logits(cfg.vocab_size, dcfg.zipf_alpha,
                                       device), dim=0)
    with _deterministic():
        tokens = torch.multinomial(probs, b * s, replacement=True,
                                   generator=gen).reshape(b, s)
    # document boundaries: BOS (token 1) at deterministic offsets
    offs = torch.randint(0, dcfg.doc_len, (b, 1), generator=gen,
                         device=device)
    pos = torch.arange(s, device=device)[None, :]
    bos = (pos + offs) % dcfg.doc_len == 0
    tokens = torch.where(bos, 1, tokens).to(torch.int32)
    batch = {"tokens": tokens, "labels": tokens,
             "mask": torch.ones((b, s), dtype=torch.float32, device=device)}
    rows = {"vision_stub": cfg.frontend_tokens,
            "audio_stub": cfg.encoder_seq}.get(cfg.frontend)
    if rows is not None:
        batch["frontend"] = torch.randn(
            (b, rows, cfg.d_model), generator=gen, dtype=torch.float32,
            device=device) * 0.02
    return batch


def synthetic_batch_iterator(cfg: ArchConfig, shape: ShapeConfig,
                             dcfg: DataConfig, start_step: int = 0,
                             device=None) -> Iterator[dict]:
    step = start_step
    while True:
        yield synthetic_batch(cfg, shape, dcfg, step, device)
        step += 1


def make_batch_specs(cfg: ArchConfig, shape: ShapeConfig,
                     dtype=torch.float32, device="cpu"):
    """Fake stand-ins (``device.fake_mode``: no memory) + logical axes for
    every model input: tokens, labels (B,S) int32, mask (B,S) f32, and
    the stubs' `frontend` (B, F or T_enc, D) in `dtype`."""
    b, s = shape.global_batch, shape.seq_len
    with fake_mode():
        def empty(shp, dt):
            return torch.empty(shp, dtype=dt, device=device)

        specs = {"tokens": empty((b, s), torch.int32),
                 "labels": empty((b, s), torch.int32),
                 "mask": empty((b, s), torch.float32)}
        rows = {"vision_stub": cfg.frontend_tokens,
                "audio_stub": cfg.encoder_seq}.get(cfg.frontend)
        if rows is not None:
            specs["frontend"] = empty((b, rows, cfg.d_model), dtype)
    axes = {k: ("batch", None) for k in ("tokens", "labels", "mask")}
    if "frontend" in specs:
        axes["frontend"] = ("batch", None, None)
    return specs, axes
