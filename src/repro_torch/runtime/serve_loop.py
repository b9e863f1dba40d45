"""Serving loop: batched autoregressive decode with the DaeMon paged-KV
store in the loop.

PyTorch counterpart of ``repro.runtime.serve_loop``.
`serve_batch_paged` runs the decode cell token by token (prefill
included, as the reference does) and per step drives the batched
two-tier store with each sequence's hot-page window: B tenants, each
with its own local pool, page table and engine, share one fabric. The
decode computes from its dense cache; the store is the movement plane of
the disaggregated KV tier, and its ledger is the cost report.

Everything runs on the card unless the caller passes device="cpu".
`serve_batch`, `serve_replicated`, and the health-monitor and span
recorder hooks are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import residency
from repro_torch.core.daemon_store import (KVStoreConfig,
                                           init_kv_store_batch,
                                           ledger as store_ledger,
                                           step_fetch_batch)
from repro_torch.device import resolve_device
from repro_torch.models.model import (ModelOptions, decode_step,
                                      init_decode_state)


@dataclass(frozen=True)
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0          # 0 => greedy
    seed: int = 0


@dataclass(frozen=True)
class PagedServeConfig:
    """Paged-KV movement accounting knobs for `serve_batch_paged`."""
    window_pages: int = 4     # hot KV pages requested per sequence per step
    pages_per_seq: int = 32   # remote-tier pages reserved per tenant


def make_decode_fn(cfg: ArchConfig, opt: ModelOptions):
    """step(params, state, tokens, pos, gen, temperature) -> (next (B,1)
    int32, state): greedy argmax over the logical vocab, or a sample at
    `temperature` drawn from the torch.Generator `gen`."""
    def step(params, state, tokens, pos: int, gen, temperature: float):
        logits, state = decode_step(params, cfg, state, tokens, pos, opt)
        logits = logits[:, : cfg.vocab_size]
        if temperature > 0:
            probs = torch.softmax(logits / max(temperature, 1e-4), dim=-1)
            nxt = torch.multinomial(probs, 1, generator=gen)
        else:
            nxt = logits.argmax(dim=-1, keepdim=True)
        return nxt.to(torch.int32), state
    return step


def paged_request_window(positions, seq_ids, page_tokens: int,
                         window: int, pages_per_seq: int):
    """Per-sequence hot-page window at the given decode positions.

    Returns (pages (B, W) int32, offsets (B, W) int32, writes (B, W)
    bool): the W most recently written KV pages of each sequence in the
    tenant's region of the shared remote pool (`seq * pages_per_seq +
    logical`), with the request's token offset within its page. The
    newest page (j == 0) is the one the current position appends KV to:
    its `writes` flag is set."""
    positions = positions.to(torch.int32)
    seq_ids = seq_ids.to(torch.int32)
    cur = torch.clamp(torch.div(positions, page_tokens,
                                rounding_mode="floor"),
                      max=pages_per_seq - 1)
    j = torch.arange(window, dtype=torch.int32, device=positions.device)
    logical = torch.clamp(cur[:, None] - j[None, :], min=0)
    pages = seq_ids[:, None] * pages_per_seq + logical
    offs = torch.where(j[None, :] == 0,
                       (positions % page_tokens)[:, None],
                       page_tokens - 1)
    writes = (j[None, :] == 0).expand(pages.shape)
    return pages.to(torch.int32), offs.to(torch.int32), writes


def serve_batch_paged(params, cfg: ArchConfig, prompts, scfg: ServeConfig,
                      store_cfg: KVStoreConfig,
                      pcfg: PagedServeConfig = PagedServeConfig(),
                      opt: ModelOptions = None, link=None,
                      health_monitor=None, recorder=None, device=None):
    """Batched decode with the DaeMon movement plane in the loop.

    prompts: (B, P) int. `link` (optional `fabric.LinkModel`, knot times
    in decode steps) makes the fabric's bandwidth and health
    time-varying. Returns (tokens (B, P + max_new_tokens), ledger dict).
    """
    if health_monitor is not None or recorder is not None:
        raise NotImplementedError("health_monitor and recorder need "
                                  "runtime/fault.py and runtime/obs.py, "
                                  "which are not ported yet")
    device = resolve_device(device)
    opt = opt or ModelOptions()
    prompts = torch.as_tensor(prompts, device=device).to(torch.int32)
    b, p = prompts.shape
    max_len = p + scfg.max_new_tokens
    state = init_decode_state(cfg, b, max_len, opt, device=device)
    step = make_decode_fn(cfg, opt)
    gen = torch.Generator(device=device).manual_seed(scfg.seed)

    kv = init_kv_store_batch(store_cfg, b, link=link, device=device)
    n_remote = b * pcfg.pages_per_seq
    rshape = (n_remote, store_cfg.page_tokens, store_cfg.kv_heads,
              store_cfg.head_dim)
    remote_k = torch.zeros(rshape, dtype=torch.bfloat16, device=device)
    remote_v = torch.zeros(rshape, dtype=torch.bfloat16, device=device)
    seq_ids = torch.arange(b, dtype=torch.int32, device=device)
    pol = residency.as_policy(store_cfg.policy, device=device)

    def kv_step(kv_state, pos: int):
        need, offs, writes = paged_request_window(
            torch.full((b,), pos, dtype=torch.int32, device=device),
            seq_ids, store_cfg.page_tokens, pcfg.window_pages,
            pcfg.pages_per_seq)
        kv_state, _, _, _ = step_fetch_batch(kv_state, store_cfg, remote_k,
                                             remote_v, need, offs, writes,
                                             policy=pol)
        return kv_state

    out = [prompts]
    # zero-length prompts skip prefill and decode from a BOS-like token 0
    nxt = torch.zeros((b, 1), dtype=torch.int32, device=device)
    for i in range(p):
        nxt, state = step(params, state, prompts[:, i:i + 1], i, gen,
                          scfg.temperature)
        kv = kv_step(kv, i)
    tok = nxt
    gen_toks = []
    for i in range(scfg.max_new_tokens):
        gen_toks.append(tok)
        tok, state = step(params, state, tok, p + i, gen, scfg.temperature)
        kv = kv_step(kv, p + i)
    return torch.cat(out + gen_toks, dim=1), store_ledger(kv)
