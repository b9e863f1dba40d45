"""Serving loop: batched autoregressive decode with greedy/temperature
sampling, and the DaeMon paged-KV store in the loop.

PyTorch counterpart of ``repro.runtime.serve_loop``. All three loops run
the decode cell token by token (prefill included, as the reference
does):

- `serve_batch`: plain batched decode;
- `serve_batch_paged`: the same decode with the batched two-tier store in
  the loop — per step each of B tenant sequences requests its hot-page
  window; tenants, each with its own local pool, page table and engine,
  share one fabric. The decode computes from its dense cache; the store
  is the movement plane of the disaggregated KV tier, and its ledger is
  the cost report. A `runtime.fault.LinkHealthMonitor` can watch the
  link's sampled module health (`link_reshard_modules` in the ledger);
- `serve_replicated`: C serving replicas x B tenants each against one
  memory-side fabric, every replica's transfers also serialized on its
  own NIC (`step_fetch_replicated`, two-leg pricing) — the serving form
  of the paper's multiple-compute-components axis (fig 22).

A `runtime.obs.SpanRecorder` (passed in, or made when the store's
telemetry level is "trace") captures prefill and decode spans; they come
back in the ledger as `trace_spans`, and the store's telemetry state as
`_tel`. Each loop also opens the layer spans of ``core.telemetry.span``
(off unless a recorder is active or a profiler runs): `serve.call`
around the call and `serve.step` around each token step.
`serve_replicated(mesh=)` places the replicas on the ranks of a
process-group mesh (`runtime.mesh_plane`). Everything runs on the card
unless the caller passes device="cpu".
"""
from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import residency, telemetry
from repro_torch.core.daemon_store import (KVStoreConfig,
                                           init_kv_store_batch,
                                           init_kv_store_replicated,
                                           ledger as store_ledger,
                                           step_fetch_batch,
                                           step_fetch_replicated)
from repro_torch.device import resolve_device
from repro_torch.models.model import (ModelOptions, decode_step,
                                      init_decode_state)
from repro_torch.runtime.obs import SpanRecorder


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


def _maybe_recorder(recorder, store_cfg):
    """The caller's recorder, or a new one when the store's telemetry
    level is "trace". Span ends synchronize the device, so trace-level
    runs serialize the launch queue at every span."""
    if recorder is None and store_cfg is not None \
            and store_cfg.telemetry.trace_on:
        recorder = SpanRecorder()
    return recorder


def _span(rec, name, **args):
    """`rec.span(...)` or a no-op context yielding a writable dict."""
    return nullcontext({}) if rec is None else rec.span(name, **args)


def _call_span(entry: str, batch: int, prompt: int, scfg: ServeConfig):
    """The `serve.call` layer span of one call of a serve loop."""
    return telemetry.span(telemetry.CALL_SPAN, entry=entry, batch=batch,
                          prompt=prompt, new_tokens=scfg.max_new_tokens)


def _step_span(phase: str, step: int, tokens: int):
    """The `serve.step` layer span of one token step (`tokens` rows)."""
    return telemetry.span("serve.step", phase=phase, step=step,
                          tokens=tokens)


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


def serve_batch(params, cfg: ArchConfig, prompts, scfg: ServeConfig,
                opt: ModelOptions = None, recorder=None, device=None):
    """prompts: (B, P) int. Returns (B, P + max_new_tokens) int32 tokens.

    The prompt runs token by token through the same decode cell (exact,
    and the reference's order); `models.model.prefill` is the one-pass
    alternative. `recorder` (optional `runtime.obs.SpanRecorder`)
    captures prefill and decode spans."""
    device = resolve_device(device)
    opt = opt or ModelOptions(remat="none")
    prompts = torch.as_tensor(prompts, device=device).to(torch.int32)
    b, p = prompts.shape
    with _call_span("serve_batch", b, p, scfg):
        state = init_decode_state(cfg, b, p + scfg.max_new_tokens, opt,
                                  device=device)
        step = make_decode_fn(cfg, opt)
        gen = torch.Generator(device=device).manual_seed(scfg.seed)
        # zero-length prompts skip prefill and decode from a BOS-like token 0
        nxt = torch.zeros((b, 1), dtype=torch.int32, device=device)
        with _span(recorder, "prefill", tokens=p) as sp:
            for i in range(p):
                with _step_span("prefill", i, b):
                    nxt, state = step(params, state, prompts[:, i:i + 1], i,
                                      gen, scfg.temperature)
            sp["sync"] = nxt
        tok = nxt
        out = [prompts]
        with _span(recorder, "decode", tokens=scfg.max_new_tokens) as sp:
            for i in range(scfg.max_new_tokens):
                with _step_span("decode", i, b):
                    out.append(tok)
                    tok, state = step(params, state, tok, p + i, gen,
                                      scfg.temperature)
            sp["sync"] = tok
        return torch.cat(out, dim=1)


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
    time-varying; `health_monitor` (optional
    `runtime.fault.LinkHealthMonitor`) then watches the module health
    sampled after every step, and the ledger gains
    `link_reshard_modules`, the modules it advised resharding. The
    schedule is copied to the host once and sampled there, so watching
    adds no device round trip to the loop. `recorder` as in
    `serve_batch` (prefill, decode and per-step spans).

    Returns (tokens (B, P + max_new_tokens), ledger dict)."""
    device = resolve_device(device)
    opt = opt or ModelOptions(remat="none")
    recorder = _maybe_recorder(recorder, store_cfg)
    prompts = torch.as_tensor(prompts, device=device).to(torch.int32)
    b, p = prompts.shape
    with _call_span("serve_batch_paged", b, p, scfg):
        state = init_decode_state(cfg, b, p + scfg.max_new_tokens, opt,
                                  device=device)
        step = make_decode_fn(cfg, opt)
        gen = torch.Generator(device=device).manual_seed(scfg.seed)

        kv = init_kv_store_batch(store_cfg, b, link=link, device=device)
        watch_health, reshard_advised = _health_watch(health_monitor, link)
        remote_k, remote_v = _remote_pool(store_cfg, b * pcfg.pages_per_seq,
                                          device)
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

        # zero-length prompts skip prefill and decode from a BOS-like token 0
        nxt = torch.zeros((b, 1), dtype=torch.int32, device=device)
        with _span(recorder, "prefill", tokens=p) as sp:
            for i in range(p):
                with _step_span("prefill", i, b):
                    nxt, state = step(params, state, prompts[:, i:i + 1], i,
                                      gen, scfg.temperature)
                    kv = kv_step(kv, i)
                    watch_health(i + 1)
            sp["sync"] = (nxt, kv.fab.page_busy)
        tok = nxt
        out = [prompts]
        with _span(recorder, "decode", tokens=scfg.max_new_tokens) as sp:
            for i in range(scfg.max_new_tokens):
                with _step_span("decode", i, b):
                    out.append(tok)
                    with _span(recorder, "decode_step", tid=1,
                               step=i) as s2:
                        tok, state = step(params, state, tok, p + i, gen,
                                          scfg.temperature)
                        kv = kv_step(kv, p + i)
                        s2["sync"] = (tok, kv.fab.page_busy)
                    watch_health(p + i + 1)
            sp["sync"] = tok
        led = store_ledger(kv)
        if health_monitor is not None:
            led["link_reshard_modules"] = sorted(reshard_advised)
        return torch.cat(out, dim=1), _finish_ledger(led, kv, recorder)


def _health_watch(health_monitor, link):
    """(watch(clock_step), advised set): `watch` feeds the monitor the
    module health of the host copy of `link`'s schedule at a decode
    step; a no-op without a monitor or a link."""
    advised = set()
    if health_monitor is None or link is None:
        return (lambda clock_step: None), advised
    sched_t = link.sched_t.detach().cpu().numpy()
    sched_health = link.health.detach().cpu().numpy()

    def watch(clock_step: int):
        seg = np.clip(np.searchsorted(sched_t, clock_step, side="right")
                      - 1, 0, len(sched_t) - 1)
        advised.update(health_monitor.observe(sched_health[seg]))
    return watch, advised


def _remote_pool(store_cfg: KVStoreConfig, pages: int, device):
    """Zeroed remote-tier K and V pools of `pages` pages."""
    shape = (pages, store_cfg.page_tokens, store_cfg.kv_heads,
             store_cfg.head_dim)
    return (torch.zeros(shape, dtype=torch.bfloat16, device=device),
            torch.zeros(shape, dtype=torch.bfloat16, device=device))


def _finish_ledger(led: dict, kv, recorder) -> dict:
    """Add the spans (`trace_spans`) and the raw telemetry state (`_tel`,
    tensors, not JSON: writers pop it first) to a loop's ledger."""
    if recorder is not None:
        led["trace_spans"] = recorder.events
    if kv.seqs.tel is not None:
        led["_tel"] = kv.seqs.tel
    return led


def serve_replicated(params, cfg: ArchConfig, prompts, scfg: ServeConfig,
                     store_cfg: KVStoreConfig, num_replicas: int,
                     pcfg: PagedServeConfig = PagedServeConfig(),
                     opt: ModelOptions = None, link=None, recorder=None,
                     mesh=None, device=None):
    """Replicated serving: C serving replicas x B tenants each, one
    shared memory-side fabric.

    Each replica decodes its own copy of the B prompts; the C*B
    sequences decode as one batch, and per step `step_fetch_replicated`
    drives the store: every replica's page migrations queue on the same
    per-module memory channels and also serialize on the replica's own
    NIC bank. Each of the C*B tenants owns a distinct region of one
    shared remote KV pool.

    `mesh` (optional 1-axis ``("data",)`` mesh of a process group, see
    `runtime.mesh_plane`) places the replica axis on the ranks: rank r
    decodes only its C/W replicas' sequences and steps the store through
    `mesh_plane.step_replicated_sharded` (its replicas' state and NICs
    local, the shared module bank merged across the ranks every step);
    at the end the tokens and the store state (less the pools, which
    the ledger does not read) are gathered, and every rank returns the
    same (tokens, ledger). C must divide evenly by the
    world size. A world-1 mesh gives the tokens and ledger of
    ``mesh=None`` bit for bit. Every replica decodes the same prompts,
    so under greedy decoding a row's tokens do not depend on the batch
    it decodes in; at temperature > 0 a rank's generator draws for its
    rows only, so sampled tokens differ from ``mesh=None``'s.

    Returns (tokens (C, B, P + max_new_tokens), ledger dict, including
    per-module `module_bytes` and per-replica `unit_bytes`)."""
    device = resolve_device(device)
    opt = opt or ModelOptions(remat="none")
    recorder = _maybe_recorder(recorder, store_cfg)
    c = num_replicas
    prompts = torch.as_tensor(prompts, device=device).to(torch.int32)
    b, p = prompts.shape
    with _call_span("serve_replicated", c * b, p, scfg):
        kv = init_kv_store_replicated(store_cfg, c, b, link=link,
                                      device=device)
        c_local = c
        if mesh is not None:
            from repro_torch.runtime import mesh_plane
            kv = mesh_plane.shard_replicated_state(kv, mesh)
            c_local = kv.num_replicas
        flat_prompts = prompts.repeat(c_local, 1)              # (C/W*B, P)
        state = init_decode_state(cfg, c_local * b, p + scfg.max_new_tokens,
                                  opt, device=device)
        step = make_decode_fn(cfg, opt)
        gen = torch.Generator(device=device).manual_seed(scfg.seed)

        remote_k, remote_v = _remote_pool(
            store_cfg, c * b * pcfg.pages_per_seq, device)
        seq_ids = torch.arange(c * b, dtype=torch.int32, device=device)
        pol = residency.as_policy(store_cfg.policy, device=device)
        shape = (c, b, pcfg.window_pages)

        def kv_step(kv_state, pos: int):
            need, offs, writes = paged_request_window(
                torch.full((c * b,), pos, dtype=torch.int32, device=device),
                seq_ids, store_cfg.page_tokens, pcfg.window_pages,
                pcfg.pages_per_seq)
            req = (need.reshape(shape), offs.reshape(shape),
                   writes.reshape(shape))
            if mesh is None:
                kv_state, _, _, _ = step_fetch_replicated(
                    kv_state, store_cfg, remote_k, remote_v, *req, policy=pol)
            else:
                kv_state, _, _, _ = mesh_plane.step_replicated_sharded(
                    kv_state, store_cfg, mesh, remote_k, remote_v, *req,
                    policy=pol)
            return kv_state

        # zero-length prompts skip prefill and decode from a BOS-like token 0
        nxt = torch.zeros((c_local * b, 1), dtype=torch.int32, device=device)
        with _span(recorder, "prefill", tokens=p) as sp:
            for i in range(p):
                with _step_span("prefill", i, c_local * b):
                    nxt, state = step(params, state,
                                      flat_prompts[:, i:i + 1], i, gen,
                                      scfg.temperature)
                    kv = kv_step(kv, i)
            sp["sync"] = (nxt, kv.fab.page_busy)
        tok = nxt
        out = [flat_prompts]
        with _span(recorder, "decode", tokens=scfg.max_new_tokens) as sp:
            for i in range(scfg.max_new_tokens):
                with _step_span("decode", i, c_local * b):
                    out.append(tok)
                    tok, state = step(params, state, tok, p + i, gen,
                                      scfg.temperature)
                    kv = kv_step(kv, p + i)
            sp["sync"] = (tok, kv.fab.page_busy)
        tokens = torch.cat(out, dim=1)
        if mesh is not None:
            tokens = mesh_plane.gather_rows(tokens, mesh)
            # the ledger reads the counters, telemetry and banks, not the
            # pools: gather the state with empty pools
            seqs = kv.seqs._replace(kpool=kv.seqs.kpool[:, :0],
                                    vpool=kv.seqs.vpool[:, :0])
            kv = mesh_plane.gather_replicated_state(kv._replace(seqs=seqs),
                                                    mesh)
        return (tokens.reshape((c, b, -1)),
                _finish_ledger(store_ledger(kv), kv, recorder))
