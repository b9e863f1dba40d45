"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from src/repro_torch/csrc (nvcc, sm_90a,
into build/repro_torch/), holds each kernel bit for bit against its plain
PyTorch version, drives a 48-step store run through both, serves
full-width qwen3-1.7b through `serve_batch_paged` with the DaeMon KV
store in the loop, and checks the result. It imports nothing of JAX or of
the reference package.

Output: one line per phase; then the card's name and power limit as
nvidia-smi prints them; then one JSON line with each kernel's launches on
the serving run, its time against its bound, the plain version's time
and the library call's; and last `{"ok": true, "device": {...}}`. Any
failure raises and exits non-zero before those lines. Without a CUDA
device, or without the repository around it, it exits non-zero at once.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if not (ROOT / "src" / "repro_torch").is_dir():
    sys.exit("chip_smoke.py: src/repro_torch not found beside this script")
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import daemon_store as DS  # noqa: E402
from repro_torch.core import residency  # noqa: E402
from repro_torch.core.engine import poll_arrivals  # noqa: E402
from repro_torch.core.fabric import FabricConfig  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import paged_gather as PG  # noqa: E402
from repro_torch.kernels import ref as REF  # noqa: E402
from repro_torch.kernels import residency_fused as RF  # noqa: E402
from repro_torch.models.model import (ModelOptions, decode_step,  # noqa
                                      init_decode_state, init_model)
from repro_torch.runtime.serve_loop import (  # noqa: E402
    PagedServeConfig, ServeConfig, make_decode_fn, paged_request_window,
    serve_batch_paged)

DEV = torch.device("cuda")
HBM_BYTES_PER_MS = 3.35e12 / 1e3      # H100 SXM device memory, bytes/ms
POLICIES = ("lru", "fifo", "rrip", "dirty-averse")
OUT_NAMES = ("page", "age", "ready", "dirty", "rrpv", "kpool", "vpool",
             "evicted", "n_ev", "k_local", "v_local", "hit")


def phase(title, **kv):
    print(f"[{title}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def call_ms(fn, iters=100, warmup=5):
    """Mean time per call as a Python caller issues them back to back:
    CUDA events around `iters` eager calls (host overhead included)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, replays=10):
    """Mean device time of fn() in ms: `iters` calls captured in one CUDA
    graph, replayed `replays` times between CUDA events, so the host's
    per-call overhead drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def max_abs_err(a_list, b_list):
    err = 0.0
    for a, b in zip(a_list, b_list):
        d = (a.double() - b.double()).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def flat_out(out):
    return list(out[0]) + list(out[1:])


# ------------------------------------------------------------- phase 1-2
def device_phase():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    phase("device", name=repr(name), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, smi


def build_phase():
    secs = _build.build_all([PG.KERNEL, RF.KERNEL])
    phase("build", seconds=f"{secs:.2f}", dir=_build.BUILD_DIR)
    for k in (PG.KERNEL, RF.KERNEL):
        for line in k.build_log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  {k.source}: {line.strip()}")


# ---------------------------------------------------------------- phase 3
def gather_phase(gen):
    """K2 at the serving shape: remote pool (8*64, 16, 8, 128) bf16,
    L = 32 rows, masked and unmasked."""
    pool = torch.randn((8 * 64, 16, 8, 128), generator=gen, device=DEV
                       ).to(torch.bfloat16)
    idx = torch.randint(0, pool.shape[0], (32,), generator=gen, device=DEV,
                        dtype=torch.int32)
    mask = torch.rand((32,), generator=gen, device=DEV) < 0.5
    errs = []
    for m in (None, mask):
        got = PG.paged_gather(pool, idx, m)
        want = REF.paged_gather(pool, idx, m)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"paged_gather != plain (mask={m is not None})")
        errs.append(max_abs_err([got], [want]))
    row = pool[0].numel() * pool.element_size()
    nbytes = 2 * idx.shape[0] * row + idx.numel() * 4
    idx64 = idx.long()
    rec = {
        "name": "paged_gather", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_gather.cu",
        "replaces": "src/repro/kernels/paged_gather.py:30",
        "max_abs_err": max(errs),
        "ms": device_ms(lambda: PG.paged_gather(pool, idx)),
        "plain_ms": device_ms(lambda: REF.paged_gather(pool, idx)),
        "library_ms": device_ms(lambda: torch.index_select(pool, 0, idx64)),
        "bound_ms": nbytes / HBM_BYTES_PER_MS, "bound_by": "bytes",
    }
    phase("paged_gather", exact=True, rows=32, row_bytes=row,
          ms=rec["ms"], plain_ms=rec["plain_ms"],
          library_ms=rec["library_ms"], bound_ms=rec["bound_ms"],
          call_ms=call_ms(lambda: PG.paged_gather(pool, idx)),
          library_call_ms=call_ms(lambda: torch.index_select(pool, 0,
                                                             idx64)))
    return rec


# ---------------------------------------------------------------- phase 4
def k1_case(gen, b, s, w, p, r, row, dtype=torch.bfloat16):
    """A random store snapshot that keeps the CAM invariants: page % S ==
    set, no page twice in a set, landed pages distinct and not resident,
    some resident pages still in flight, ties in age."""
    n = s * w
    pr = 2 * n
    clock = 60.0

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=DEV)

    k = rand(b, s, 2 * w).argsort(dim=-1)[..., :w]
    page = (torch.arange(s, device=DEV)[None, :, None] + s * k).int()
    occ = rand(b, s, w) < 0.6
    page = torch.where(occ, page, -1)
    age = torch.where(occ, torch.randint(0, 40, (b, s, w), generator=gen,
                                         device=DEV).float(), 0.0)
    ready = torch.where(occ, torch.where(rand(b, s, w) < 0.3, clock + 5.0,
                                         age), 3.0e38)
    dirty = occ & (rand(b, s, w) < 0.4)
    rrpv = torch.where(occ, torch.randint(0, 4, (b, s, w), generator=gen,
                                          device=DEV).float(), 3.0)
    res = residency.ResidencyState(page, age, ready, dirty, rrpv)
    landed = rand(b, p) < 0.5
    lp = (pr + rand(b, pr).argsort(dim=-1)[:, :p]).int()
    lp = torch.where(landed, lp, -1)
    needed = torch.randint(0, pr, (b, r), generator=gen, device=DEV).int()
    needed[:, 0] = torch.clamp(lp.max(dim=1).values, min=0)
    writes = rand(b, r) < 0.5
    kpool = torch.randn((b, n) + row, generator=gen, device=DEV).to(dtype)
    vpool = torch.randn((b, n) + row, generator=gen, device=DEV).to(dtype)
    rk = torch.randn((2 * pr,) + row, generator=gen, device=DEV).to(dtype)
    rv = torch.randn((2 * pr,) + row, generator=gen, device=DEV).to(dtype)
    return (res, kpool, vpool, rk, rv, landed, lp, needed, writes,
            torch.tensor(clock, device=DEV))


def check_k1(args, pol):
    res, kpool, vpool, *rest = args
    ref = REF.fused_residency_step(res, kpool.clone(), vpool.clone(), *rest,
                                   pol)
    got = RF.fused_residency_step(res, kpool, vpool, *rest, pol)
    torch.cuda.synchronize()
    for name, a, b in zip(OUT_NAMES, flat_out(ref), flat_out(got)):
        if not torch.equal(a, b):
            raise AssertionError(f"fused_residency_step != plain on {name}")
    return max_abs_err(flat_out(ref), flat_out(got))


def residency_phase(gen):
    err = 0.0
    for (s, w) in ((1, 4096), (256, 16)):
        for pol_name in POLICIES:
            pol = residency.as_policy(pol_name, device=DEV)
            err = max(err, check_k1(k1_case(gen, 64, s, w, 16, 4, (4, 1, 8)),
                                    pol))
        phase("fused_residency_step", geometry=f"{s}x{w}", batch=64,
              inflight=16, requests=4, row="(4,1,8)", exact=True)
    for (s, w) in ((1, 4096), (256, 16)):
        pol = residency.as_policy("lru", device=DEV)
        err = max(err, check_k1(k1_case(gen, 8, s, w, 256, 4, (16, 8, 128)),
                                pol))
        phase("fused_residency_step", geometry=f"{s}x{w}", batch=8,
              inflight=256, requests=4, row="(16,8,128)", exact=True)
    return err


def leaves(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = ((f, getattr(tree, f)) for f in tree._fields)
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(leaves(v, f"{prefix}.{k}"))
    return out


def drive_phase():
    """48 zipf steps of step_fetch_batch, kernels against plain versions
    on identical inputs: every output and every state leaf equal."""
    common = dict(num_local_pages=16, pool_ways=4, page_tokens=4,
                  kv_heads=2, head_dim=16, page_budget_per_step=32,
                  fabric=FabricConfig(num_modules=4))
    cfg_k = DS.KVStoreConfig(kernel_impl="auto", **common)
    cfg_r = DS.KVStoreConfig(kernel_impl="ref", **common)
    b, r, pages = 8, 4, 256
    rng = np.random.default_rng(0)
    remote = torch.from_numpy(rng.standard_normal((pages, 4, 2, 16)).astype(
        np.float32)).to(DEV).to(torch.bfloat16)
    st_k = DS.init_kv_store_batch(cfg_k, b, device=DEV)
    st_r = DS.init_kv_store_batch(cfg_r, b, device=DEV)
    pol = residency.as_policy("lru", device=DEV)
    for step in range(48):
        need = torch.from_numpy(((rng.zipf(1.3, (b, r)) - 1) % pages
                                 ).astype(np.int32)).to(DEV)
        offs = torch.from_numpy(rng.integers(0, 4, (b, r)).astype(
            np.int32)).to(DEV)
        wr = torch.from_numpy(rng.random((b, r)) < 0.4).to(DEV)
        st_k, *out_k = DS.step_fetch_batch(st_k, cfg_k, remote, remote,
                                           need, offs, wr, policy=pol)
        st_r, *out_r = DS.step_fetch_batch(st_r, cfg_r, remote, remote,
                                           need, offs, wr, policy=pol)
        for a, c in zip(out_k, out_r):
            if not torch.equal(a, c):
                raise AssertionError(f"step {step}: served data differs")
        lk, lr = leaves(st_k), leaves(st_r)
        for key in lr:
            if not torch.equal(lk[key], lr[key]):
                raise AssertionError(f"step {step}: state {key} differs")
    led = DS.ledger(st_k)
    if not (led["evictions"] > 0 and led["dirty_evicts"] > 0
            and led["page_moves"] > 0):
        raise AssertionError(f"drive did not land/evict/write back: {led}")
    phase("store_drive", steps=48, batch=b, identical=True,
          page_moves=led["page_moves"], evictions=led["evictions"],
          dirty_evicts=led["dirty_evicts"],
          hit_rate=f"{led['local_hits'] / led['requests']:.3f}")


# ---------------------------------------------------------------- phase 5
SERVE_STORE = dict(num_local_pages=4096, pool_ways=16, page_tokens=16,
                   kv_heads=8, head_dim=128)
SERVE_PAGED = PagedServeConfig(window_pages=4, pages_per_seq=64)
SERVE_B, SERVE_PROMPT, SERVE_NEW = 8, 32, 32


def reference_phase():
    """The card against the CPU on reduced qwen3-1.7b (f32): the store's
    ledger through the kernels equals the plain versions' on the CPU, and
    the decode's logits agree."""
    cfg = get_config("qwen3-1.7b").reduced()
    params_cpu = init_model(cfg, torch.Generator().manual_seed(0))
    params = _to(params_cpu, DEV)
    prompts = torch.randint(2, 200, (2, 6),
                            generator=torch.Generator().manual_seed(1))
    store = DS.KVStoreConfig(num_local_pages=4, page_tokens=2, kv_heads=2,
                             head_dim=16, page_budget_per_step=2)
    pcfg = PagedServeConfig(window_pages=2, pages_per_seq=8)
    tok_c, led_c = serve_batch_paged(params_cpu, cfg, prompts,
                                     ServeConfig(max_new_tokens=10), store,
                                     pcfg, device="cpu")
    tok_g, led_g = serve_batch_paged(params, cfg, prompts.to(DEV),
                                     ServeConfig(max_new_tokens=10), store,
                                     pcfg)
    for k, v in led_c.items():
        np.testing.assert_allclose(led_g[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    opt = ModelOptions()
    st_c = init_decode_state(cfg, 2, 8, opt, device="cpu")
    st_g = init_decode_state(cfg, 2, 8, opt, device=DEV)
    worst = 0.0
    for pos in range(8):
        tok = tok_c[:, pos:pos + 1]
        lc, st_c = decode_step(params_cpu, cfg, st_c, tok, pos, opt)
        lg, st_g = decode_step(params, cfg, st_g, tok.to(DEV), pos, opt)
        np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), rtol=1e-3,
                                   atol=1e-3)
        worst = max(worst, float((lg.cpu() - lc).abs().max()))
    same = float((tok_g.cpu() == tok_c).float().mean())
    phase("reference", model="qwen3-1.7b-reduced f32", ledger_equal=True,
          logits_max_abs_diff=f"{worst:.2e}", tokens_equal_frac=same)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, dev) for v in tree)
    return tree.to(dev)


def serve_phase():
    """Full-width qwen3-1.7b through serve_batch_paged: the main path.
    Returns (params, cfg, prompts, launch counts)."""
    cfg = get_config("qwen3-1.7b")
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = init_model(cfg, gen, dtype=torch.bfloat16)
    n_params = sum(t.numel() for t in leaves(params).values())
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT),
                            generator=gen, device=DEV, dtype=torch.int32)
    store = DS.KVStoreConfig(**SERVE_STORE)
    scfg = ServeConfig(max_new_tokens=SERVE_NEW)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    PG.KERNEL.launches = 0
    RF.KERNEL.launches = 0
    t0 = time.perf_counter()
    tokens, led = serve_batch_paged(params, cfg, prompts, scfg, store,
                                    SERVE_PAGED)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {"paged_gather": PG.KERNEL.launches,
              "fused_residency_step": RF.KERNEL.launches}
    peak = torch.cuda.max_memory_allocated()
    steps = SERVE_PROMPT + SERVE_NEW
    r = SERVE_PAGED.window_pages
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {counts}")
    if led["requests"] != SERVE_B * r * steps:
        raise AssertionError(f"requests {led['requests']} != B*R*steps")
    if abs(sum(led["module_bytes"]) - led["wire_bytes"]) > \
            1e-5 * max(led["wire_bytes"], 1.0):
        raise AssertionError("module bytes do not sum to wire bytes")
    if tokens.shape != (SERVE_B, steps) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError("tokens out of range or of the wrong shape")
    phase("serve", model="qwen3-1.7b", params=n_params, batch=SERVE_B,
          prompt=SERVE_PROMPT, new=SERVE_NEW, seconds=f"{secs:.3f}",
          steps_per_s=f"{steps / secs:.2f}",
          tokens_per_s=f"{SERVE_B * SERVE_NEW / secs:.2f}",
          peak_gib=f"{peak / 2**30:.2f}", launches=counts)
    phase("ledger", **{k: (v if isinstance(v, list) else f"{v:.6g}")
                       for k, v in led.items()})
    return cfg, params, prompts, counts


def split_phase(cfg, params, prompts):
    """ms per decode step split into model decode and the store's parts
    (host clock, each part ended by a synchronize), over the same decode
    schedule as serve_batch_paged; returns the residency kernel's inputs
    at the last step, for timing it at the main path's shapes."""
    opt = ModelOptions()
    store = DS.KVStoreConfig(**SERVE_STORE)
    b, p = prompts.shape
    state = init_decode_state(cfg, b, p + SERVE_NEW, opt, device=DEV)
    step = make_decode_fn(cfg, opt)
    gen = torch.Generator(device=DEV).manual_seed(0)
    kv = DS.init_kv_store_batch(store, b, device=DEV)
    rshape = (b * SERVE_PAGED.pages_per_seq, store.page_tokens,
              store.kv_heads, store.head_dim)
    remote = torch.zeros(rshape, dtype=torch.bfloat16, device=DEV)
    seq_ids = torch.arange(b, dtype=torch.int32, device=DEV)
    pol = residency.as_policy(store.policy, device=DEV)
    parts = {"model": [], "transact": [], "remote_fetch": [],
             "schedule": []}
    tok = prompts[:, :1]
    k1_inputs = None
    for i in range(p + SERVE_NEW):
        timed = i >= p
        if i < p:
            tok = prompts[:, i:i + 1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nxt, state = step(params, state, tok, i, gen, 0.0)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        need, offs, writes = paged_request_window(
            torch.full((b,), i, dtype=torch.int32, device=DEV), seq_ids,
            store.page_tokens, SERVE_PAGED.window_pages,
            SERVE_PAGED.pages_per_seq)
        clock = kv.clock + 1.0
        if i == p + SERVE_NEW - 1:
            landed, lpages = poll_arrivals(kv.seqs.eng, clock)
            k1_inputs = (kv.seqs.res, kv.seqs.kpool, kv.seqs.vpool, remote,
                         remote, landed, lpages, need, writes, clock, pol)
            k1_inputs = tuple(x.clone() if isinstance(x, torch.Tensor)
                              else x for x in k1_inputs)
        seqs, evicted, k_local, v_local, hit = DS._transact(
            kv.seqs, store, remote, remote, clock, pol, need, writes)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        DS._remote_fetch(remote, remote, need.reshape(-1),
                         ~hit.reshape(-1), store.kernel_impl)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        page_wire = DS._wire_bytes(store, store.page_tokens,
                                   store.compress_pages)
        eng, fab, n_wb = DS._writebacks(seqs.eng, kv.fab, store, evicted,
                                        clock, page_wire)
        eng, fab, ls, ps, stalls = DS._schedule(eng, fab, store, need, offs,
                                                hit, clock)
        stats = DS._stats_fold(seqs.stats, store, ls, ps, stalls, hit, n_wb)
        kv = DS.BatchedKVStoreState(seqs._replace(eng=eng, stats=stats),
                                    fab, clock)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        if timed:
            parts["model"].append(t1 - t0)
            parts["transact"].append(t2 - t1)
            parts["remote_fetch"].append(t3 - t2)
            parts["schedule"].append(t4 - t3)
        tok = nxt
    ms = {k: 1e3 * float(np.mean(v)) for k, v in parts.items()}
    phase("step_split_ms", **{k: f"{v:.3f}" for k, v in ms.items()},
          store_total=f"{ms['transact'] + ms['remote_fetch'] + ms['schedule']:.3f}")
    return k1_inputs, ms


def k1_timing(k1_inputs, err):
    """The residency kernel timed on the serving run's own last-step
    inputs; bound = bytes it must move for this data."""
    res, kpool, vpool, rk, rv, landed, lpages, need, writes, clock, pol = \
        k1_inputs
    b, s, w = res.page.shape
    n = s * w
    k_lanes = min(landed.shape[1], n)
    got = RF.fused_residency_step(*k1_inputs)
    ref = REF.fused_residency_step(res, kpool.clone(), vpool.clone(), rk, rv,
                                   landed, lpages, need, writes, clock, pol)
    for name, a, c in zip(OUT_NAMES, flat_out(ref), flat_out(got)):
        if not torch.equal(a, c):
            raise AssertionError(f"serve-state K1 differs on {name}")
    row = kpool[0, 0].numel() * kpool.element_size()
    # landings this data needs: compacted landed lanes that get a slot
    order = torch.sort((~landed).int(), dim=1, stable=True).indices
    pick = order[:, :k_lanes]
    do = landed.gather(1, pick)
    pids = lpages.gather(1, pick)
    _, _, ok = residency.landing_victims(res, pids, pol)
    n_land = int((do & ok).sum())
    r = need.shape[1]
    meta = b * n * 17 * 2                       # staged in, written back
    small = b * landed.shape[1] * 5 + b * r * 5 + b * k_lanes * 4 + b * 4 \
        + b * r + 16
    rows = 2 * (2 * n_land * row) + 2 * (2 * b * r * row)  # k and v
    nbytes = meta + small + rows
    rec = {
        "name": "fused_residency_step", "route": "cuda",
        "source": "src/repro_torch/csrc/residency_fused.cu",
        "replaces": "src/repro/kernels/residency_fused.py:217",
        "max_abs_err": max(err, max_abs_err(flat_out(ref), flat_out(got))),
        "ms": device_ms(lambda: RF.fused_residency_step(*k1_inputs)),
        "plain_ms": device_ms(lambda: REF.fused_residency_step(*k1_inputs),
                              iters=5),
        "library_ms": None,
        "bound_ms": nbytes / HBM_BYTES_PER_MS, "bound_by": "bytes",
    }
    phase("fused_residency_step_serve_shape", batch=b, geometry=f"{s}x{w}",
          inflight=landed.shape[1], requests=r, landings=n_land,
          row_bytes=row, ms=rec["ms"], plain_ms=rec["plain_ms"],
          bound_ms=rec["bound_ms"],
          call_ms=call_ms(lambda: RF.fused_residency_step(*k1_inputs)),
          plain_call_ms=call_ms(
              lambda: REF.fused_residency_step(*k1_inputs), iters=20))
    return rec


def main():
    name, smi = device_phase()
    build_phase()
    gen = torch.Generator(device=DEV).manual_seed(0)
    k2 = gather_phase(gen)
    k1_err = residency_phase(gen)
    drive_phase()
    reference_phase()
    cfg, params, prompts, counts = serve_phase()
    k1_inputs, _ = split_phase(cfg, params, prompts)
    k1 = k1_timing(k1_inputs, k1_err)
    k1["launches"] = counts["fused_residency_step"]
    k2["launches"] = counts["paged_gather"]
    print(smi)
    print(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
