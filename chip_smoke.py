"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from src/repro_torch/csrc (nvcc, sm_90a,
into build/repro_torch/), holds each kernel bit for bit against its plain
PyTorch version, drives the store through every stepper (batched,
replicated at C = 1, 2, 3, single-sequence, and the chain comparator), the
card against the CPU or the fused path, then serves: reduced qwen3-1.7b
card against CPU (paged, replicated, and at telemetry level "trace" with a
link-health monitor), full-width qwen3-1.7b through `serve_batch_paged`
and through `serve_replicated` (2 replicas x 8 tenants) with the DaeMon
KV store in the loop, and one-pass `prefill` against the token-by-token
decode. Then it trains: the card against the CPU on reduced qwen3-1.7b,
and four steps at full width with the int8-compressed pod-gradient sync
on the block-int8 kernels. Last it runs the request-level simulator
(`repro_torch.sim`): the seed golden (pr and dr, 9 schemes x 3 nets, r =
6000) held to tests/golden/seed_movement_golden.json (`[sim_golden]`),
every lattice axis (schemes x link-profile nets x active compute units x
policies, telemetry on) on the card against the CPU with two-endpoint
byte conservation (`[sim_axes]`), and the paper's fig-8 lattice at r =
6000 with its first 200 requests under sync-debug mode "error" and 50
under torch.profiler (`[sim_fig8]`); the simulator reaches no hand
kernel, and each phase checks that none was launched. It checks every
result and imports nothing of JAX or of the reference package.

The store's kernels are also timed at the store benchmark's shapes
(the paged gather at L = 256 rows, with L2 warm and cold; the residency
transaction at B = 64, 256 x 16 slots, 16 in-flight lanes) and the
residency transaction at the replicated serve's last step (16
sequences).

Output: one line per phase; then the card's name and power limit as
nvidia-smi prints them; then one JSON line with each kernel's launches on
its path (serving for the store's kernels, per path in
`launches_by_path`; training for the quantizer; its own phase for BDI,
which no path reaches), its time against its bound, the plain version's
time and the library call's; and last `{"ok": true, "device": {...}}`.
Any failure raises and exits non-zero before those lines. Without a CUDA
device, or without the repository around it, it exits non-zero at once.
"""
from __future__ import annotations

import ctypes
import gc
import json
import math
import subprocess
import sys
import tempfile
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
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import compression  # noqa: E402
from repro_torch.core import daemon_store as DS  # noqa: E402
from repro_torch.core import residency  # noqa: E402
from repro_torch.core.engine import poll_arrivals  # noqa: E402
from repro_torch.core import compute_plane as CP  # noqa: E402
from repro_torch.core import fabric as FAB  # noqa: E402
from repro_torch.core.compute_plane import tree_leaves  # noqa: E402
from repro_torch.core.fabric import FabricConfig, scheduled_link  # noqa
from repro_torch.core.telemetry import (TelemetryConfig,  # noqa: E402
                                        TelemetryState, series_rows)
from repro_torch.data.pipeline import DataConfig, synthetic_batch  # noqa
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import bdi as BDI  # noqa: E402
from repro_torch.kernels import paged_gather as PG  # noqa: E402
from repro_torch.kernels import qdq_int8 as QD  # noqa: E402
from repro_torch.kernels import ref as REF  # noqa: E402
from repro_torch.kernels import residency_fused as RF  # noqa: E402
from repro_torch.models.model import (ModelOptions, decode_step,  # noqa
                                      init_decode_state, init_model, prefill)
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.runtime.fault import LinkHealthMonitor  # noqa: E402
from repro_torch.runtime.obs import counter_events, trace_export  # noqa
from repro_torch.runtime.serve_loop import (  # noqa: E402
    PagedServeConfig, ServeConfig, make_decode_fn, paged_request_window,
    serve_batch_paged, serve_replicated)
from repro_torch.runtime.train_loop import (  # noqa: E402
    TrainConfig, make_grads_fn, make_train_step, split_pods)
from repro_torch.core.params import NetworkParams  # noqa: E402
from repro_torch.sim import desim as SIM  # noqa: E402
from repro_torch.sim import (SCHEMES, WORKLOADS, SimConfig,  # noqa: E402
                             generate_trace)
from repro_torch.sim.schemes import PAPER_FIG8  # noqa: E402
from repro_torch.sim.workloads import make_link_schedule  # noqa: E402

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
    """Largest |a - b| over the pairs. Equal values (equal infinities
    too) and NaN against NaN count as 0; NaN against a number as inf."""
    err = 0.0
    for a, b in zip(a_list, b_list):
        a, b = a.double(), b.double()
        same = (a == b) | (a.isnan() & b.isnan())
        d = torch.where(same, 0.0, (a - b).abs().nan_to_num(nan=math.inf))
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


KERNELS = (PG.KERNEL, RF.KERNEL) + QD.KERNELS + BDI.KERNELS


def build_phase():
    secs = _build.build_all(KERNELS)
    phase("build", seconds=f"{secs:.2f}", dir=_build.BUILD_DIR)
    logs = {k.source: k.build_log for k in KERNELS}
    for source, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  {source}: {line.strip()}")


# ---------------------------------------------------------------- phase 3
def gather_case(gen, pool_rows, rows):
    """A bf16 remote pool of `pool_rows` (16, 8, 128) rows (32 KB each),
    `rows` random indices and a random half mask."""
    pool = torch.randn((pool_rows, 16, 8, 128), generator=gen, device=DEV
                       ).to(torch.bfloat16)
    idx = torch.randint(0, pool_rows, (rows,), generator=gen, device=DEV,
                        dtype=torch.int32)
    mask = torch.rand((rows,), generator=gen, device=DEV) < 0.5
    return pool, idx, mask


def gather_cold(gen, pool, rows, n=20):
    """Device ms of K2 and of index_select with L2 cold: each of the
    `n` back-to-back calls in the timed graph gathers another `rows`
    random rows, so the rows read add up to more than the 50 MB L2."""
    idxs = [torch.randint(0, pool.shape[0], (rows,), generator=gen,
                          device=DEV, dtype=torch.int32) for _ in range(n)]
    idx64 = [i.long() for i in idxs]
    k = iter(range(10 ** 9))
    return {
        "cold_ms": device_ms(lambda: PG.paged_gather(pool, idxs[next(k) % n]),
                             iters=n),
        "library_cold_ms": device_ms(
            lambda: torch.index_select(pool, 0, idx64[next(k) % n]),
            iters=n),
    }


def gather_timing(pool, idx):
    """K2 on one pool and on the K/V pair (one launch; the main path's
    form): device ms of the kernel, the plain version and index_select
    (two calls for the pair), the byte bound, and the eager call's ms.
    Rows repeat from call to call, so they are read from L2."""
    row = pool[0].numel() * pool.element_size()
    idx64 = idx.long()
    pool_v = torch.flip(pool, (0,))
    one = 2 * idx.shape[0] * row + idx.numel() * 4
    return {
        "ms": device_ms(lambda: PG.paged_gather(pool, idx)),
        "plain_ms": device_ms(lambda: REF.paged_gather(pool, idx)),
        "library_ms": device_ms(lambda: torch.index_select(pool, 0, idx64)),
        "bound_ms": one / HBM_BYTES_PER_MS,
        "call_ms": call_ms(lambda: PG.paged_gather(pool, idx)),
        "library_call_ms": call_ms(lambda: torch.index_select(pool, 0,
                                                              idx64)),
        "pair_ms": device_ms(lambda: PG.paged_gather_pair(pool, pool_v,
                                                          idx)),
        "pair_plain_ms": device_ms(lambda: (REF.paged_gather(pool, idx),
                                            REF.paged_gather(pool_v, idx))),
        "pair_library_ms": device_ms(lambda: (
            torch.index_select(pool, 0, idx64),
            torch.index_select(pool_v, 0, idx64))),
        "pair_bound_ms": (2 * one - idx.numel() * 4) / HBM_BYTES_PER_MS,
        "pair_call_ms": call_ms(lambda: PG.paged_gather_pair(pool, pool_v,
                                                             idx)),
    }


def gather_phase(gen):
    """K2 bit for bit, one pool and the K/V pair, masked and unmasked, at
    the serving shape (remote pool 8*64 rows of (16, 8, 128) bf16, L = 32
    = B*R) and at the store benchmark's batch (pool 64*64 rows, L = 256 =
    64*4), with indices past both ends; timed at both. Its record in the
    kernel line is the pair at the serving shape, as `_remote_fetch`
    launches it."""
    errs, times = [], {}
    for pool_rows, rows in ((8 * 64, 32), (64 * 64, 256)):
        pool, idx, mask = gather_case(gen, pool_rows, rows)
        pool_v = torch.flip(pool, (0,))
        edge = idx.clone()
        edge[:3] = torch.tensor([-1, -pool_rows - 5, pool_rows + 7])
        for ix in (idx, edge):
            for m in (None, mask):
                got = PG.paged_gather(pool, ix, m)
                got_k, got_v = PG.paged_gather_pair(pool, pool_v, ix, m)
                want = REF.paged_gather(pool, ix, m)
                want_v = REF.paged_gather(pool_v, ix, m)
                torch.cuda.synchronize()
                if not (torch.equal(got, want) and torch.equal(got_k, want)
                        and torch.equal(got_v, want_v)):
                    raise AssertionError(f"paged_gather != plain at L={rows} "
                                         f"(mask={m is not None})")
                errs.append(max_abs_err([got, got_k, got_v],
                                        [want, want, want_v]))
        t = gather_timing(pool, idx)
        if rows == 256:
            t.update(gather_cold(gen, pool, rows))
        phase("paged_gather", exact=True, rows=rows, pool_rows=pool_rows,
              row_bytes=pool[0].numel() * pool.element_size(), **t)
        times[rows] = t
        del pool, pool_v
    t = times[32]
    return {
        "name": "paged_gather", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_gather.cu",
        "replaces": "src/repro/kernels/paged_gather.py:30",
        "max_abs_err": max(errs), "ms": t["pair_ms"],
        "plain_ms": t["pair_plain_ms"], "library_ms": t["pair_library_ms"],
        "bound_ms": t["pair_bound_ms"], "bound_by": "bytes",
        "form": "K and V pools in one launch, L = 32 rows each; "
                "library_ms is two index_select calls",
    }


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


def smem_check():
    """The wrapper's shared-memory formula equals the kernel's layout at
    the shapes chip_smoke launches."""
    fn = RF.KERNEL.lib().residency_fused_smem_bytes
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    for b, s, w, p, r in ((64, 1, 4096, 16, 4), (64, 256, 16, 16, 4),
                          (8, 1, 4096, 256, 4), (8, 256, 16, 256, 4),
                          (8, 4, 4, 256, 4), (2, 1, 4, 256, 2)):
        geo = RF.launch_geometry(b, s, w, p, r, 32768)
        got = fn(s, w, p, geo.lanes, r, geo.touched)
        if got != geo.smem:
            raise AssertionError(f"smem {s}x{w}: kernel {got}, wrapper "
                                 f"{geo.smem}")


def residency_phase(gen):
    smem_check()
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
        eng, fab, _, ls, ps, stalls, _ = DS._schedule(eng, fab, store, need,
                                                      offs, hit, clock)
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
    return k1_inputs, ms, state["runs"][0]["k"]


def k1_bound_bytes(k1_inputs):
    """Bytes K1 must move on these inputs: the metadata read and written
    once, the small per-lane and per-request arrays, and the rows of the
    landings this data needs (compacted landed lanes that get a slot)
    and of every request, K and V, each read once and written once."""
    res, kpool, vpool, rk, rv, landed, lpages, need, writes, clock, pol = \
        k1_inputs
    b, s, w = res.page.shape
    n = s * w
    k_lanes = min(landed.shape[1], n)
    row = kpool[0, 0].numel() * kpool.element_size()
    order = torch.sort((~landed).int(), dim=1, stable=True).indices
    pick = order[:, :k_lanes]
    do = landed.gather(1, pick)
    pids = lpages.gather(1, pick)
    _, _, ok = residency.landing_victims(res, pids, pol)
    n_land = int((do & ok).sum())
    r = need.shape[1]
    meta = b * n * 17 * 2                       # read, written back
    small = b * landed.shape[1] * 5 + b * r * 5 + b * k_lanes * 4 + b * 4 \
        + b * r + 16
    rows = 2 * (2 * n_land * row) + 2 * (2 * b * r * row)  # k and v
    return meta + small + rows, n_land


def k1_check(k1_inputs, what):
    """K1 on a copy of the inputs against the plain version on another:
    every output equal. Returns max |err|."""
    res, kpool, vpool, *rest = k1_inputs
    ref = REF.fused_residency_step(res, kpool.clone(), vpool.clone(), *rest)
    got = RF.fused_residency_step(res, kpool.clone(), vpool.clone(), *rest)
    for name, a, c in zip(OUT_NAMES, flat_out(ref), flat_out(got)):
        if not torch.equal(a, c):
            raise AssertionError(f"{what} K1 differs on {name}")
    return max_abs_err(flat_out(ref), flat_out(got))


def k1_timing(k1_inputs, title):
    """K1 timed on `k1_inputs` against its bound and its plain version;
    prints one phase line and returns its numbers."""
    res, kpool, _, _, _, landed, _, need, _, _, _ = k1_inputs
    b, s, w = res.page.shape
    err = k1_check(k1_inputs, title)
    nbytes, n_land = k1_bound_bytes(k1_inputs)
    t = {
        "max_abs_err": err,
        "ms": device_ms(lambda: RF.fused_residency_step(*k1_inputs)),
        "plain_ms": device_ms(lambda: REF.fused_residency_step(*k1_inputs),
                              iters=5),
        "bound_ms": nbytes / HBM_BYTES_PER_MS,
        "call_ms": call_ms(lambda: RF.fused_residency_step(*k1_inputs)),
        "plain_call_ms": call_ms(
            lambda: REF.fused_residency_step(*k1_inputs), iters=20),
    }
    geo = RF.launch_geometry(b, s, w, landed.shape[1], need.shape[1],
                             kpool[0, 0].numel() * kpool.element_size())
    phase(title, batch=b, geometry=f"{s}x{w}", inflight=landed.shape[1],
          requests=need.shape[1], landings=n_land,
          blocks_per_seq=geo.blocks, smem=geo.smem,
          row_bytes=kpool[0, 0].numel() * kpool.element_size(),
          **{k: v for k, v in t.items() if k != "max_abs_err"})
    return t


def k1_phase(k1_inputs, gen, err):
    """K1 timed on the serving run's own last-step inputs (its record
    in the kernel line) and on the store benchmark's hot-path shape
    (B = 64, 256 x 16, 16 in-flight lanes, R = 4, (4, 1, 8) rows)."""
    t = k1_timing(k1_inputs, "fused_residency_step_serve_shape")
    pol = residency.as_policy("lru", device=DEV)
    hot = k1_case(gen, 64, 256, 16, 16, 4, (4, 1, 8)) + (pol,)
    k1_timing(hot, "fused_residency_step_hot_path")
    return {
        "name": "fused_residency_step", "route": "cuda",
        "source": "src/repro_torch/csrc/residency_fused.cu",
        "replaces": "src/repro/kernels/residency_fused.py:217",
        "max_abs_err": max(err, t["max_abs_err"]), "ms": t["ms"],
        "plain_ms": t["plain_ms"], "library_ms": None,
        "bound_ms": t["bound_ms"], "bound_by": "bytes",
    }


# ---------------------- store drives: replicated, single-sequence, chain
DRIVE_STORE = dict(num_local_pages=16, pool_ways=4, page_tokens=4,
                   kv_heads=2, head_dim=16, page_budget_per_step=32,
                   fabric=FabricConfig(num_modules=4))
DRIVE_PAGES, DRIVE_R, DRIVE_STEPS = 256, 4, 48
FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)   # tests/test_movement_plane.py:63


def drive_requests(rng, shape):
    """One step's zipf page ids, token offsets and write flags."""
    need = ((rng.zipf(1.3, shape) - 1) % DRIVE_PAGES).astype(np.int32)
    return (need, rng.integers(0, 4, shape).astype(np.int32),
            rng.random(shape) < 0.4)


def drive_remote(rng):
    return torch.from_numpy(rng.standard_normal(
        (DRIVE_PAGES, 4, 2, 16)).astype(np.float32)).to(torch.bfloat16)


def compare_states(a, b, where, exact=False):
    """Every leaf of two store states (or outputs) equal: integer, bool
    and bf16 leaves exactly; f32 leaves exactly when `exact`, else within
    FLOAT_TOL. Returns (identical, largest f32 difference)."""
    la, lb = leaves(a), leaves(b)
    if set(la) != set(lb):
        raise AssertionError(f"{where}: leaves differ {set(la) ^ set(lb)}")
    identical, worst = True, 0.0
    for key, x in la.items():
        x, y = x.cpu(), lb[key].cpu()
        if torch.equal(x, y):
            continue
        identical = False
        if exact or x.dtype != torch.float32:
            raise AssertionError(f"{where}: {key} differs")
        np.testing.assert_allclose(x.numpy(), y.numpy(), **FLOAT_TOL,
                                   err_msg=f"{where}: {key}")
        worst = max(worst, float((x.double() - y.double()).abs().max()))
    return identical, worst


def drive_replicated_phase():
    """48 steps of step_fetch_replicated at C = 2 and 3 (B = 4), the card
    against the CPU on every state leaf (NIC bank included) and output
    every step, with two-endpoint byte conservation; and C = 1 on the
    card against step_fetch_batch, bit for bit, its NIC bank all zeros."""
    cfg = DS.KVStoreConfig(**DRIVE_STORE)
    b = 4
    for c in (2, 3):
        rng = np.random.default_rng(c)
        remote_c = drive_remote(rng)
        remote_g = remote_c.to(DEV)
        st_g = DS.init_kv_store_replicated(cfg, c, b, device=DEV)
        st_c = DS.init_kv_store_replicated(cfg, c, b, device="cpu")
        same, worst = True, 0.0
        for step in range(DRIVE_STEPS):
            need, offs, wr = (torch.from_numpy(x) for x in
                              drive_requests(rng, (c, b, DRIVE_R)))
            st_g, *out_g = DS.step_fetch_replicated(
                st_g, cfg, remote_g, remote_g, need.to(DEV), offs.to(DEV),
                wr.to(DEV))
            st_c, *out_c = DS.step_fetch_replicated(
                st_c, cfg, remote_c, remote_c, need, offs, wr)
            i1, w1 = compare_states(st_g, st_c, f"C={c} step {step}")
            i2, w2 = compare_states(out_g, out_c, f"C={c} step {step} out")
            same, worst = same and i1 and i2, max(worst, w1, w2)
        led = DS.ledger(st_g)
        units, mods = sum(led["unit_bytes"]), sum(led["module_bytes"])
        if not (led["dirty_evicts"] > 0 and led["evictions"] > 0):
            raise AssertionError(f"C={c}: no dirty writebacks: {led}")
        for got in (units, mods):
            if abs(got - led["wire_bytes"]) > 1e-6 * led["wire_bytes"]:
                raise AssertionError(f"C={c}: bytes not conserved "
                                     f"{units} {mods} {led['wire_bytes']}")
        wb_units = int((st_g.nic.wb_bytes > 0).sum())
        phase("store_drive_replicated", steps=DRIVE_STEPS, replicas=c,
              batch=b, card_equals_cpu=True, identical=same,
              max_f32_diff=worst, unit_bytes=led["unit_bytes"],
              module_bytes_sum=mods, wire_bytes=led["wire_bytes"],
              units_writing_back=wb_units,
              dirty_evicts=led["dirty_evicts"],
              hit_rate=f"{led['local_hits'] / led['requests']:.3f}")
    rng = np.random.default_rng(1)
    remote = drive_remote(rng).to(DEV)
    rep = DS.init_kv_store_replicated(cfg, 1, b, device=DEV)
    bat = DS.init_kv_store_batch(cfg, b, device=DEV)
    for step in range(DRIVE_STEPS):
        need, offs, wr = (torch.from_numpy(x).to(DEV) for x in
                          drive_requests(rng, (b, DRIVE_R)))
        rep, *out_r = DS.step_fetch_replicated(rep, cfg, remote, remote,
                                               need[None], offs[None],
                                               wr[None])
        bat, *out_b = DS.step_fetch_batch(bat, cfg, remote, remote, need,
                                          offs, wr)
        compare_states((rep.seqs, rep.fab, rep.clock),
                       (bat.seqs, bat.fab, bat.clock), f"C=1 step {step}",
                       exact=True)
        compare_states([o[0] for o in out_r], out_b, f"C=1 step {step} out",
                       exact=True)
    nic = leaves(rep.nic)
    if any(bool(v.any()) for k, v in nic.items()
           if k.split(".")[1] in ("line_busy", "page_busy", "wb_busy",
                                  "line_bytes", "page_bytes", "wb_bytes")):
        raise AssertionError("C=1 touched its NIC bank")
    phase("store_drive_replicated", steps=DRIVE_STEPS, replicas=1, batch=b,
          equals_step_fetch_batch=True, nic_untouched=True)


def drive_single_phase():
    """48 steps of step_fetch (one sequence), card against CPU."""
    cfg = DS.KVStoreConfig(**DRIVE_STORE)
    rng = np.random.default_rng(4)
    remote_c = drive_remote(rng)
    remote_g = remote_c.to(DEV)
    st_g = DS.init_kv_store(cfg, device=DEV)
    st_c = DS.init_kv_store(cfg, device="cpu")
    same, worst = True, 0.0
    for step in range(DRIVE_STEPS):
        need, offs, wr = (torch.from_numpy(x) for x in
                          drive_requests(rng, (DRIVE_R,)))
        st_g, *out_g = DS.step_fetch(st_g, cfg, remote_g, remote_g,
                                     need.to(DEV), offs.to(DEV), wr.to(DEV))
        st_c, *out_c = DS.step_fetch(st_c, cfg, remote_c, remote_c, need,
                                     offs, wr)
        i1, w1 = compare_states(st_g, st_c, f"single step {step}")
        i2, w2 = compare_states(out_g, out_c, f"single step {step} out")
        same, worst = same and i1 and i2, max(worst, w1, w2)
    led = DS.ledger(st_g)
    phase("store_drive_single", steps=DRIVE_STEPS, card_equals_cpu=True,
          identical=same, max_f32_diff=worst,
          page_moves=led["page_moves"], evictions=led["evictions"],
          hit_rate=f"{led['local_hits'] / led['requests']:.3f}")


def chain_phase():
    """The 48-step batched drive (B = 8) with kernel_impl="chain" against
    "auto" on the card: every state leaf and output equal bit for bit.
    Returns K2's launches from the chain's run (its landing and lookup
    gathers, one pool each, plus the remote fetch pair)."""
    b = 8
    cfg_a = DS.KVStoreConfig(kernel_impl="auto", **DRIVE_STORE)
    cfg_c = DS.KVStoreConfig(kernel_impl="chain", **DRIVE_STORE)
    rng = np.random.default_rng(0)
    remote = drive_remote(rng).to(DEV)
    st_a = DS.init_kv_store_batch(cfg_a, b, device=DEV)
    st_c = DS.init_kv_store_batch(cfg_c, b, device=DEV)
    reqs = [drive_requests(rng, (b, DRIVE_R)) for _ in range(DRIVE_STEPS)]
    PG.KERNEL.launches = 0
    RF.KERNEL.launches = 0
    for step, req in enumerate(reqs):
        need, offs, wr = (torch.from_numpy(x).to(DEV) for x in req)
        st_c, *out_c = DS.step_fetch_batch(st_c, cfg_c, remote, remote, need,
                                           offs, wr)
    torch.cuda.synchronize()
    chain_k2, chain_k1 = PG.KERNEL.launches, RF.KERNEL.launches
    st_c2 = DS.init_kv_store_batch(cfg_c, b, device=DEV)
    for step, req in enumerate(reqs):
        need, offs, wr = (torch.from_numpy(x).to(DEV) for x in req)
        st_a, *out_a = DS.step_fetch_batch(st_a, cfg_a, remote, remote, need,
                                           offs, wr)
        st_c2, *out_c2 = DS.step_fetch_batch(st_c2, cfg_c, remote, remote,
                                             need, offs, wr)
        compare_states(st_c2, st_a, f"chain step {step}", exact=True)
        compare_states(out_c2, out_a, f"chain step {step} out", exact=True)
    led = DS.ledger(st_a)
    if chain_k1 != 0 or chain_k2 != 5 * DRIVE_STEPS:
        raise AssertionError(f"chain launched K1 {chain_k1}, K2 {chain_k2}"
                             f"; expected 0 and {5 * DRIVE_STEPS}")
    phase("store_chain", steps=DRIVE_STEPS, batch=b, identical=True,
          k2_launches=chain_k2, k1_launches=chain_k1,
          evictions=led["evictions"], dirty_evicts=led["dirty_evicts"])
    return chain_k2


# ------------------------------- serving surface: replicas, telemetry
REP_C = 2


def replicated_reference_phase():
    """serve_replicated on reduced qwen3-1.7b (f32), C = 2: the card
    against the CPU, greedy tokens and the whole ledger (unit_bytes
    included) equal."""
    cfg = get_config("qwen3-1.7b").reduced()
    params_cpu = init_model(cfg, torch.Generator().manual_seed(0))
    params = _to(params_cpu, DEV)
    prompts = torch.randint(2, 200, (2, 6),
                            generator=torch.Generator().manual_seed(1))
    store = DS.KVStoreConfig(num_local_pages=4, page_tokens=2, kv_heads=2,
                             head_dim=16, page_budget_per_step=2)
    pcfg = PagedServeConfig(window_pages=2, pages_per_seq=8)
    scfg = ServeConfig(max_new_tokens=10)
    tok_c, led_c = serve_replicated(params_cpu, cfg, prompts, scfg, store,
                                    REP_C, pcfg, device="cpu")
    tok_g, led_g = serve_replicated(params, cfg, prompts.to(DEV), scfg,
                                    store, REP_C, pcfg)
    if not torch.equal(tok_g.cpu(), tok_c):
        raise AssertionError("replicated greedy tokens differ card/CPU")
    if set(led_g) != set(led_c):
        raise AssertionError("ledger keys differ")
    identical = all(led_g[k] == v for k, v in led_c.items())
    for k, v in led_c.items():
        np.testing.assert_allclose(led_g[k], v, **FLOAT_TOL, err_msg=k)
    if not led_c["dirty_evicts"] > 0:
        raise AssertionError("reduced replicated serve wrote nothing back")
    phase("serve_replicated_reference", model="qwen3-1.7b-reduced f32",
          replicas=REP_C, batch=2, tokens_equal=True,
          ledger_identical=identical, unit_bytes=led_g["unit_bytes"],
          wire_bytes=led_g["wire_bytes"])


def telemetry_phase():
    """Reduced serve at telemetry level "trace" over a scheduled link
    whose module 1 degrades, with a LinkHealthMonitor: the card against
    the CPU on stall percentiles, every tenant's series rows and the
    reshard advisories; the spans and series exported to Chrome trace
    JSON in a temporary directory, parsed back."""
    cfg = get_config("qwen3-1.7b").reduced()
    params_cpu = init_model(cfg, torch.Generator().manual_seed(0))
    params = _to(params_cpu, DEV)
    prompts = torch.randint(2, 200, (2, 6),
                            generator=torch.Generator().manual_seed(1))
    tcfg = TelemetryConfig(level="trace", lat_lo=0.01, lat_hi=1e4)
    store = DS.KVStoreConfig(num_local_pages=4, page_tokens=2, kv_heads=2,
                             head_dim=16, page_budget_per_step=2,
                             fabric=FabricConfig(num_modules=3),
                             telemetry=tcfg)
    pcfg = PagedServeConfig(window_pages=2, pages_per_seq=8)
    sched = (np.array([0.0, 4.0, 9.0], np.float32), np.ones((3, 3)),
             np.array([[1.0, 1.0, 1.0], [1.0, 0.05, 1.0],
                       [1.0, 0.05, 1.0]], np.float32))
    bw = DS.link_bytes_per_step(store)
    out = {}
    for where, dev, p in (("cpu", "cpu", params_cpu), ("card", DEV, params)):
        link = scheduled_link(bw, sched, 3, device=dev)
        _, led = serve_batch_paged(
            p, cfg, prompts.to(dev), ServeConfig(max_new_tokens=10), store,
            pcfg, link=link,
            health_monitor=LinkHealthMonitor(floor=0.5, patience=2),
            device=dev)
        tel = led.pop("_tel")
        rows = [series_rows(TelemetryState(*(x[b] for x in tel)), tcfg)
                for b in range(prompts.shape[0])]
        out[where] = (led, tel, rows)
    (led_c, tel_c, rows_c), (led_g, tel_g, rows_g) = out["cpu"], out["card"]
    keys = ("stall_p50_steps", "stall_p90_steps", "stall_p99_steps",
            "link_reshard_modules")
    for k in keys:
        if led_g[k] != led_c[k]:
            raise AssertionError(f"telemetry {k}: card {led_g[k]} cpu "
                                 f"{led_c[k]}")
    if not torch.equal(tel_g.hist.cpu(), tel_c.hist):
        raise AssertionError("stall histograms differ card/CPU")
    rows_identical = True
    for (sg, rg), (sc, rc) in zip(rows_g, rows_c):
        np.testing.assert_array_equal(sg, sc)
        rows_identical &= bool(np.array_equal(rg, rc))
        np.testing.assert_allclose(rg, rc, **FLOAT_TOL)
    if led_g["link_reshard_modules"] != [1]:
        raise AssertionError("the degraded module was not advised")
    counters = counter_events(TelemetryState(*(x[0] for x in tel_g)), tcfg,
                              DS.SERIES_CHANNELS)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        trace_export(str(path), spans=led_g["trace_spans"],
                     counters=counters, metadata={"serve": 0})
        doc = json.loads(path.read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    want = {"process_name", "prefill", "decode", "decode_step",
            *DS.SERIES_CHANNELS}
    if names != want:
        raise AssertionError(f"trace events {names} != {want}")
    phase("telemetry", level="trace", stall_p50=led_g["stall_p50_steps"],
          stall_p90=led_g["stall_p90_steps"],
          stall_p99=led_g["stall_p99_steps"],
          reshard=led_g["link_reshard_modules"], hist_equal=True,
          series_rows_identical=rows_identical,
          series_rows=sum(len(s) for s, _ in rows_g),
          trace_events=len(doc["traceEvents"]))


PREFILL_RTOL = 0.05     # of the largest magnitude, per compared tensor


def prefill_phase(cfg, params, prompts):
    """Full-width qwen3-1.7b, B = 8, 32-token prompts: one-pass prefill
    against the token-by-token decode on the card. The two paths multiply
    in other shapes, so their bf16 roundings differ and compound over 28
    layers: each compared tensor (last-position logits, each layer's K
    and V cache) is held within PREFILL_RTOL of its largest magnitude; a
    wrong position or layer gives differences of the magnitude itself."""
    opt = ModelOptions(remat="none")
    b, p = prompts.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = prefill(params, cfg, {"tokens": prompts}, p + SERVE_NEW,
                            opt)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    dec = init_decode_state(cfg, b, p + SERVE_NEW, opt, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(p):
        last, dec = decode_step(params, cfg, dec, prompts[:, i:i + 1], i, opt)
    torch.cuda.synchronize()
    dec_secs = time.perf_counter() - t0

    def rel(a, c):
        a, c = a.float(), c.float()
        if not (torch.isfinite(a).all() and a.shape == c.shape):
            raise AssertionError("prefill output not finite or misshapen")
        return float((a - c).abs().max() / c.abs().max())

    err = rel(logits[:, -1], last)
    cache_err = max(rel(state["runs"][0][key][layer, :, :p],
                        dec["runs"][0][key][layer, :, :p])
                    for key in ("k", "v")
                    for layer in range(cfg.num_layers))
    if max(err, cache_err) > PREFILL_RTOL:
        raise AssertionError(f"prefill differs from decode: logits {err}, "
                             f"caches {cache_err} of their magnitude")
    if state["runs"][0]["k"][:, :, p:].any():
        raise AssertionError("prefill wrote past the prompt")
    v = cfg.vocab_size
    same_tok = float((logits[:, -1, :v].argmax(-1) == last[:, :v].argmax(-1)
                      ).float().mean())
    phase("prefill", model="qwen3-1.7b", batch=b, prompt=p,
          seconds=f"{secs:.4f}", decode_seconds=f"{dec_secs:.4f}",
          logits_rel_diff=f"{err:.5f}", cache_rel_diff=f"{cache_err:.5f}",
          rtol=PREFILL_RTOL, next_token_equal_frac=same_tok)


class CaptureK1:
    """Wraps DS._transact while active: the inputs of its `at`-th call
    (1-based) are cloned before the call, as the residency kernel's
    arguments, for checking and timing it at the main path's shapes."""

    def __init__(self, at):
        self.at, self.calls, self.inputs = at, 0, None

    def __enter__(self):
        self._orig = DS._transact

        def wrapped(seqs, cfg, remote_k, remote_v, clock, pol, need, wr):
            self.calls += 1
            if self.calls == self.at:
                landed, lpages = poll_arrivals(seqs.eng, clock)
                self.inputs = tuple(
                    x.clone() if isinstance(x, torch.Tensor) else x
                    for x in (seqs.res, seqs.kpool, seqs.vpool, remote_k,
                              remote_v, landed, lpages, need, wr, clock,
                              pol))
            return self._orig(seqs, cfg, remote_k, remote_v, clock, pol,
                              need, wr)
        DS._transact = wrapped
        return self

    def __exit__(self, *exc):
        DS._transact = self._orig


def serve_replicated_phase(cfg, params, prompts):
    """Full-width qwen3-1.7b through serve_replicated: C = 2 replicas x
    B = 8 tenants with the serve cell's store, 32 prompt + 32 new tokens:
    the replicated serving path. Checks every request counted, bytes
    conserved on modules and on units, one K1 launch per step over 16
    sequences. Returns (launch counts, K1's last-step inputs)."""
    store = DS.KVStoreConfig(**SERVE_STORE)
    scfg = ServeConfig(max_new_tokens=SERVE_NEW)
    steps = SERVE_PROMPT + SERVE_NEW
    seqs = REP_C * SERVE_B
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with CaptureK1(at=steps) as cap:
        PG.KERNEL.launches = 0
        RF.KERNEL.launches = 0
        t0 = time.perf_counter()
        tokens, led = serve_replicated(params, cfg, prompts, scfg, store,
                                       REP_C, SERVE_PAGED)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {"paged_gather": PG.KERNEL.launches,
                  "fused_residency_step": RF.KERNEL.launches}
    peak = torch.cuda.max_memory_allocated()
    r = SERVE_PAGED.window_pages
    if counts["fused_residency_step"] != steps or \
            counts["paged_gather"] != steps:
        raise AssertionError(f"launches {counts}, expected {steps} each")
    if led["requests"] != seqs * r * steps:
        raise AssertionError(f"requests {led['requests']} != C*B*R*steps")
    for key in ("module_bytes", "unit_bytes"):
        if abs(sum(led[key]) - led["wire_bytes"]) > \
                1e-5 * max(led["wire_bytes"], 1.0):
            raise AssertionError(f"{key} do not sum to wire bytes")
    if tokens.shape != (REP_C, SERVE_B, steps) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError("tokens out of range or of the wrong shape")
    res = cap.inputs[0]
    geo = RF.launch_geometry(seqs, res.page.shape[1], res.page.shape[2],
                             cap.inputs[5].shape[1], r,
                             cap.inputs[1][0, 0].numel() * 2)
    if not (2 <= geo.blocks <= RF.MAX_BLOCKS and geo.grid == seqs * geo.blocks
            and geo.grid <= RF.RESIDENT_PER_SM * RF.NUM_SMS):
        raise AssertionError(f"K1 geometry at {seqs} sequences: {geo}")
    phase("serve_replicated", model="qwen3-1.7b", replicas=REP_C,
          batch=SERVE_B, sequences=seqs, prompt=SERVE_PROMPT, new=SERVE_NEW,
          seconds=f"{secs:.3f}", steps_per_s=f"{steps / secs:.2f}",
          tokens_per_s=f"{seqs * SERVE_NEW / secs:.2f}",
          hit_rate=f"{led['local_hits'] / led['requests']:.4f}",
          peak_gib=f"{peak / 2**30:.2f}", launches=counts,
          k1_blocks_per_seq=geo.blocks, k1_grid=geo.grid,
          unit_bytes=led["unit_bytes"], wire_bytes=led["wire_bytes"])
    return counts, cap.inputs


def replicated_split_phase(cfg, params, prompts, steps=12, timed=8):
    """ms per decode step of the replicated serve split into model decode
    and the store's parts (host clock, each part ended by a synchronize),
    over `steps` steps of the serve_replicated schedule, the last `timed`
    averaged; then one more step under torch.profiler for the device's
    busy share of the step."""
    opt = ModelOptions(remat="none")
    store = DS.KVStoreConfig(**SERVE_STORE)
    c, b = REP_C, prompts.shape[0]
    flat = prompts.repeat(c, 1)
    state = init_decode_state(cfg, c * b, steps + 1, opt, device=DEV)
    step = make_decode_fn(cfg, opt)
    kv = DS.init_kv_store_replicated(store, c, b, device=DEV)
    rshape = (c * b * SERVE_PAGED.pages_per_seq, store.page_tokens,
              store.kv_heads, store.head_dim)
    remote = torch.zeros(rshape, dtype=torch.bfloat16, device=DEV)
    seq_ids = torch.arange(c * b, dtype=torch.int32, device=DEV)
    pol = residency.as_policy(store.policy, device=DEV)
    cus = torch.div(torch.arange(c * b, device=DEV), b,
                    rounding_mode="floor")
    active = torch.tensor(True, device=DEV)
    page_wire = DS._wire_bytes(store, store.page_tokens, store.compress_pages)
    parts = {"model": [], "transact": [], "remote_fetch": [],
             "schedule": []}

    def one(i, record):
        nonlocal state, kv
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        j = i % flat.shape[1]
        _, state = step(params, state, flat[:, j:j + 1], i, None, 0.0)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        need, offs, writes = paged_request_window(
            torch.full((c * b,), i, dtype=torch.int32, device=DEV), seq_ids,
            store.page_tokens, SERVE_PAGED.window_pages,
            SERVE_PAGED.pages_per_seq)
        clock = kv.clock + 1.0
        seqs, evicted, _, _, hit = DS._transact(
            kv.seqs, store, remote, remote, clock, pol, need, writes)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        DS._remote_fetch(remote, remote, need.reshape(-1), ~hit.reshape(-1),
                         store.kernel_impl)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        eng, fab, n_wb = DS._writebacks(seqs.eng, kv.fab, store, evicted,
                                        clock, page_wire)
        nic = DS._nic_writebacks(kv.nic, n_wb, cus, active, clock,
                                 page_wire)
        eng, fab, nic, ls, ps, stalls, _ = DS._schedule(
            eng, fab, store, need, offs, hit, clock, nic=nic, cus=cus,
            active=active)
        stats = DS._stats_fold(seqs.stats, store, ls, ps, stalls, hit, n_wb)
        kv = DS.ReplicatedKVStoreState(seqs._replace(eng=eng, stats=stats),
                                       fab, nic, clock)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        if record:
            parts["model"].append(t1 - t0)
            parts["transact"].append(t2 - t1)
            parts["remote_fetch"].append(t3 - t2)
            parts["schedule"].append(t4 - t3)
        return t4 - t0

    for i in range(steps):
        one(i, i >= steps - timed)
    ms = {k: 1e3 * float(np.mean(v)) for k, v in parts.items()}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall = one(steps, False)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    step_ms = sum(ms.values())
    phase("serve_replicated_split_ms",
          **{k: f"{v:.3f}" for k, v in ms.items()},
          store_total=f"{ms['transact'] + ms['remote_fetch'] + ms['schedule']:.3f}",
          steps=timed, profiled_step_ms=f"{1e3 * wall:.3f}",
          profiled_kernels=len(kernels),
          device_ms_per_step=(f"{dev_ms:.3f}" if kernels else "not measured"),
          device_busy_share=(f"{dev_ms / step_ms:.4f}" if kernels
                             else "not measured"))
    return ms



# ------------------------------------------------------------ phase 6: K3
EMB_ROWS = 152064 * 2048 // 256     # qwen3-1.7b's embedding table in blocks
QBLOCK = 256


def _grad_like(gen, rows, block=QBLOCK):
    """Gradient-like rows: normal values, per-row magnitudes over nine
    decades."""
    mag = 10.0 ** torch.randint(-8, 1, (rows, 1), generator=gen, device=DEV)
    return torch.randn((rows, block), generator=gen, device=DEV) * mag


def _tie_rows(block=QBLOCK):
    """An all-zero row, and rows of exact .5 ties at scale 1 and 2."""
    ties = torch.arange(block, device=DEV) % 254 - 127 + 0.5
    ties[0] = 127.0
    return torch.stack([torch.zeros(block, device=DEV), ties, 2 * ties])


def _non_finite_rows(gen, block=QBLOCK):
    """A row holding a NaN (scale 1), one holding +Inf (scale Inf, its
    Inf / Inf quotient NaN) and one holding NaN and -Inf (scale 1, -Inf
    clamps to -127)."""
    rows = _grad_like(gen, 3, block)
    rows[0, 5] = math.nan
    rows[1, 7] = math.inf
    rows[2, 1], rows[2, 2] = math.nan, -math.inf
    return rows


def check_qdq(x):
    """K3 on x against the plain versions: q, scale, and the dequantized
    f32 and bf16 outputs, all bit for bit (NaN against NaN counts as
    equal). Returns (q, scale, quantize's max |err|, dequantize's max
    |err|)."""
    q, s = QD.quantize_block_int8(x)
    rq, rs = REF.quantize_block_int8(x)
    torch.cuda.synchronize()
    if not (torch.equal(q, rq) and torch.equal(s, rs)):
        raise AssertionError(f"quantize_block_int8 != plain at {tuple(x.shape)}")
    err_d = 0.0
    for dt in (torch.float32, torch.bfloat16):
        d = QD.dequantize_block_int8(q, s, dt)
        rd = REF.dequantize_block_int8(q, s, dt)
        err_d = max(err_d, max_abs_err([d], [rd]))
        if err_d != 0.0:
            raise AssertionError(f"dequantize_block_int8 ({dt}) != plain")
    return q, s, max_abs_err([q, s], [rq, rs]), err_d


def qdq_phase(gen):
    """K3 bit for bit: a ragged N (13 rows) holding an all-zero row,
    exact .5 ties and rows with NaN and +-Inf, and the largest gradient
    leaf at full width (the 152064 x 2048 embedding table as 1,216,512
    rows of 256); timed on the latter."""
    small = _grad_like(gen, 13)
    small[:3] = _tie_rows()
    small[3:6] = _non_finite_rows(gen)
    q, s, eq0, ed0 = check_qdq(small)
    if s[:6, 0].tolist() != [1.0, 1.0, 2.0, 1.0, math.inf, 1.0]:
        raise AssertionError("zero, tie and non-finite rows' scales are not "
                             "1, 1, 2, 1, inf, 1")
    if q[[3, 4, 5, 5], [5, 7, 1, 2]].tolist() != [0, 0, 0, -127]:
        raise AssertionError("NaN quotients must give q = 0, -Inf -127")
    x = _grad_like(gen, EMB_ROWS)
    q, s, eq1, ed1 = check_qdq(x)
    n, b = x.shape
    bytes_q = n * b * 4 + n * b + n * 4       # read f32, write int8 + scale
    bytes_d = n * b + n * 4 + n * b * 4       # read int8 + scale, write f32
    common = {"route": "cuda", "source": "src/repro_torch/csrc/qdq_int8.cu",
              "bound_by": "bytes"}
    k3q = {"name": "quantize_block_int8", **common,
           "max_abs_err": max(eq0, eq1), "library_ms": None,
           "replaces": "src/repro/kernels/qdq_int8.py:34",
           "ms": device_ms(lambda: QD.quantize_block_int8(x)),
           "plain_ms": device_ms(lambda: REF.quantize_block_int8(x), iters=3,
                                 replays=3),
           "bound_ms": bytes_q / HBM_BYTES_PER_MS}
    k3d = {"name": "dequantize_block_int8", **common,
           "max_abs_err": max(ed0, ed1),
           "replaces": "src/repro/kernels/qdq_int8.py:52",
           "ms": device_ms(lambda: QD.dequantize_block_int8(q, s)),
           "plain_ms": device_ms(lambda: REF.dequantize_block_int8(q, s),
                                 iters=3, replays=3),
           # int8 * f32 promotes to f32 and multiplies in one pass
           "library_ms": device_ms(lambda: q * s),
           "bound_ms": bytes_d / HBM_BYTES_PER_MS}
    bf16_ms = device_ms(lambda: QD.dequantize_block_int8(q, s, torch.bfloat16))
    phase("qdq_int8", exact=True,
          cases=f"13x256(zero,ties,nan,inf),{n}x{b}",
          out_dtypes="f32,bf16", quant_ms=k3q["ms"],
          quant_plain_ms=k3q["plain_ms"], quant_bound_ms=k3q["bound_ms"],
          dequant_ms=k3d["ms"], dequant_plain_ms=k3d["plain_ms"],
          dequant_library_ms=k3d["library_ms"],
          dequant_bound_ms=k3d["bound_ms"], dequant_bf16_ms=bf16_ms,
          dequant_bf16_bound_ms=(n * b * 3 + n * 4) / HBM_BYTES_PER_MS)
    return k3q, k3d


# ------------------------------------------------------------ phase 7: K4
BDI_ROWS = 262144                   # a 256 MiB page plane of int32 words


def _bdi_rows(gen, rows, block=256):
    """Half base + small deltas, a quarter whose x - base overflows
    int32 and wraps to a small delta, a quarter random words."""
    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=DEV,
                             dtype=torch.int64)
    h, q = rows // 2, rows // 4
    d = ri(-128, 128, (h, block))
    d[:, 0] = 0
    small = ri(-2 ** 30, 2 ** 30, (h, 1)) + d
    wrap = -2 ** 31 + ri(0, 100, (q, block))
    wrap[:, 0] = 2 ** 31 - 1
    rand = ri(-2 ** 31, 2 ** 31 - 1, (rows - h - q, block))
    return torch.cat([small, wrap, rand]).to(torch.int32)


def check_bdi(x):
    """K4 on x against the plain versions, bit for bit, decompressing
    from x itself and from a raw copy that differs. Returns (the
    compressed triple, compress's max |err|, decompress's max |err|)."""
    got = BDI.bdi_compress(x)
    want = REF.bdi_compress(x)
    torch.cuda.synchronize()
    for name, a, c in zip(("base", "deltas", "ok"), got, want):
        if not torch.equal(a, c):
            raise AssertionError(f"bdi_compress != plain on {name}")
    err_d = 0.0
    for raw in (x, torch.roll(x, 1, 0)):
        d = BDI.bdi_decompress(*got, raw)
        rd = REF.bdi_decompress(*got, raw)
        if not torch.equal(d, rd):
            raise AssertionError("bdi_decompress != plain")
        err_d = max(err_d, max_abs_err([d], [rd]))
    if not torch.equal(BDI.bdi_decompress(*got, x), x):
        raise AssertionError("bdi round trip lost data")
    return got, max_abs_err(got, want), err_d


def bdi_phase(gen, kcache):
    """K4 bit for bit on compressible rows, rows whose x - base wraps,
    random rows, and the serve phase's K cache (28 layers x 8 sequences
    x 64 positions x 8 heads x 128, bf16) viewed as int32 rows of 256
    words; timed on a 256 MiB mixed page plane. No path of either
    package calls BDI: its launches are this phase's."""
    for k in BDI.KERNELS:
        k.launches = 0
    (_, _, ok), ec0, ed0 = check_bdi(_bdi_rows(gen, 48))
    if not (bool(ok[:36].all()) and not bool(ok[36:].any())):
        raise AssertionError("BDI ok pattern: base+delta and wrapped rows "
                             "must compress, random rows must not")
    kc = kcache.contiguous().view(torch.int32).reshape(-1, 256)
    (_, _, kc_ok), ec1, ed1 = check_bdi(kc)
    x = _bdi_rows(gen, BDI_ROWS)
    (base, deltas, okx), ec2, ed2 = check_bdi(x)
    launches = [k.launches for k in BDI.KERNELS]
    n, b = x.shape
    n_raw = n - int((okx != 0).sum())
    bytes_c = n * b * 4 + n * 4 + n * b + n
    # decompress reads ok for every row, base and deltas only for rows
    # that compress, raw only for those that do not
    bytes_d = n + (n - n_raw) * (4 + b) + n_raw * b * 4 + n * b * 4
    common = {"route": "cuda", "source": "src/repro_torch/csrc/bdi.cu",
              "library_ms": None, "bound_by": "bytes",
              "path": "none in either package; launches are the [bdi] "
                      "phase's own"}
    k4c = {"name": "bdi_compress", **common,
           "replaces": "src/repro/kernels/bdi.py:38", "launches": launches[0],
           "max_abs_err": max(ec0, ec1, ec2),
           "ms": device_ms(lambda: BDI.bdi_compress(x)),
           "plain_ms": device_ms(lambda: REF.bdi_compress(x), iters=3,
                                 replays=3),
           "bound_ms": bytes_c / HBM_BYTES_PER_MS}
    k4d = {"name": "bdi_decompress", **common,
           "replaces": "src/repro/kernels/bdi.py:58", "launches": launches[1],
           "max_abs_err": max(ed0, ed1, ed2),
           "ms": device_ms(lambda: BDI.bdi_decompress(base, deltas, okx, x)),
           "plain_ms": device_ms(lambda: REF.bdi_decompress(base, deltas,
                                                            okx, x),
                                 iters=3, replays=3),
           "bound_ms": bytes_d / HBM_BYTES_PER_MS}
    phase("bdi", exact=True, rows=f"48+{kc.shape[0]}(kcache)+{n}",
          kcache_ok_rows=int((kc_ok != 0).sum()), plane_raw_rows=n_raw,
          launches=launches, compress_ms=k4c["ms"],
          compress_plain_ms=k4c["plain_ms"],
          compress_bound_ms=k4c["bound_ms"], decompress_ms=k4d["ms"],
          decompress_plain_ms=k4d["plain_ms"],
          decompress_bound_ms=k4d["bound_ms"])
    return k4c, k4d


# ---------------------------------------------------------- phase 8: train
TRAIN_SHAPE = ShapeConfig("chip_train", 1024, 4, "train")
TRAIN_STEPS = 4
TRAIN_PODS = 2


def train_reference_phase():
    """The card against the CPU on reduced qwen3-1.7b (f32): 3 steps of
    dp_compress="int8" over 2 pods from the same params and batches,
    through K3 on the card and the plain versions on the CPU; losses
    within rtol 1e-4."""
    cfg = get_config("qwen3-1.7b").reduced()
    opt = ModelOptions(remat="none")
    tcfg = TrainConfig(adamw=AdamWConfig(lr=3e-3), warmup_steps=0,
                       total_steps=10, dp_compress="int8", num_pods=2)
    shape = ShapeConfig("t", 64, 4, "train")
    batches = [synthetic_batch(cfg, shape, DataConfig(seed=0), s,
                               device="cpu") for s in range(3)]
    losses = {}
    for where, dev in (("cpu", "cpu"), ("card", DEV)):
        params = _to(init_model(cfg, torch.Generator().manual_seed(0)), dev)
        opt_state = adamw_init(params)
        step = make_train_step(cfg, opt, tcfg)
        for k in QD.KERNELS:
            k.launches = 0
        out = []
        for s, batch in enumerate(batches):
            params, opt_state, m = step(params, opt_state, _to(batch, dev), s)
            out.append(float(m["loss"]))
        losses[where] = out
        launches = [k.launches for k in QD.KERNELS]
    np.testing.assert_allclose(losses["card"], losses["cpu"], rtol=1e-4)
    if min(launches) <= 0:
        raise AssertionError(f"reduced train did not launch K3: {launches}")
    phase("train_reference", model="qwen3-1.7b-reduced f32", steps=3,
          dp_compress="int8", pods=2, loss_card=losses["card"],
          loss_cpu=losses["cpu"], k3_launches=launches,
          allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
          allow_tf32_cudnn=torch.backends.cudnn.allow_tf32)


def _rounding_bound(params, cfg, opt, batch):
    """Pod 0's gradients of `batch` at `params`, quantized and
    dequantized per leaf: the largest |dequantized - gradient| / scale.
    Rounding to the int8 grid is within scale/2; the f32 division and
    product add at most 254 ulps of scale (2^-16 covers them)."""
    grads, _ = make_grads_fn(cfg, opt)(params, split_pods(batch,
                                                          TRAIN_PODS)[0])
    worst = 0.0
    for g in tree_leaves(grads):
        q, s = compression.quantize_block_int8(g, QBLOCK)
        d = compression.dequantize_block_int8(q, s, g.shape, QBLOCK)
        pad = (-g.numel()) % QBLOCK
        err = (d.reshape(-1).double() - g.reshape(-1).double()).abs()
        err = torch.nn.functional.pad(err, (0, pad)).reshape(-1, QBLOCK)
        worst = max(worst, float((err / s.double()[:, None]).max()))
        del q, s, d, err
    return worst


def train_phase():
    """Full-width qwen3-1.7b: f32 master params, bf16 compute, remat
    "full", 2 microbatches, dp_compress="int8" over 2 pods, AdamW lr
    3e-4; 4 steps of global batch 4 x 1024 from the port's
    synthetic_batch. The main path of the quantizer (K3)."""
    cfg = get_config("qwen3-1.7b")
    opt = ModelOptions(triangular_flash=True, remat="full")
    tcfg = TrainConfig(adamw=AdamWConfig(lr=3e-4), warmup_steps=0,
                       total_steps=TRAIN_STEPS, dp_compress="int8",
                       num_pods=TRAIN_PODS, quant_block=QBLOCK)
    dcfg = DataConfig(seed=0)
    params = init_model(cfg, torch.Generator(device=DEV).manual_seed(0))
    opt_state = adamw_init(params)
    n_leaves = len(tree_leaves(params))
    n_params = sum(t.numel() for t in tree_leaves(params))
    step_fn = make_train_step(cfg, opt, tcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in QD.KERNELS:
        k.launches = 0
    losses, gnorms, secs = [], [], []
    for s in range(TRAIN_STEPS):
        batch = synthetic_batch(cfg, TRAIN_SHAPE, dcfg, s, device=DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batch, s)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    counts = tuple(k.launches for k in QD.KERNELS)
    peak = torch.cuda.max_memory_allocated()
    want = TRAIN_STEPS * TRAIN_PODS * n_leaves
    if counts != (want, want):
        raise AssertionError(f"K3 launches {counts}, the step predicts "
                             f"{want} each")
    if not all(np.isfinite(losses)) or not all(np.isfinite(gnorms)):
        raise AssertionError(f"non-finite loss/grad_norm: {losses} {gnorms}")
    worst = _rounding_bound(params, cfg, opt, batch)
    if worst > 0.5 + 2 ** -16:
        raise AssertionError(f"dequantized grads {worst} scales from the "
                             "pod gradient, above 1/2")
    tokens = TRAIN_SHAPE.global_batch * TRAIN_SHAPE.seq_len
    phase("train", model="qwen3-1.7b", params=n_params, leaves=n_leaves,
          batch=TRAIN_SHAPE.global_batch, seq=TRAIN_SHAPE.seq_len,
          micro=cfg.grad_accum_microbatches, pods=TRAIN_PODS,
          remat=opt.remat, dtype=cfg.dtype, loss=losses, grad_norm=gnorms,
          step_s=[f"{t:.3f}" for t in secs],
          tokens_per_s=f"{tokens * TRAIN_STEPS / sum(secs):.1f}",
          tokens_per_s_after_first=f"{tokens * (TRAIN_STEPS - 1) / sum(secs[1:]):.1f}",
          peak_gib=f"{peak / 2**30:.2f}", k3_launches=counts,
          k3_launches_predicted=want,
          max_dequant_err_over_scale=f"{worst:.6f}")
    return tcfg, params, opt_state, step_fn, counts


def train_split_phase(tcfg, params, opt_state, step_fn, steps=2):
    """ms per full-width train step split into forward+backward, pod
    sync (K3 quantize + dequantize + mean) and optimizer: host clock,
    with a synchronize at each stage boundary of the step."""
    cfg = get_config("qwen3-1.7b")
    parts = {"forward_backward": 0.0, "pod_sync": 0.0, "optimizer": 0.0}
    last = [0.0]

    def mark(stage):
        torch.cuda.synchronize()
        now = time.perf_counter()
        parts[stage] += now - last[0]
        last[0] = now

    for s in range(TRAIN_STEPS, TRAIN_STEPS + steps):
        batch = synthetic_batch(cfg, TRAIN_SHAPE, DataConfig(seed=0), s,
                                device=DEV)
        torch.cuda.synchronize()
        last[0] = time.perf_counter()
        params, opt_state, _ = step_fn(params, opt_state, batch, s,
                                       on_stage=mark)
    ms = {k: 1e3 * v / steps for k, v in parts.items()}
    phase("train_split_ms", **{k: f"{v:.3f}" for k, v in ms.items()},
          total=f"{sum(ms.values()):.3f}", steps=steps)
    return ms


# ------------------------------------------------------ phase 9: simulator
GOLDEN = ROOT / "tests" / "golden" / "seed_movement_golden.json"
# the paper's fig-8 network grid (benchmarks/common.py NETWORK_GRID):
# switch latency (ns) x network bandwidth factor
FIG8_NETS = tuple((sw, bf) for sw in (100.0, 400.0) for bf in (2.0, 4.0, 8.0))
# benchmarks/run.py --quick replays 20000 requests; at ~19 ms of host
# time per request that phase alone took 387 s on the card, so the
# smoke run replays the golden's 6000 to stay within half its time limit
FIG8_R = 6000
AXES_SCHEMES = ("daemon", "daemon-adaptive", "bp", "remote")
AXES_R = 1200
SYNC_GUARD = 200                    # requests run under sync-debug "error"
PROFILED = 50                       # requests run under torch.profiler


def _sim_nets(pairs, **kw):
    return [SIM.make_net(NetworkParams(bw_factor=bf, switch_latency_ns=sw),
                         **kw) for sw, bf in pairs]


def _zero_launches():
    for k in KERNELS:
        k.launches = 0


def _launches():
    """Launches of every hand kernel since `_zero_launches`: the
    simulator reaches none (the reference's desim reaches no Pallas
    kernel)."""
    return {k.symbol: k.launches for k in KERNELS}


class StepWatch:
    """Watches one lattice's request loop by wrapping `desim.make_step`:
    requests [0, guard) run under `torch.cuda.set_sync_debug_mode(
    "error")`, so any host synchronization in the loop raises, and
    requests [start, start + n) under torch.profiler, whose CUDA kernels
    give the device time and launches per request."""

    def __init__(self, guard=0, start=None, n=0):
        self.guard, self.start, self.n = guard, start, n
        self.calls = 0
        self.kernels = []
        self.prof = None

    def __enter__(self):
        self.orig = SIM.make_step

        def make_step(*args, **kw):
            step = self.orig(*args, **kw)

            def watched(st, inp):
                i = self.calls
                if i == 0 and self.guard:
                    torch.cuda.set_sync_debug_mode("error")
                if i == self.start:
                    torch.cuda.synchronize()
                    self.prof = torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA])
                    self.prof.start()
                out = step(st, inp)
                self.calls += 1
                if self.calls == self.guard:
                    torch.cuda.set_sync_debug_mode(0)
                if self.start is not None and self.calls == self.start \
                        + self.n:
                    torch.cuda.synchronize()
                    self.prof.stop()
                    self.kernels = [
                        e for e in self.prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA]
                return out
            return watched

        SIM.make_step = make_step
        return self

    def __exit__(self, *exc):
        SIM.make_step = self.orig
        torch.cuda.set_sync_debug_mode(0)
        return False


def sim_golden_phase():
    """The seed golden on the card: pr and dr at r = 6000, 9 schemes x 3
    nets, one simulate_lattice call each, every metric within rtol 1e-5,
    atol 1e-6 (read as tests/test_movement_plane.py:49-65 reads it)."""
    golden = json.loads(GOLDEN.read_text())
    names, r = golden["schemes"], golden["r"]
    nets = _sim_nets(golden["net_pairs"])
    worst, secs, cells = 0.0, {}, 0
    _zero_launches()
    for wl in ("pr", "dr"):
        rec = golden["workloads"][wl]
        tr = generate_trace(WORKLOADS[wl], r, seed=rec["seed"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = SIM.simulate_lattice([SCHEMES[s] for s in names], SimConfig(),
                                   tr, nets, rec["comp_ratio"], device=DEV)
        secs[wl] = time.perf_counter() - t0
        for i, s in enumerate(names):
            for j in range(len(nets)):
                want = rec["schemes"][s][j]
                if set(res[i][j]) != set(want):
                    raise AssertionError(f"{wl}/{s}: metric keys differ")
                for key, new in res[i][j].items():
                    old = want[key]
                    np.testing.assert_allclose(
                        new, old, rtol=1e-5, atol=1e-6,
                        err_msg=f"{wl}/{s}/net{j}/{key}")
                    if new != old:
                        worst = max(worst, abs(new - old) / abs(old))
                cells += 1
    launches = _launches()
    if any(launches.values()):
        raise AssertionError(f"the simulator launched a kernel: {launches}")
    phase("sim_golden", workloads="pr,dr", schemes=len(names),
          nets=len(nets), requests=r, cells=cells, max_rel_err=worst, seconds_pr=f"{secs['pr']:.3f}",
          seconds_dr=f"{secs['dr']:.3f}",
          host_ms_per_request=f"{1e3 * secs['pr'] / r:.3f},"
          f"{1e3 * secs['dr'] / r:.3f}", hand_kernel_launches=0)


def _one_bin_apart(a, b, cfg):
    """Percentiles equal, or the midpoints of adjacent histogram bins (a
    sample within an ulp of a bin edge can bin differently when `log`
    rounds differently on the two devices)."""
    if a == b:
        return True
    step = math.log(cfg.lat_hi / cfg.lat_lo) / cfg.bins
    return a > 0 and b > 0 and abs(abs(math.log(a / b)) - step) < 1e-3 * step


def sim_axes_phase():
    """Every lattice axis on the card against the port on the CPU:
    daemon, daemon-adaptive, bp, remote x 2 nets under a `burst` link
    schedule x active C in (1, 2, 4) at num_cu = 4, num_mc = 2 x the 4
    policies, telemetry "histogram", r = 1200. Counts exact, clocks and
    metrics bit-equal or within the golden tolerance, percentiles equal
    or one bin apart. Then two-endpoint byte conservation on the card's
    final states at C = 1 and 4, whose every leaf equals the CPU's."""
    w = WORKLOADS["pr"]
    tr = generate_trace(w, AXES_R, seed=1)
    horizon = float(np.sum(tr.gap)) * 2.0
    cfg = SimConfig(num_cu=4, num_mc=2)
    sched = make_link_schedule("burst", horizon, cfg.num_mc)
    nets = _sim_nets(((100.0, 4.0), (400.0, 8.0)), num_mc=cfg.num_mc,
                     schedule=sched)
    tel = TelemetryConfig(level="histogram")
    kw = dict(active_cus=(1, 2, 4), policies=POLICIES, telemetry_cfg=tel)
    schemes = [SCHEMES[s] for s in AXES_SCHEMES]
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = SIM.simulate_lattice(schemes, cfg, tr, nets, w.comp_ratio,
                                device=DEV, **kw)
    secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = SIM.simulate_lattice(schemes, cfg, tr, nets, w.comp_ratio,
                               device="cpu", **kw)
    cpu_secs = time.perf_counter() - t0
    counts = ("pages_moved", "lines_moved", "page_drops")
    cells = equal = pct_moved = 0
    worst = 0.0
    for i, s in enumerate(AXES_SCHEMES):
        for j in range(len(nets)):
            for c in range(3):
                for p, pol in enumerate(POLICIES):
                    a, b = card[i][j][c][p], cpu[i][j][c][p]
                    where = f"{s}/net{j}/c{c}/{pol}"
                    if set(a) != set(b) or "p99_access_ns" not in a:
                        raise AssertionError(f"{where}: metric keys")
                    cells += 1
                    equal += a == b
                    for key, v in b.items():
                        if key in counts:
                            if a[key] != v:
                                raise AssertionError(f"{where}/{key}")
                        elif key.startswith("p") and key.endswith(
                                "_access_ns"):
                            if not _one_bin_apart(a[key], v, tel):
                                raise AssertionError(f"{where}/{key}")
                            pct_moved += a[key] != v
                        else:
                            np.testing.assert_allclose(
                                a[key], v, rtol=1e-5, atol=1e-6,
                                err_msg=f"{where}/{key}")
                            if a[key] != v:
                                worst = max(worst, abs(a[key] - v) / abs(v))
    # two-endpoint byte conservation on the final states
    ledgers = []
    for c in (1, 4):
        fin = SIM.run_trace(SCHEMES["daemon-adaptive"], cfg, tr, nets[0],
                            w.comp_ratio, active_cu=c, policy="rrip",
                            telemetry_cfg=tel, device=DEV)
        ref = SIM.run_trace(SCHEMES["daemon-adaptive"], cfg, tr, nets[0],
                            w.comp_ratio, active_cu=c, policy="rrip",
                            telemetry_cfg=tel, device="cpu")
        compare_states(fin, ref, f"run_trace C={c}")
        total = float(fin.stats["net_bytes"])
        module = float(FAB.total_bytes(fin.net))
        unit = float(CP.unit_bytes(fin.nic).sum())
        if not (total > 0 and abs(module - total) <= 1e-5 * total):
            raise AssertionError(f"C={c}: module bytes {module} != {total}")
        if c > 1 and abs(unit - total) > 1e-5 * total:
            raise AssertionError(f"C={c}: NIC bytes {unit} != {total}")
        if c == 1 and unit != 0.0:
            raise AssertionError("C=1: the NIC bank carried bytes")
        ledgers.append(f"C{c}:{total:.0f}/{module:.0f}/{unit:.0f}")
    launches = _launches()
    if any(launches.values()):
        raise AssertionError(f"the simulator launched a kernel: {launches}")
    phase("sim_axes", cells=cells, lanes=cells, requests=AXES_R,
          card_equals_cpu_cells=equal, max_rel_err=worst,
          percentiles_one_bin_apart=pct_moved,
          seconds=f"{secs:.3f}", cpu_seconds=f"{cpu_secs:.3f}",
          host_ms_per_request=f"{1e3 * secs / AXES_R:.3f}",
          bytes_stats_module_nic=",".join(ledgers),
          run_trace_card_equals_cpu=True, hand_kernel_launches=0)


def sim_fig8_phase():
    """The paper's fig-8 lattice: PAPER_FIG8 x the 6 NETWORK_GRID nets on
    pr at r = FIG8_R. The first 200 requests run under sync-debug mode
    "error"; requests 200-249 under torch.profiler. Prints the
    simulator's speed on the card and the simulated DaeMon/Remote
    speedup geomean over the nets (the simulator's output, not a card
    speed)."""
    w = WORKLOADS["pr"]
    tr = generate_trace(w, FIG8_R, seed=1)
    nets = _sim_nets(FIG8_NETS)
    schemes = [SCHEMES[s] for s in PAPER_FIG8]
    _zero_launches()
    with StepWatch(guard=SYNC_GUARD, start=SYNC_GUARD, n=PROFILED) as watch:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = SIM.simulate_lattice(schemes, SimConfig(), tr, nets,
                                   w.comp_ratio, device=DEV)
        secs = time.perf_counter() - t0
    if watch.calls != FIG8_R:
        raise AssertionError(f"{watch.calls} steps for {FIG8_R} requests")
    launches = _launches()
    if any(launches.values()):
        raise AssertionError(f"the simulator launched a kernel: {launches}")
    for i, s in enumerate(PAPER_FIG8):
        for j in range(len(nets)):
            cell = res[i][j]
            if not all(math.isfinite(v) for v in cell.values()):
                raise AssertionError(f"{s}/net{j}: non-finite metric")
            if not (cell["total_time_ns"] > 0 and
                    0.0 <= cell["hit_ratio"] <= 1.0):
                raise AssertionError(f"{s}/net{j}: {cell}")
    t = {s: [res[i][j]["total_time_ns"] for j in range(len(nets))]
         for i, s in enumerate(PAPER_FIG8)}
    speedup = float(np.exp(np.mean(np.log(
        np.asarray(t["remote"]) / np.asarray(t["daemon"])))))
    if not speedup > 1.0:
        raise AssertionError(f"DaeMon no faster than Remote: {speedup}")
    host_ms = 1e3 * secs / FIG8_R
    dev_ms = sum(e.time_range.elapsed_us() for e in watch.kernels) / 1e3
    kernels = len(watch.kernels)
    phase("sim_fig8", workload="pr", schemes=len(schemes), nets=len(nets),
          lanes=len(schemes) * len(nets), requests=FIG8_R,
          seconds=f"{secs:.3f}", requests_per_s=f"{FIG8_R / secs:.2f}",
          host_ms_per_request=f"{host_ms:.3f}",
          sync_debug_requests=SYNC_GUARD, profiled_requests=PROFILED,
          kernels_per_request=(f"{kernels / PROFILED:.1f}" if kernels
                               else "not measured"),
          device_ms_per_request=(f"{dev_ms / PROFILED:.4f}" if kernels
                                 else "not measured"),
          device_busy_share=(f"{dev_ms / PROFILED / host_ms:.4f}"
                             if kernels else "not measured"),
          daemon_vs_remote_speedup_geomean=f"{speedup:.4f}",
          hand_kernel_launches=0)


def main():
    name, smi = device_phase()
    build_phase()
    gen = torch.Generator(device=DEV).manual_seed(0)
    k2 = gather_phase(gen)
    k1_err = residency_phase(gen)
    drive_phase()
    drive_replicated_phase()
    drive_single_phase()
    chain_k2 = chain_phase()
    reference_phase()
    replicated_reference_phase()
    telemetry_phase()
    cfg, params, prompts, counts = serve_phase()
    k1_inputs, _, kcache = split_phase(cfg, params, prompts)
    k1 = k1_phase(k1_inputs, gen, k1_err)
    del k1_inputs
    prefill_phase(cfg, params, prompts)
    rep_counts, rep_inputs = serve_replicated_phase(cfg, params, prompts)
    t = k1_timing(rep_inputs, "fused_residency_step_replicated_shape")
    del rep_inputs
    k1["max_abs_err"] = max(k1["max_abs_err"], t.pop("max_abs_err"))
    k1["replicated_shape"] = {"sequences": REP_C * SERVE_B, **t}
    replicated_split_phase(cfg, params, prompts)
    k1["launches"] = counts["fused_residency_step"]
    k2["launches"] = counts["paged_gather"]
    k1["launches_by_path"] = {
        "serve_batch_paged": counts["fused_residency_step"],
        "serve_replicated": rep_counts["fused_residency_step"]}
    k2["launches_by_path"] = {
        "serve_batch_paged": counts["paged_gather"],
        "serve_replicated": rep_counts["paged_gather"],
        "store_chain": chain_k2}
    del params                       # free the serve phases before training
    gc.collect()
    torch.cuda.empty_cache()
    k3q, k3d = qdq_phase(gen)
    k4c, k4d = bdi_phase(gen, kcache)
    train_reference_phase()
    tcfg, params, opt_state, step_fn, k3_counts = train_phase()
    k3q["launches"], k3d["launches"] = k3_counts
    train_split_phase(tcfg, params, opt_state, step_fn)
    del params, opt_state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    sim_golden_phase()
    sim_axes_phase()
    sim_fig8_phase()
    print(smi)
    print(json.dumps({"kernels": [k1, k2, k3q, k3d, k4c, k4d]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
