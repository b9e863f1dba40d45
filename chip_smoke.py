"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from src/repro_torch/csrc (nvcc, sm_90a,
into build/repro_torch/), holds each kernel bit for bit against its
plain PyTorch version, drives the store through every stepper (batched,
replicated at C = 1, 2, 3, single-sequence, and the chain comparator),
the card against the CPU or the fused path, and through the mesh plane's
`step_replicated_sharded` on a world-1 NCCL group, bit-equal to the
unsharded step (`[store_drive_mesh]`), then serves: reduced
qwen3-1.7b card against CPU (paged, replicated, and at telemetry level
"trace" with a link-health monitor), full-width qwen3-1.7b through
`serve_batch_paged` and through `serve_replicated` (2 replicas x 8
tenants) with the DaeMon KV store in the loop, the latter again through
`serve_replicated(mesh=)` on a world-1 NCCL mesh, tokens and ledger
bit-equal, the fabric merge timed on its own (`[serve_replicated_mesh]`),
and one-pass `prefill` against the token-by-token decode. The other
model families follow: reduced olmoe-1b-7b, zamba2-2.7b (on an 8-token
ring KV cache), xlstm-125m, whisper-base and internvl2-26b card against
CPU, the two
frontend archs also through a one-pass prefill with their stub's input
(`[families_reference]`); then each of those, and qwen3-moe-30b-a3b last
(61 GB of weights), at full width through `serve_batch_paged`
(`[serve_olmoe]`, `[serve_zamba2]`, `[serve_xlstm]`, `[serve_whisper]`,
`[serve_internvl2]`, `[serve_qwen3moe]`: bf16, B = 8, a store of the
model's own KV geometry, so K1 and K2 run at 16, 24, 32, 64 and 80 KB
page rows and are held bit for bit there), with a full-width one-pass
prefill of whisper's 1500 audio frames and internvl2's 256 patches
(`[prefill_frontends]`). Then it holds `layers.dot` of bf16 operands
at qwen3-1.7b's MLP shape to the f32 sum of the exact products
(`[dot_f32_accum]`) and the two tensor-parallel model options on a
reduced forward to the option off and to the CPU (`[model_options]`),
and trains: the card against the CPU on
reduced qwen3-1.7b, and four steps at full width with the
int8-compressed pod-gradient sync on the block-int8 kernels. Across
ranks, each on a world-1 NCCL process group of the card: one reduced
step with the pod sync all-gathered over the `pod` group, bit-equal to
the step without a group (`[train_reference_dist]`); the full-width
train through `run_with_restarts` and an async `CheckpointManager`, a
failure injected before step 3 and step 2 restored, ending in
`[train]`'s state leaf by leaf (`[train_restart]`, 24.4 GB written and
read back under build/); GPipe's `pipeline_forward` over the `stage`
group with qwen3-1.7b's 28 bf16 blocks as the stage, bit-equal to the
blocks in turn, forward and, through its backward, every parameter
gradient (`[pipeline]`); and one full-width olmoe-1b-7b MoE layer
through `moe_ep` over the `model` group against `moe_dense`, forward and
backward (`[moe_ep]`). Then the dry run (`repro_torch.launch`):
`[dryrun_vs_card]` traces qwen3-1.7b's decode_step (B = 8, a 32768-token
cache) and `[train]`'s step on fake CUDA tensors with `op_analysis` and
runs both for real under the same counter (the same op stream: FLOPs
from shapes equal; from the card's allocator: argument bytes within its
rounding, peak within 10 %; K3's traced calls equal its launches; device
ms against the step's bound, max(FLOPs / 989.4 TFLOP/s, least bytes /
3.35 TB/s), the least bytes being each argument read once and what the
step writes written once); and `[examples]` runs
`repro_torch.examples.quickstart`, `serve_paged` and `train_100m` (20
steps, then resumed to 24). Then it runs the request-level simulator
(`repro_torch.sim`): the seed golden
(pr and dr, 9 schemes x 3 nets, r = 6000) held to
tests/golden/seed_movement_golden.json (`[sim_golden]`), while
`[dryrun_cells]` runs five cells of `launch.dryrun` at once beside it,
each a subprocess on fake CUDA tensors as a user on the card gets them
(qwen3-1.7b train_4k, prefill_32k and decode_32k on 16 x 16, train_4k
with the int8 pod sync on 2 x 16 x 16, olmoe-1b-7b decode_32k), every
one `ok` (no timed phase runs beside them); then every lattice
axis (schemes x link-profile nets x active compute units x policies,
telemetry on) on the card against the CPU with two-endpoint byte
conservation (`[sim_axes]`), the same lattice through
`simulate_lattice_sharded` on a world-1 NCCL mesh, bit-equal to
`[sim_axes]`' card result (`[mesh_lattice]`), and last the paper's
fig-8 lattice at r = 2000 with its first 200 requests under sync-debug
mode "error" and 50 under
torch.profiler (`[sim_fig8]`); the simulator reaches no hand kernel, and
each phase checks that none was launched. It checks every result and
imports nothing of JAX or of the reference package.

The store's kernels are also timed at the store benchmark's shapes (the
paged gather at L = 256 rows, with L2 warm and cold; the residency
transaction at B = 64, 256 x 16 slots, 16 in-flight lanes) and the
residency transaction at the replicated serve's last step (16
sequences); the store's request fold, held bit for bit to its plain
version with its inputs untouched, at the paged benchmark cell's shape
(B = 16, R = 4, one module) and at the replicated serve's (C = 2 x
B = 8, the NIC leg active) (`[schedule_fold_*]`).

Output: one line per phase; then the card's name and power limit as
nvidia-smi prints them; then one JSON line with each kernel's launches
on its path (serving for the store's kernels, per path in
`launches_by_path`, the family serve paths and the mesh paths included;
training for the quantizer, with the across-rank paths in its
`launches_by_path`;
its own phase for BDI, which no path reaches), its time
against its bound, the plain version's time and the library call's; and
last `{"ok": true, "device": {...}}`. Any failure raises and exits
non-zero before those lines. Without a CUDA device, or without the
repository around it, it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import hashlib
import json
import math
import os
import shutil
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

import torch.distributed as dist  # noqa: E402

from repro_torch.checkpoint import (CheckpointConfig,  # noqa: E402
                                    CheckpointManager)
from repro_torch.checkpoint import manager as CK  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ATTN  # noqa: E402
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
from repro_torch.kernels import schedule_fold as SF  # noqa: E402
from repro_torch.device import fake_mode  # noqa: E402
from repro_torch.launch import op_analysis as OA  # noqa: E402
from repro_torch.launch import specs as SPECS  # noqa: E402
from repro_torch.launch.mesh import (build_mesh,  # noqa: E402
                                     init_distributed, make_data_mesh,
                                     shutdown_distributed)
from repro_torch.models import model as MODEL  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models import xlstm as XL  # noqa: E402
from repro_torch.models.attention import decode_cross_attention  # noqa
from repro_torch.models.layers import dot, mlp, padded_vocab  # noqa
from repro_torch.models.model import (ModelOptions, decode_step,  # noqa
                                      init_decode_state, init_model, prefill)
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.runtime.fault import (LinkHealthMonitor,  # noqa: E402
                                       run_with_restarts)
from repro_torch.runtime import mesh_plane as MP  # noqa: E402
from repro_torch.runtime.mesh_rules import use_mesh  # noqa: E402
from repro_torch.runtime.pipeline import pipeline_forward  # noqa: E402
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


KERNELS = (PG.KERNEL, RF.KERNEL, SF.KERNEL) + QD.KERNELS + BDI.KERNELS


def build_phase():
    secs = _build.build_all(KERNELS)
    phase("build", seconds=f"{secs:.2f}", dir=_build.BUILD_DIR)
    logs = {k.source: k.build_log for k in KERNELS}
    for source, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  {source}: {line.strip()}")


# ---------------------------------------------------------------- phase 3
def gather_case(gen, pool_rows, rows, row=(16, 8, 128)):
    """A bf16 remote pool of `pool_rows` rows of shape `row` (by default
    qwen3-1.7b's (16, 8, 128) pages, 32 KB each), `rows` random indices
    and a random half mask."""
    pool = torch.randn((pool_rows,) + row, generator=gen, device=DEV
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


def gather_check(pool, idx, mask):
    """K2 bit for bit against its plain version on `pool`, one pool and
    the K/V pair (the V pool is `pool` reversed), masked and unmasked,
    with `idx` and with indices past both ends. Returns max |err|."""
    pool_rows, rows = pool.shape[0], idx.shape[0]
    pool_v = torch.flip(pool, (0,))
    edge = idx.clone()
    edge[:3] = torch.tensor([-1, -pool_rows - 5, pool_rows + 7])
    err = 0.0
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
                                     f"(mask={m is not None}, row "
                                     f"{tuple(pool.shape[1:])})")
            err = max(err, max_abs_err([got, got_k, got_v],
                                       [want, want, want_v]))
    return err


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
        errs.append(gather_check(pool, idx, mask))
        t = gather_timing(pool, idx)
        if rows == 256:
            t.update(gather_cold(gen, pool, rows))
        phase("paged_gather", exact=True, rows=rows, pool_rows=pool_rows,
              row_bytes=pool[0].numel() * pool.element_size(), **t)
        times[rows] = t
        del pool
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
    SF.KERNEL.launches = 0
    t0 = time.perf_counter()
    tokens, led = serve_batch_paged(params, cfg, prompts, scfg, store,
                                    SERVE_PAGED)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {"paged_gather": PG.KERNEL.launches,
              "fused_residency_step": RF.KERNEL.launches,
              "schedule_fold": SF.KERNEL.launches}
    peak = torch.cuda.max_memory_allocated()
    steps = SERVE_PROMPT + SERVE_NEW
    r = SERVE_PAGED.window_pages
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {counts}")
    if counts["schedule_fold"] != steps:
        raise AssertionError(f"{counts['schedule_fold']} folds for {steps} "
                             "store steps")
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


def split_phase(cfg, params, prompts, store=None, new=SERVE_NEW,
                arch=None):
    """ms per decode step split into model decode and the store's parts
    (host clock, each part ended by a synchronize), over the same decode
    schedule as serve_batch_paged with `store` (default the serve cell's)
    and `new` tokens after the prompt; returns the residency kernel's
    inputs at the last step, for timing it at the main path's shapes, the
    split, and the decode state. With `arch`, the line names the model
    first."""
    opt = ModelOptions()
    store = store or DS.KVStoreConfig(**SERVE_STORE)
    b, p = prompts.shape
    state = init_decode_state(cfg, b, p + new, opt, device=DEV)
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
    for i in range(p + new):
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
        if i == p + new - 1:
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
    phase("step_split_ms", **({} if arch is None else {"arch": arch}),
          **{k: f"{v:.3f}" for k, v in ms.items()},
          store_total=f"{ms['transact'] + ms['remote_fetch'] + ms['schedule']:.3f}")
    return k1_inputs, ms, state


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
            i1, w1 = compare_states(st_g, st_c, f"C={c} step {step}",
                                    exact=True)
            i2, w2 = compare_states(out_g, out_c, f"C={c} step {step} out",
                                    exact=True)
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


def drive_mesh_phase():
    """DRIVE_STEPS of step_replicated_sharded on a world-1 NCCL mesh at
    C = 2, B = 4, against step_fetch_replicated on the card from the
    same requests: every state leaf and output bit-equal every step (the
    merge at world 1 is base + (local - base), one all_gather), and the
    gathered ledger equal. K1 and K2 launches are counted over the
    sharded steps only. Returns those counts."""
    cfg = DS.KVStoreConfig(**DRIVE_STORE)
    c, b = 2, 4
    rng = np.random.default_rng(5)
    remote = drive_remote(rng).to(DEV)
    reqs = [tuple(torch.from_numpy(x).to(DEV) for x in
                  drive_requests(rng, (c, b, DRIVE_R)))
            for _ in range(DRIVE_STEPS)]
    counts = {"paged_gather": 0, "fused_residency_step": 0,
              "schedule_fold": 0}
    with nccl_world():
        mesh = make_data_mesh()
        st = MP.shard_replicated_state(
            DS.init_kv_store_replicated(cfg, c, b, device=DEV), mesh)
        ref = DS.init_kv_store_replicated(cfg, c, b, device=DEV)
        for step, (need, offs, wr) in enumerate(reqs):
            ref, *out_r = DS.step_fetch_replicated(ref, cfg, remote, remote,
                                                   need, offs, wr)
            PG.KERNEL.launches = 0
            RF.KERNEL.launches = 0
            SF.KERNEL.launches = 0
            st, *out_s = MP.step_replicated_sharded(st, cfg, mesh, remote,
                                                    remote, need, offs, wr)
            counts["paged_gather"] += PG.KERNEL.launches
            counts["fused_residency_step"] += RF.KERNEL.launches
            counts["schedule_fold"] += SF.KERNEL.launches
            compare_states(st, ref, f"mesh step {step}", exact=True)
            compare_states(out_s, out_r, f"mesh step {step} out",
                           exact=True)
        led = DS.ledger(MP.gather_replicated_state(st, mesh))
    if led != DS.ledger(ref):
        raise AssertionError("the sharded ledger differs from the "
                             "unsharded one")
    if min(counts.values()) != DRIVE_STEPS:
        raise AssertionError(f"launches {counts}, expected {DRIVE_STEPS}")
    phase("store_drive_mesh", steps=DRIVE_STEPS, replicas=c, batch=b,
          backend="nccl", world=1, bit_equal=True, launches=counts,
          wire_bytes=led["wire_bytes"], dirty_evicts=led["dirty_evicts"])
    return counts


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
        i1, w1 = compare_states(st_g, st_c, f"single step {step}",
                                exact=True)
        i2, w2 = compare_states(out_g, out_c, f"single step {step} out",
                                exact=True)
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


# ------------------------------------------- the store's request fold
FOLD_STORE = dict(num_local_pages=4, pool_ways=2, page_tokens=16,
                  kv_heads=8, head_dim=128)   # the paged benchmark cell's
FOLD_STEPS = 40


class CaptureFold:
    """Wraps DS._schedule while active: the inputs of its latest call
    are cloned before the call (with the call's static choices), for
    holding the fold's kernel to its plain version and timing both."""

    def __enter__(self):
        self._orig = DS._schedule
        self.inputs = None

        def wrapped(eng, fab, cfg, need, offs, hit, clock, nic=None,
                    cus=None, active=None):
            self.inputs = CP.tree_map(lambda t: t.clone(), (
                eng, fab, need, offs, hit, clock)) + (
                DS._fold_statics(cfg),) + CP.tree_map(
                lambda t: t.clone(), (nic, cus, active))
            return self._orig(eng, fab, cfg, need, offs, hit, clock, nic=nic,
                              cus=cus, active=active)
        DS._schedule = wrapped
        return self

    def __exit__(self, *exc):
        DS._schedule = self._orig


def fold_inputs(replicas, batch):
    """The fold's inputs at the last of FOLD_STEPS steps of the serve
    loops' request window (every sequence at one position, from 40 on)
    on a store of the paged cell's geometry: `batch` sequences, or
    `replicas` x `batch` with the NIC bank."""
    store = DS.KVStoreConfig(**FOLD_STORE)
    n = batch * (replicas or 1)
    pages = SERVE_PAGED.pages_per_seq
    remote = torch.zeros((n * pages, 16, 8, 128), dtype=torch.bfloat16,
                         device=DEV)
    seq_ids = torch.arange(n, dtype=torch.int32, device=DEV)
    if replicas is None:
        st = DS.init_kv_store_batch(store, batch, device=DEV)
    else:
        st = DS.init_kv_store_replicated(store, replicas, batch, device=DEV)
    with CaptureFold() as cap:
        for i in range(FOLD_STEPS):
            need, offs, wr = paged_request_window(
                torch.full((n,), 40 + i, dtype=torch.int32, device=DEV),
                seq_ids, store.page_tokens, SERVE_PAGED.window_pages, pages)
            if replicas is None:
                st, *_ = DS.step_fetch_batch(st, store, remote, remote, need,
                                             offs, wr)
            else:
                shape = (replicas, batch, -1)
                st, *_ = DS.step_fetch_replicated(
                    st, store, remote, remote, need.reshape(shape),
                    offs.reshape(shape), wr.reshape(shape))
    return cap.inputs


def fold_bound_bytes(inputs):
    """Bytes the fold must move: the engine rows, both banks, the
    requests and the outputs, each read once and written once."""
    eng, fab, need, _, _, _, _, nic, _, _ = inputs
    b, r = need.shape
    row = sum(t[0].numel() * t.element_size() for t in eng)
    banks = sum(9 * bank.line_busy.numel() * 4 for bank in (fab, nic)
                if bank is not None)
    m = fab.line_busy.numel()
    return 2 * (b * row + banks) + b * r * (4 + 4 + 1) + b * r * 6 \
        + 2 * b * m * 4


def fold_check(inputs, what):
    """The kernel against the plain fold on the card, on clones of
    `inputs`: every output bit-equal and the inputs untouched."""
    eng, fab, need, offs, hit, clock, st, nic, cus, active = inputs
    args = (eng, fab, need, offs, hit, clock, st)
    tensors = tree_leaves(inputs[:6] + inputs[7:])
    before = [t.clone() for t in tensors]
    got = SF.schedule_fold(*args, nic=nic, cus=cus, active=active)
    want = REF.schedule_fold(*args, nic=nic, cus=cus, active=active)
    for i, (a, c) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        a = a.view(torch.int32) if a.dtype == torch.float32 else a
        c = c.view(torch.int32) if c.dtype == torch.float32 else c
        if not torch.equal(a, c):
            raise AssertionError(f"{what}: fold output leaf {i} differs")
    for i, (a, c) in enumerate(zip(tensors, before)):
        if not torch.equal(a, c):
            raise AssertionError(f"{what}: fold wrote input leaf {i}")


def fold_timing(inputs, title):
    """The fold's kernel checked and timed on `inputs` against its plain
    version; prints one phase line and returns its numbers."""
    fold_check(inputs, title)
    eng, fab, need, offs, hit, clock, st, nic, cus, active = inputs
    args = (eng, fab, need, offs, hit, clock, st)

    def kernel():
        return SF.schedule_fold(*args, nic=nic, cus=cus, active=active)

    def plain():
        return REF.schedule_fold(*args, nic=nic, cus=cus, active=active)

    nbytes = fold_bound_bytes(inputs)
    t = {
        "ms": device_ms(kernel),
        "plain_ms": device_ms(plain, iters=2, replays=2),
        "bytes_bound_ms": nbytes / HBM_BYTES_PER_MS,
        "call_ms": call_ms(kernel),
        "plain_call_ms": call_ms(plain, iters=3, warmup=1),
    }
    phase(title, sequences=need.shape[0], requests=need.numel(),
          modules=fab.line_busy.numel(),
          nic_units=0 if nic is None else nic.line_busy.numel(),
          exact=True, state_bytes=nbytes, **t)
    return t


def schedule_fold_phase():
    """The fold's kernel bit for bit against its plain version and timed
    at the paged cell's shape (B = 16, R = 4, one module) and at the
    replicated serve's (C = 2 x B = 8, the NIC leg active). Returns its
    record for the kernel line."""
    t = fold_timing(fold_inputs(None, 16), "schedule_fold_paged_shape")
    rep = fold_timing(fold_inputs(REP_C, SERVE_B),
                      "schedule_fold_replicated_shape")
    return {
        "name": "schedule_fold", "route": "cuda",
        "source": "src/repro_torch/csrc/schedule_fold.cu",
        "replaces": "src/repro/core/daemon_store.py:678 (lax.scan)",
        "max_abs_err": 0.0, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "library_ms": None, "bound_ms": t["bytes_bound_ms"],
        "bound_by": "the chain of dependent requests (bytes shown)",
        "call_ms": t["call_ms"], "plain_call_ms": t["plain_call_ms"],
        "replicated_shape": rep,
    }


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
        SF.KERNEL.launches = 0
        t0 = time.perf_counter()
        tokens, led = serve_replicated(params, cfg, prompts, scfg, store,
                                       REP_C, SERVE_PAGED)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {"paged_gather": PG.KERNEL.launches,
                  "fused_residency_step": RF.KERNEL.launches,
                  "schedule_fold": SF.KERNEL.launches}
    peak = torch.cuda.max_memory_allocated()
    r = SERVE_PAGED.window_pages
    if set(counts.values()) != {steps}:
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
    return counts, cap.inputs, (tokens, led, secs)


class MergeTimer:
    """Times every `fabric.reduce_deltas` the mesh plane calls (host
    clock, a synchronize before and after): the merge's collective on
    its own."""

    def __enter__(self):
        self._orig = FAB.reduce_deltas
        self.secs = []

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self._orig(*args, **kw)
            torch.cuda.synchronize()
            self.secs.append(time.perf_counter() - t0)
            return out
        FAB.reduce_deltas = timed
        return self

    def __exit__(self, *exc):
        FAB.reduce_deltas = self._orig


def serve_replicated_mesh_phase(cfg, params, prompts, rep_result):
    """[serve_replicated]'s cell through `serve_replicated(mesh=)` on a
    world-1 NCCL mesh: full-width qwen3-1.7b, C = 2 x B = 8, 32 + 32
    tokens. Tokens and ledger bit-equal to [serve_replicated]'s; one K1
    and one K2 launch per step; ms per step (NCCL's communicator set up
    before the clock starts), and the fabric merge (one all_gather per
    step) timed on its own. Returns the launch counts."""
    want_tokens, want_led, want_secs = rep_result
    store = DS.KVStoreConfig(**SERVE_STORE)
    scfg = ServeConfig(max_new_tokens=SERVE_NEW)
    steps = SERVE_PROMPT + SERVE_NEW
    gc.collect()
    torch.cuda.empty_cache()
    with nccl_world(), MergeTimer() as merge:
        mesh = make_data_mesh()
        MP.gather_rows(torch.zeros(1, device=DEV), mesh)  # NCCL's set-up
        torch.cuda.synchronize()
        PG.KERNEL.launches = 0
        RF.KERNEL.launches = 0
        SF.KERNEL.launches = 0
        t0 = time.perf_counter()
        tokens, led = serve_replicated(params, cfg, prompts, scfg, store,
                                       REP_C, SERVE_PAGED, mesh=mesh)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {"paged_gather": PG.KERNEL.launches,
                  "fused_residency_step": RF.KERNEL.launches,
                  "schedule_fold": SF.KERNEL.launches}
    if not torch.equal(tokens, want_tokens):
        raise AssertionError("mesh tokens differ from [serve_replicated]'s")
    if led != want_led:
        raise AssertionError("mesh ledger differs from [serve_replicated]'s")
    if set(counts.values()) != {steps}:
        raise AssertionError(f"launches {counts}, expected {steps} each")
    if len(merge.secs) != steps:
        raise AssertionError(f"{len(merge.secs)} merges for {steps} steps")
    merge_ms = 1e3 * float(np.mean(merge.secs))
    step_ms = 1e3 * secs / steps
    phase("serve_replicated_mesh", model="qwen3-1.7b", replicas=REP_C,
          batch=SERVE_B, backend="nccl", world=1, prompt=SERVE_PROMPT,
          new=SERVE_NEW, tokens_equal=True, ledger_equal=True,
          seconds=f"{secs:.3f}", ms_per_step=f"{step_ms:.3f}",
          unsharded_ms_per_step=f"{1e3 * want_secs / steps:.3f}",
          merge_ms_per_step=f"{merge_ms:.4f}",
          merge_max_ms=f"{1e3 * max(merge.secs):.3f}",
          merge_share=f"{merge_ms / step_ms:.5f}", launches=counts)
    return counts


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
           "bound_ms": bytes_q / HBM_BYTES_PER_MS,
           "call_ms": call_ms(lambda: QD.quantize_block_int8(x))}
    k3d = {"name": "dequantize_block_int8", **common,
           "max_abs_err": max(ed0, ed1),
           "replaces": "src/repro/kernels/qdq_int8.py:52",
           "ms": device_ms(lambda: QD.dequantize_block_int8(q, s)),
           "plain_ms": device_ms(lambda: REF.dequantize_block_int8(q, s),
                                 iters=3, replays=3),
           # int8 * f32 promotes to f32 and multiplies in one pass
           "library_ms": device_ms(lambda: q * s),
           "bound_ms": bytes_d / HBM_BYTES_PER_MS,
           "call_ms": call_ms(lambda: QD.dequantize_block_int8(q, s))}
    bf16_ms = device_ms(lambda: QD.dequantize_block_int8(q, s, torch.bfloat16))
    phase("qdq_int8", exact=True,
          cases=f"13x256(zero,ties,nan,inf),{n}x{b}",
          out_dtypes="f32,bf16", quant_ms=k3q["ms"],
          quant_plain_ms=k3q["plain_ms"], quant_bound_ms=k3q["bound_ms"],
          dequant_ms=k3d["ms"], dequant_plain_ms=k3d["plain_ms"],
          dequant_library_ms=k3d["library_ms"],
          dequant_bound_ms=k3d["bound_ms"], dequant_bf16_ms=bf16_ms,
          quant_call_ms=k3q["call_ms"], dequant_call_ms=k3d["call_ms"],
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
           "bound_ms": bytes_c / HBM_BYTES_PER_MS,
           "call_ms": call_ms(lambda: BDI.bdi_compress(x))}
    k4d = {"name": "bdi_decompress", **common,
           "replaces": "src/repro/kernels/bdi.py:58", "launches": launches[1],
           "max_abs_err": max(ed0, ed1, ed2),
           "ms": device_ms(lambda: BDI.bdi_decompress(base, deltas, okx, x)),
           "plain_ms": device_ms(lambda: REF.bdi_decompress(base, deltas,
                                                            okx, x),
                                 iters=3, replays=3),
           "bound_ms": bytes_d / HBM_BYTES_PER_MS,
           "call_ms": call_ms(lambda: BDI.bdi_decompress(base, deltas, okx,
                                                         x))}
    phase("bdi", exact=True, rows=f"48+{kc.shape[0]}(kcache)+{n}",
          kcache_ok_rows=int((kc_ok != 0).sum()), plane_raw_rows=n_raw,
          launches=launches, compress_ms=k4c["ms"],
          compress_plain_ms=k4c["plain_ms"],
          compress_bound_ms=k4c["bound_ms"], decompress_ms=k4d["ms"],
          decompress_plain_ms=k4d["plain_ms"],
          decompress_bound_ms=k4d["bound_ms"],
          compress_call_ms=k4c["call_ms"], decompress_call_ms=k4d["call_ms"])
    return k4c, k4d


# ------------------------------------------- phase 7b: f32 accumulation
DOT_SPEC = "bsd,df->bsf"
DOT_SHAPES = {"decode": (8, 1), "train": (1, 1024)}   # qwen3-1.7b's (B, S)


def dot_phase(gen):
    """`layers.dot` of bf16 operands at qwen3-1.7b's MLP up-projection
    (d 2048 x d_ff 6144; B·S = 8 as at decode, and 1024 as in a train
    microbatch), with f32 matmuls at torch's default precision: the f32
    sum of the exact products, bit-equal to the product of the widened
    operands and within f32 accumulation error (d * 2^-24 * sum|a||b|)
    of the f64 product, unlike the bf16-rounded GEMM output it replaces.
    Times both on the card (CUDA graph)."""
    cfg = get_config("qwen3-1.7b")
    d, f = cfg.d_model, cfg.d_ff
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("f32 matmuls are not at torch's default "
                             "precision")
    w = (torch.randn((d, f), generator=gen, device=DEV)
         / math.sqrt(d)).to(torch.bfloat16)
    out = {}
    for name, (b, sq) in DOT_SHAPES.items():
        x = torch.randn((b, sq, d), generator=gen,
                        device=DEV).to(torch.bfloat16)
        got = dot(x, w, DOT_SPEC)
        widened = torch.einsum(DOT_SPEC, x.float(), w.float())
        exact = torch.einsum(DOT_SPEC, x.double(), w.double())
        scale = torch.einsum(DOT_SPEC, x.double().abs(), w.double().abs())
        err = (got.double() - exact).abs()
        rounded = torch.einsum(DOT_SPEC, x, w).float()   # before the repair
        if got.dtype != torch.float32 or not torch.equal(got, widened):
            raise AssertionError(f"{name}: dot is not the widened product")
        if not bool((err <= d * 2.0 ** -24 * scale).all()):
            raise AssertionError(f"{name}: dot outside f32 accumulation "
                                 "error of the f64 product")
        out[name] = dict(
            max_err_vs_f64=float(err.max()),
            max_diff_vs_bf16_rounded=float((got - rounded).abs().max()),
            bf16_rounded_max_err_vs_f64=float(
                (rounded.double() - exact).abs().max()),
            ms=device_ms(lambda: dot(x, w, DOT_SPEC)),
            bf16_rounded_ms=device_ms(
                lambda: torch.einsum(DOT_SPEC, x, w).float()))
    phase("dot_f32_accum", model="qwen3-1.7b", shape=f"{d}x{f}",
          float32_matmul_precision=torch.get_float32_matmul_precision(),
          **{f"{n}_{k}": (f"{v:.6g}" if isinstance(v, float) else v)
             for n, r in out.items() for k, v in r.items()})


OPTION_TOL = 2.0 ** -8           # of the largest logit: one bf16 ulp of it


def model_options_phase():
    """Reduced qwen3-1.7b (f32) forward on the card with each
    tensor-parallel option: `seq_shard_residual` bit-equal to the option
    off (the identity without a mesh); `tp_reduce_bf16`, whose
    row-parallel products are rounded to bf16, within one bf16 ulp of
    the largest logit of the option off and of the CPU's forward with
    the option on."""
    cfg = get_config("qwen3-1.7b").reduced()
    batch = synthetic_batch(cfg, ShapeConfig("t", 64, 4, "train"),
                            DataConfig(seed=0), 0, device="cpu")
    params = init_model(cfg, torch.Generator().manual_seed(0))
    logits = {}
    for where, dev in (("card", DEV), ("cpu", "cpu")):
        p, b = _to(params, dev), _to(batch, dev)
        for name in ("off", "tp_reduce_bf16", "seq_shard_residual"):
            kw = {} if name == "off" else {name: True}
            with torch.inference_mode():
                out, _ = MODEL.forward(p, cfg, b,
                                       ModelOptions(remat="none", **kw))
            logits[where, name] = out.cpu()
    off = logits["card", "off"]
    top = float(off.abs().max())
    bf16_vs_off = float((logits["card", "tp_reduce_bf16"] - off).abs().max())
    bf16_vs_cpu = float((logits["card", "tp_reduce_bf16"]
                         - logits["cpu", "tp_reduce_bf16"]).abs().max())
    if not torch.equal(logits["card", "seq_shard_residual"], off):
        raise AssertionError("seq_shard_residual changed the forward")
    if not 0 < bf16_vs_off <= OPTION_TOL * top or \
            bf16_vs_cpu > OPTION_TOL * top:
        raise AssertionError(f"tp_reduce_bf16: {bf16_vs_off}, {bf16_vs_cpu} "
                             f"against {OPTION_TOL * top}")
    phase("model_options", model="qwen3-1.7b-reduced f32",
          seq_shard_residual_bit_equal=True,
          tp_reduce_bf16_max_diff_vs_off=f"{bf16_vs_off:.6g}",
          tp_reduce_bf16_max_diff_vs_cpu=f"{bf16_vs_cpu:.6g}",
          tol=f"{OPTION_TOL * top:.6g}")


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
    sums = state_checksums({"params": params, "opt": opt_state})
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
          max_dequant_err_over_scale=f"{worst:.6f}",
          state_checksum=checksum_digest(sums))
    return tcfg, params, opt_state, step_fn, counts, sums


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


# ------------------------------------- phase 8b: across ranks, restarts
RESTART_SAVE_AT = 2                 # the checkpoint labels the next step
RESTART_FAIL_AT = 3                 # attempt 0 fails before this step


@contextlib.contextmanager
def nccl_world():
    """A world-1 NCCL process group on the card for one phase, its
    rendezvous file under build/."""
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="pg_", dir=ROOT / "build")
    try:
        dev = init_distributed(DEV, f"file://{tmp}/rendezvous")
        try:
            if dist.get_backend() != "nccl" or dev.type != "cuda":
                raise AssertionError(f"process group on {dist.get_backend()}"
                                     f" and {dev}, not NCCL on the card")
            yield
        finally:
            shutdown_distributed()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def state_checksums(tree):
    """{leaf name: (dtype, sum of its 32-bit words, position-weighted
    sum)} computed on the card: equal trees give equal sums, and any
    changed bit changes the first."""
    out = {}
    for name, t in CK._leaf_paths(tree):
        words = t.detach().contiguous().view(-1)
        words = (words.view(torch.int32) if words.element_size() == 4
                 else words.view(torch.int16)).to(torch.int64)
        weight = torch.arange(words.numel(), device=words.device) % 65521 + 1
        out[name] = (str(t.dtype), int(words.sum()),
                     int((words * weight).sum()))
        del words, weight
    return out


def checksum_digest(sums):
    return hashlib.sha256(json.dumps(sums, sort_keys=True).encode()
                          ).hexdigest()[:16]


def _tree_equal(a, b):
    la, lb = CK._leaf_paths(a), CK._leaf_paths(b)
    return [n for n, _ in la] == [n for n, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(la, lb))


def train_reference_dist_phase():
    """Reduced qwen3-1.7b (f32): one int8 step over 2 pods with the pod
    sync through a world-1 NCCL `pod` group (the int8 payloads and
    scales and the losses all-gathered) is bit-equal to the same step
    with no group, from the same params and batch."""
    cfg = get_config("qwen3-1.7b").reduced()
    opt = ModelOptions(remat="none")
    tcfg = TrainConfig(adamw=AdamWConfig(lr=3e-3), warmup_steps=0,
                       total_steps=10, dp_compress="int8", num_pods=2)
    batch = synthetic_batch(cfg, ShapeConfig("t", 64, 4, "train"),
                            DataConfig(seed=0), 0, device=DEV)
    out = {}
    for where in ("no_group", "pod_group"):
        params = _to(init_model(cfg, torch.Generator().manual_seed(0)), DEV)
        step = make_train_step(cfg, opt, tcfg)
        _zero_launches()
        if where == "no_group":
            params, st, m = step(params, adamw_init(params), batch, 0)
        else:
            with nccl_world(), use_mesh(build_mesh((1,), ("pod",))):
                params, st, m = step(params, adamw_init(params), batch, 0)
        torch.cuda.synchronize()
        out[where] = ({"params": params, "opt": st}, float(m["loss"]),
                      [k.launches for k in QD.KERNELS])
    (a, loss_a, _), (b, loss_b, launches) = out["no_group"], out["pod_group"]
    if not (_tree_equal(a, b) and loss_a == loss_b):
        raise AssertionError("the step over the NCCL pod group differs from "
                             "the step without a group")
    if min(launches) <= 0:
        raise AssertionError(f"the pod-group step did not launch K3: "
                             f"{launches}")
    phase("train_reference_dist", model="qwen3-1.7b-reduced f32",
          backend="nccl", pod_group=1, pods=2, bit_equal=True, loss=loss_b,
          leaves=len(CK._leaf_paths(a)), k3_launches=launches)
    return launches


def train_restart_phase(train_sums):
    """Full-width qwen3-1.7b as [train] (same config, seed and batches),
    the pod sync over a world-1 NCCL `pod` group, through
    `run_with_restarts` and an async `CheckpointManager` (keep 1) in a
    fresh directory under build/: attempt 0 runs steps 0-1, saves step
    2, runs step 2 and fails before step 3; attempt 1 restores step 2
    and runs steps 2-3. The final params, moments and count must equal
    [train]'s after its 4 steps, leaf by leaf."""
    cfg = get_config("qwen3-1.7b")
    opt = ModelOptions(triangular_flash=True, remat="full")
    tcfg = TrainConfig(adamw=AdamWConfig(lr=3e-4), warmup_steps=0,
                       total_steps=TRAIN_STEPS, dp_compress="int8",
                       num_pods=TRAIN_PODS, quant_block=QBLOCK)
    dcfg = DataConfig(seed=0)
    step_fn = make_train_step(cfg, opt, tcfg)
    root = ROOT / "build"
    root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="ckpt_", dir=root))
    rec = {"losses": [], "restore_s": [], "steps": []}
    try:
        mgr = CheckpointManager(CheckpointConfig(str(tmp), keep=1,
                                                 async_save=True))
        restore = mgr.restore

        def timed_restore(template):
            t0 = time.perf_counter()
            out = restore(template)
            torch.cuda.synchronize()
            rec["restore_s"].append(time.perf_counter() - t0)
            return out

        mgr.restore = timed_restore

        def make_state():
            params = init_model(cfg, torch.Generator(device=DEV).manual_seed(0))
            return {"params": params, "opt": adamw_init(params)}, 0

        def run_from(state, start):
            params, opt_state = state["params"], state["opt"]
            for s in range(start, TRAIN_STEPS):
                if s == RESTART_FAIL_AT and "saved" in rec \
                        and "failed" not in rec:
                    t0 = time.perf_counter()
                    mgr.wait()
                    rec["wait_s"] = time.perf_counter() - rec["save_t0"]
                    rec["wait_blocked_s"] = time.perf_counter() - t0
                    rec["failed"] = s
                    raise RuntimeError(f"injected failure before step {s}")
                batch = synthetic_batch(cfg, TRAIN_SHAPE, dcfg, s, device=DEV)
                params, opt_state, m = step_fn(params, opt_state, batch, s)
                rec["losses"].append(float(m["loss"]))
                rec["steps"].append(s)
                if s + 1 == RESTART_SAVE_AT and "saved" not in rec:
                    rec["free_disk_gb"] = shutil.disk_usage(tmp).free / 1e9
                    rec["save_t0"] = time.perf_counter()
                    mgr.save(s + 1, {"params": params, "opt": opt_state})
                    rec["save_blocked_s"] = time.perf_counter() - rec["save_t0"]
                    rec["saved"] = s + 1
            rec["sums"] = state_checksums({"params": params, "opt": opt_state})

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        with nccl_world(), use_mesh(build_mesh((1,), ("pod",))):
            failures = run_with_restarts(make_state, run_from, mgr,
                                         max_failures=1)
        launches = tuple(k.launches for k in QD.KERNELS)
        peak = torch.cuda.max_memory_allocated()
        ckpt_bytes = sum(f.stat().st_size
                         for f in (tmp / f"step_{RESTART_SAVE_AT}").iterdir())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if failures != 1 or rec["steps"] != [0, 1, 2, 2, 3]:
        raise AssertionError(f"restart loop: {failures} failures, steps "
                             f"{rec['steps']}")
    if rec["sums"] != train_sums:
        bad = [n for n in train_sums if rec["sums"].get(n) != train_sums[n]]
        raise AssertionError(f"resumed state differs from [train]'s in "
                             f"{len(bad)} leaves: {bad[:5]}")
    n_leaves = len([n for n in train_sums if n.startswith("params_")])
    want = len(rec["steps"]) * TRAIN_PODS * n_leaves
    if launches != (want, want):
        raise AssertionError(f"K3 launches {launches}, predicted {want}")
    phase("train_restart", model="qwen3-1.7b", backend="nccl", pod_group=1,
          steps=rec["steps"], failures=failures, saved_at=rec["saved"],
          failed_before=rec["failed"], losses=rec["losses"],
          state_equal_to_train=True, leaves=len(train_sums),
          state_checksum=checksum_digest(rec["sums"]),
          checkpoint_bytes=ckpt_bytes,
          checkpoint_gb=f"{ckpt_bytes / 1e9:.3f}",
          free_disk_gb_before_save=f"{rec['free_disk_gb']:.1f}",
          save_blocked_s=f"{rec['save_blocked_s']:.3f}",
          save_to_wait_return_s=f"{rec['wait_s']:.3f}",
          wait_blocked_s=f"{rec['wait_blocked_s']:.3f}",
          restore_s=[f"{t:.3f}" for t in rec["restore_s"]],
          peak_gib=f"{peak / 2**30:.2f}", k3_launches=launches,
          k3_launches_predicted=want)
    return launches


PIPE_M = 4                          # microbatches of 1 x 1024 tokens


def pipeline_phase():
    """GPipe over a world-1 NCCL `stage` group: qwen3-1.7b's 28 decoder
    blocks at full width in bf16 as the one stage, 4 microbatches of
    1 x 1024 tokens; the forward bit-equal to the blocks applied to each
    microbatch in turn, and forward + backward (remat "full", outside
    inference mode) with every parameter gradient bit-equal to the
    unpipelined blocks' backward of the same loss."""
    cfg = get_config("qwen3-1.7b")
    opt = ModelOptions(triangular_flash=True, remat="none")
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = init_model(cfg, gen, dtype=torch.bfloat16)
    blocks = params["runs"][0]
    del params
    n_layers = tree_leaves(blocks)[0].shape[0]
    x = torch.randn((PIPE_M, 1, 1024, cfg.d_model), generator=gen,
                    device=DEV).to(torch.bfloat16)
    ct = torch.randn(x.shape, generator=gen, device=DEV)  # d loss / d out
    positions = torch.arange(1024, device=DEV)

    def stage(o):
        return lambda p, xi: MODEL._run_scan(
            p, ATTN, xi, cfg, o, window=MODEL._window(cfg, o),
            positions=positions)[0]

    stage_fn = stage(opt)
    stage_bwd = stage(dataclasses.replace(opt, remat="full"))

    def sequential(fn, p):
        return torch.stack([fn(p, x[i]) for i in range(PIPE_M)])

    def grads(run):
        """Every block parameter's gradient of sum(out * ct)."""
        live = [t.detach().requires_grad_(True) for t in tree_leaves(blocks)]
        out = run(CP.tree_unflatten(blocks, live))
        (out.float() * ct).sum().backward()
        return [t.grad for t in live]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0) / PIPE_M

    with nccl_world():
        mesh = build_mesh((1,), ("stage",))
        with torch.inference_mode():
            want, seq_ms = timed(lambda: sequential(stage_fn, blocks))
            got, first_ms = timed(lambda: pipeline_forward(
                mesh, stage_fn, blocks, x))
            got, pipe_ms = timed(lambda: pipeline_forward(
                mesh, stage_fn, blocks, x))
            want, seq_ms = timed(lambda: sequential(stage_fn, blocks))
        g_want, seq_bwd_ms = timed(lambda: grads(
            lambda p: sequential(stage_bwd, p)))
        g_got, first_bwd_ms = timed(lambda: grads(
            lambda p: pipeline_forward(mesh, stage_bwd, p, x)))
        g_got, pipe_bwd_ms = timed(lambda: grads(
            lambda p: pipeline_forward(mesh, stage_bwd, p, x)))
        g_want, seq_bwd_ms = timed(lambda: grads(
            lambda p: sequential(stage_bwd, p)))
    if not (torch.equal(got, want) and bool(got.isfinite().all())):
        raise AssertionError("pipeline_forward differs from the blocks "
                             "applied to each microbatch")
    if not all(torch.equal(a, b) and bool(a.isfinite().all())
               for a, b in zip(g_got, g_want)):
        raise AssertionError("pipeline_forward's parameter gradients differ "
                             "from the unpipelined blocks' backward")
    phase("pipeline", model="qwen3-1.7b", layers=n_layers, stages=1,
          backend="nccl", microbatches=PIPE_M, tokens_per_microbatch=1024,
          dtype="bfloat16", bit_equal=True, grads_bit_equal=True,
          grad_leaves=len(g_got), backward_remat="full",
          ms_per_microbatch=f"{pipe_ms:.3f}",
          first_call_ms_per_microbatch=f"{first_ms:.3f}",
          sequential_ms_per_microbatch=f"{seq_ms:.3f}",
          fwd_bwd_ms_per_microbatch=f"{pipe_bwd_ms:.3f}",
          first_call_fwd_bwd_ms_per_microbatch=f"{first_bwd_ms:.3f}",
          sequential_fwd_bwd_ms_per_microbatch=f"{seq_bwd_ms:.3f}")


MOE_TOKENS = 1024
MOE_ROW_TOL = 2 ** -6               # of each row's largest |moe_dense|


def kernel_ms(run, setup=None, reps=3):
    """Summed device time of the CUDA kernels `run(setup())` launches,
    from torch.profiler; the least of `reps` runs."""
    best = math.inf
    for _ in range(reps):
        arg = setup() if setup else None
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            run(arg)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        best = min(best, sum(e.time_range.elapsed_us()
                             for e in kernels) / 1e3)
    return best


def moe_ep_phase():
    """One full-width olmoe-1b-7b MoE layer in bf16 on 1 x 1024 tokens
    through `moe_ep` over a world-1 NCCL `model` group: forward and
    backward finite; the tokens no expert dropped for capacity match
    `moe_dense` within 2^-6 of each row's largest magnitude (each of the
    k = 8 slot outputs is rounded to bf16 up to three times more on the
    grouped path); device ms of both, forward and backward."""
    cfg = get_config("olmoe-1b-7b")
    gen = torch.Generator(device=DEV).manual_seed(0)
    p = MOE.init_moe(gen, cfg, dtype=torch.bfloat16)
    x = torch.randn((1, MOE_TOKENS, cfg.d_model), generator=gen,
                    device=DEV).to(torch.bfloat16)
    # at m = 1 every slot reaches the exchange (its capacity is >= the
    # slots); a slot is dropped when its rank among its expert's slots,
    # in slot order, reaches the per-expert capacity
    k, e = cfg.experts_per_token, cfg.num_experts
    _, idx, _ = MOE._route(p, cfg, x)
    slots = idx.reshape(-1)
    cs = MOE._round8(math.ceil(slots.numel() * cfg.moe_capacity_factor))
    ce = MOE._round8(math.ceil(cs / e * cfg.moe_capacity_factor))
    onehot = (slots[:, None] == torch.arange(e, device=DEV)).to(torch.int32)
    rank = onehot.cumsum(0).gather(1, slots[:, None])[:, 0] - 1
    dropped = (rank >= ce).reshape(MOE_TOKENS, k)
    keep = ~dropped.any(1)

    def fwd(fn):
        leaves = {n: t.detach().requires_grad_(True) for n, t in p.items()}
        xg = x.detach().requires_grad_(True)
        y, aux = fn(leaves, xg)
        return leaves, xg, y, aux

    def bwd(out):
        _, _, y, aux = out
        ((y.float() ** 2).mean() + aux).backward()

    with nccl_world():
        mesh = build_mesh((1, 1), ("data", "model"))
        with use_mesh(mesh):
            ep = lambda q, xx: MOE.moe_ep(q, cfg, xx)         # noqa: E731
            out_ep = fwd(ep)
            bwd(out_ep)
            ep_fwd = kernel_ms(lambda _: fwd(ep))
            ep_bwd = kernel_ms(bwd, lambda: fwd(ep))
        dense = lambda q, xx: MOE.moe_dense(q, cfg, xx)       # noqa: E731
        out_d = fwd(dense)
        bwd(out_d)
        d_fwd = kernel_ms(lambda _: fwd(dense))
        d_bwd = kernel_ms(bwd, lambda: fwd(dense))
    leaves, xg, y, aux = out_ep
    grads = [xg.grad] + [leaves[n].grad for n in sorted(leaves)]
    if not (bool(y.isfinite().all()) and bool(aux.isfinite())
            and all(g is not None and bool(g.isfinite().all())
                    for g in grads)):
        raise AssertionError("moe_ep forward or backward is not finite")
    yd = out_d[2].detach().float()[0, keep]
    ye = y.detach().float()[0, keep]
    row_err = ((ye - yd).abs().amax(1) / yd.abs().amax(1).clamp(min=1e-30))
    worst = float(row_err.max())
    if worst > MOE_ROW_TOL:
        raise AssertionError(f"moe_ep rows differ from moe_dense by {worst} "
                             f"of their magnitude, above {MOE_ROW_TOL}")
    phase("moe_ep", model="olmoe-1b-7b", backend="nccl", model_group=1,
          experts=e, top_k=k, tokens=MOE_TOKENS, dtype="bfloat16",
          expert_capacity=ce, dropped_slots=int(dropped.sum()),
          dropped_tokens=int((~keep).sum()), finite=True,
          row_err_over_max=f"{worst:.3e}", row_tol=MOE_ROW_TOL,
          aux_ep=float(aux.detach()), aux_dense=float(out_d[3].detach()),
          ep_fwd_device_ms=f"{ep_fwd:.3f}", ep_bwd_device_ms=f"{ep_bwd:.3f}",
          dense_fwd_device_ms=f"{d_fwd:.3f}",
          dense_bwd_device_ms=f"{d_bwd:.3f}")


# ------------------------------------------------------ phase 9: simulator
# ------------------------------------------------------------ dry run
DRYRUN_CELLS = (("qwen3-1.7b", "train_4k", ()),
                ("qwen3-1.7b", "prefill_32k", ()),
                ("qwen3-1.7b", "decode_32k", ()),
                ("qwen3-1.7b", "train_4k", ("--multi-pod", "--dp-compress",
                                            "int8")),
                ("olmoe-1b-7b", "decode_32k", ()))
DRYRUN_WAIT_S = 420                 # the longest a cell may take in all
PEAK_BF16_FLOPS = 989.4e12          # H100 SXM dense bf16, FLOP/s (public)
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory, bytes/s
DVC_DECODE = ShapeConfig("dvc_decode", 32768, 8, "decode")
DVC_PEAK_TOL = 0.10                 # predicted peak against the card's
FAKE_DEVICE = "cuda"                # the dry run's fake tensors here


def dryrun_cells_start():
    """Start the dry-run cells, one `python -m repro_torch.launch.dryrun`
    each, all at once. Their fake tensors are CUDA tensors, as the dry
    run makes them wherever torch has CUDA; nothing is allocated on the
    card. Returns (their output directory, [(cell, process, log, start
    time)])."""
    out = ROOT / "build" / f"dryrun_{os.getpid()}"
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    procs = []
    for arch, shape, extra in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, *extra, "--dump-ops", "--out-dir",
               str(out)]
        log = open(out / f"{arch}__{shape}__{len(extra)}.log", "w")
        procs.append(((arch, shape, extra),
                      subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                       stderr=subprocess.STDOUT),
                      log, time.perf_counter()))
    return out, procs


def dryrun_cells_stop(procs):
    """End every dry-run process that is still running."""
    for _, proc, log, _ in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        log.close()


def dryrun_cells_phase(out, procs):
    """Wait for each dry-run cell and print its record: status, fake
    device, seconds, TFLOP per chip, the eager op stream's and the
    step's least bytes per chip, collective wire bytes by kind, the
    argument and temporary GiB per chip, whether the peak fits one
    card, and the forced reshards; for the int8 cell also K3's calls in
    the traced op list. Any status but "ok", or fake tensors on another
    device than the card's, fails."""
    deadline = time.perf_counter() + DRYRUN_WAIT_S
    for (arch, shape, extra), proc, log, t0 in procs:
        proc.wait(max(1.0, deadline - time.perf_counter()))
        mesh = "multipod_2x16x16" if "--multi-pod" in extra else "pod_16x16"
        rec = json.loads((out / f"{arch}__{shape}__{mesh}.json").read_text())
        if rec["status"] != "ok" or proc.returncode != 0:
            raise AssertionError(f"dry-run cell {arch} {shape} {mesh}: "
                                 f"{rec['status']} {rec.get('error')} at "
                                 f"{rec.get('failing_op')}")
        if rec["device"] != FAKE_DEVICE:
            raise AssertionError(f"dry-run cell {arch} {shape} {mesh} "
                                 f"traced on {rec['device']} tensors")
        oa, mem = rec["op_analysis"], rec["memory_analysis"]
        kv = {}
        if "--dp-compress" in extra:
            ops = {o["op"]: o["count"] for o in json.loads(
                (out / f"{arch}__{shape}__{mesh}.ops.json").read_text())}
            kv = {"k3q_calls": ops.get("repro_torch.quantize_block_int8", 0),
                  "k3d_calls": ops.get("repro_torch.dequantize_block_int8",
                                       0)}
            if min(kv.values()) <= 0:
                raise AssertionError(f"the int8 cell traced no K3 call: {kv}")
        phase("dryrun_cells", arch=arch, shape=shape, mesh=mesh,
              status=rec["status"], device=rec["device"],
              torch=rec["torch"],
              seconds=f"{rec['specs_s'] + rec['trace_s']:.1f}",
              wall_s=f"{time.perf_counter() - t0:.1f}",
              tflop_per_chip=f"{rec['flops'] / 1e12:.4f}",
              model_tflop_per_chip=(
                  f"{rec['model_flops'] / 1e12 / rec['chips']:.4f}"),
              eager_op_bytes_per_chip=int(rec["bytes_accessed"]),
              bound_bytes_per_chip=int(rec["bound_bytes"]),
              wire_bytes={k: int(v["wire_bytes"])
                          for k, v in oa["collectives"].items()},
              argument_gib=f"{mem['argument_size_in_bytes'] / 2**30:.3f}",
              temp_gib=f"{mem['temp_size_in_bytes'] / 2**30:.3f}",
              fits=rec["fits"], reshards=rec["reshards"], **kv)


def _storages(tree):
    return len({t.untyped_storage().data_ptr() for t in tree_leaves(tree)
                if isinstance(t, torch.Tensor)})


def _vs_card(title, fake_args, build_real, step_fn, k3=False, **kv):
    """Trace `step_fn` on `fake_args` (fake CUDA tensors) with
    op_analysis, then build the same arguments on the card and run the
    step once under the same counter. FLOPs (from shapes on both sides)
    equal exactly: the traced op stream is the run's. From the card's
    allocator: the predicted argument bytes equal its own to within its
    512-byte rounding, and the predicted peak is within 10 % of its
    peak. K3's traced calls equal its launches. Then one uncounted step
    is timed against its bound, max(FLOPs / 989.4 TFLOP/s, least bytes /
    3.35 TB/s), the least bytes being `op_analysis`'s `bound_bytes`;
    the eager op stream's bytes are printed beside it, not as a bound."""
    fake_counter = OA.OpCounter()
    with fake_mode():
        pred = OA.analyze(step_fn, *fake_args, counter=fake_counter)
    del fake_args
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    args = build_real()
    torch.cuda.synchronize()
    alloc = torch.cuda.memory_allocated() - base
    slack = 512 * _storages(args)
    if not pred["argument_bytes"] <= alloc <= pred["argument_bytes"] + slack:
        raise AssertionError(f"{title}: {alloc} argument bytes allocated, "
                             f"{pred['argument_bytes']} predicted")
    torch.cuda.reset_peak_memory_stats()
    for k in QD.KERNELS:
        k.launches = 0
    real = OA.analyze(step_fn, *args, counter=OA.OpCounter())
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = [k.launches for k in QD.KERNELS]
    if real["flops_per_chip"] != pred["flops_per_chip"]:
        raise AssertionError(f"{title}: {real['flops_per_chip']} FLOPs run, "
                             f"{pred['flops_per_chip']} traced")
    gap = (pred["peak_bytes"] - peak) / peak
    if abs(gap) > DVC_PEAK_TOL:
        raise AssertionError(f"{title}: peak {pred['peak_bytes']} predicted, "
                             f"{peak} on the card ({gap:+.3%})")
    traced = [fake_counter.ops.get(f"repro_torch.{n}", [0])[0]
              for n in ("quantize_block_int8", "dequantize_block_int8")]
    if k3 and (traced != launches or min(launches) <= 0):
        raise AssertionError(f"{title}: K3 traced {traced}, launched "
                             f"{launches}")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    step_fn(*args)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    flop_ms = pred["flops_per_chip"] / PEAK_BF16_FLOPS * 1e3
    byte_ms = pred["bound_bytes"] / HBM_BYTES_PER_S * 1e3
    bound = max(flop_ms, byte_ms)
    phase("dryrun_vs_card", step=title, **kv,
          flops_traced=pred["flops_per_chip"],
          flops_card=real["flops_per_chip"],
          bound_bytes_traced=pred["bound_bytes"],
          bound_bytes_card=real["bound_bytes"],
          eager_op_bytes_traced=pred["eager_op_bytes_per_chip"],
          eager_op_bytes_card=real["eager_op_bytes_per_chip"],
          argument_bytes_traced=pred["argument_bytes"],
          argument_bytes_allocated=alloc,
          peak_gib_traced=f"{pred['peak_bytes'] / 2**30:.3f}",
          peak_gib_card=f"{peak / 2**30:.3f}", peak_gap=f"{gap:+.4%}",
          k3_traced=traced, k3_launches=launches, ops=pred["num_ops"],
          device_ms=f"{ms:.3f}", bound_ms=f"{bound:.3f}",
          bound_by="operations" if flop_ms >= byte_ms else "bytes",
          bound_share=f"{bound / ms:.4f}",
          eager_op_bytes_ms=(
              f"{pred['eager_op_bytes_per_chip'] / HBM_BYTES_PER_S * 1e3:.3f}"),
          peak_bf16_tflops=PEAK_BF16_FLOPS / 1e12,
          hbm_tb_per_s=HBM_BYTES_PER_S / 1e12)
    del args
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def dryrun_vs_card_phase(smi):
    """The dry run's counts held against the card, on one card with no
    mesh: qwen3-1.7b's decode_step at B = 8 against a 32768-token cache
    (bf16 weights and cache), and the `[train]` cell's step (4 x 1024
    tokens, f32 master params, remat "full", the int8 pod sync over 2
    pods). Returns K3's launches in the train step."""
    print(f"[dryrun_vs_card] card={smi}", flush=True)
    cfg = get_config("qwen3-1.7b")
    opt = SPECS.model_options_for(cfg, DVC_DECODE)
    fake, _ = SPECS.input_specs(cfg, DVC_DECODE, opt, device=FAKE_DEVICE)

    def real_decode():
        gen = torch.Generator(device=DEV).manual_seed(0)
        p = init_model(cfg, gen, dtype=torch.bfloat16)
        p = CP.tree_map(lambda t: t.to(torch.bfloat16), p)
        state = init_decode_state(cfg, DVC_DECODE.global_batch,
                                  DVC_DECODE.seq_len, opt, device=DEV)
        tokens = torch.randint(2, cfg.vocab_size,
                               (DVC_DECODE.global_batch, 1),
                               generator=gen, device=DEV, dtype=torch.int32)
        return (p, state, tokens, DVC_DECODE.seq_len - 1)

    _vs_card("decode_step", fake, real_decode,
             lambda p, s, t, pos: decode_step(p, cfg, s, t, pos, opt),
             batch=DVC_DECODE.global_batch, cache=DVC_DECODE.seq_len)
    opt = SPECS.model_options_for(cfg, TRAIN_SHAPE)
    tcfg = TrainConfig(adamw=AdamWConfig(lr=3e-4), warmup_steps=0,
                       total_steps=TRAIN_STEPS, dp_compress="int8",
                       num_pods=TRAIN_PODS, quant_block=QBLOCK)
    fake, _ = SPECS.input_specs(cfg, TRAIN_SHAPE, opt, device=FAKE_DEVICE)

    def real_train():
        params = init_model(cfg, torch.Generator(device=DEV).manual_seed(0))
        batch = synthetic_batch(cfg, TRAIN_SHAPE, DataConfig(seed=0), 0,
                                device=DEV)
        batch["labels"] = batch["labels"].clone()   # its own storage
        return (params, adamw_init(params), batch, 0)

    return _vs_card("train_step", fake, real_train,
                    make_train_step(cfg, opt, tcfg), k3=True,
                    batch=TRAIN_SHAPE.global_batch, seq=TRAIN_SHAPE.seq_len,
                    pods=TRAIN_PODS, remat=opt.remat)


def examples_phase():
    """The port's runnable examples on the card: quickstart (train 8
    steps of reduced qwen3-1.7b, then decode), serve_paged (DaeMon
    against Remote-style ledgers, the residency plane's tenants,
    replicated serving) and train_100m for 20 steps with checkpoints in
    a temporary directory, then again to 24 steps, resumed."""
    from repro_torch.examples import quickstart, serve_paged, train_100m
    out = ROOT / "build" / f"examples_{os.getpid()}"
    out.mkdir(parents=True, exist_ok=True)
    q = quickstart.main([])
    if not (np.isfinite(q["losses"]).all() and q["losses"][-1] <
            q["losses"][0]):
        raise AssertionError(f"quickstart loss did not fall: {q['losses']}")
    s = serve_paged.main(["--trace-out", str(out / "TRACE_tenants.json")])
    if not s["daemon"]["wire_bytes"] < s["remote"]["wire_bytes"]:
        raise AssertionError("DaeMon moved no fewer bytes than Remote-style")
    ckpt = tempfile.mkdtemp(prefix="train_100m_", dir=out)
    first = train_100m.main(["--steps", "20", "--ckpt-every", "10",
                             "--ckpt-dir", ckpt])
    resumed = train_100m.main(["--steps", "24", "--ckpt-every", "10",
                               "--ckpt-dir", ckpt])
    if resumed["start"] != 20 or not first["loss"] < first["first_loss"]:
        raise AssertionError(f"train_100m: {first} then {resumed}")
    shutil.rmtree(out, ignore_errors=True)
    phase("examples", quickstart_loss=f"{q['losses'][0]:.4f}->"
          f"{q['losses'][-1]:.4f}",
          serve_paged_wire_saving=f"{s['saving']:.4f}",
          daemon_wire_bytes=s["daemon"]["wire_bytes"],
          remote_wire_bytes=s["remote"]["wire_bytes"],
          train_100m_loss=f"{first['first_loss']:.4f}->{first['loss']:.4f}",
          train_100m_resumed_at=resumed["start"])


GOLDEN = ROOT / "tests" / "golden" / "seed_movement_golden.json"
# ------------------------------------------------------- model families
FAMILY_ARCHS = ("olmoe-1b-7b", "zamba2-2.7b", "xlstm-125m", "whisper-base",
                "internvl2-26b", "qwen3-moe-30b-a3b")
# each full-width family cell: (short name, prompt tokens, new tokens);
# zamba2's 54 mamba layers, internvl2's 40 GB and qwen3-moe's 61 GB of
# weights make their steps the longer, so they run 16 + 16. qwen3-moe
# comes last: it fits the card only once the others are freed.
FAMILY_SERVE = {"olmoe-1b-7b": ("olmoe", 32, 32),
                "zamba2-2.7b": ("zamba2", 16, 16),
                "xlstm-125m": ("xlstm", 32, 32),
                "whisper-base": ("whisper", 32, 32),
                "internvl2-26b": ("internvl2", 16, 16),
                "qwen3-moe-30b-a3b": ("qwen3moe", 16, 16)}
# the reduced archs held card against CPU (qwen3-moe's reduced form is
# olmoe's code path)
FAMILY_REFERENCE = FAMILY_ARCHS[:5]
FAMILY_WINDOW = 8       # the reduced hybrid's ring window: its runs wrap it
FAMILY_DECODE = 16      # decode steps compared card against CPU
FRONTEND_PROMPT = 32    # text tokens of the full-width frontend prefill


def families_reference_phase():
    """The card against the CPU on reduced olmoe-1b-7b, zamba2-2.7b,
    xlstm-125m, whisper-base and internvl2-26b (f32; zamba2 with an
    8-token window on the ring cache, so the 16-token serve and decode
    wrap it): serve_batch_paged's ledger through the kernels equals the
    plain versions' on the CPU within rtol 1e-5, atol 1e-6, its greedy
    tokens are equal, and the decode's logits agree within 1e-3, as in
    [reference]. For the two frontend archs a one-pass prefill with the
    stub's input (whisper's encoder, internvl2's prepended patches)
    agrees within 1e-3 too."""
    store = DS.KVStoreConfig(num_local_pages=4, page_tokens=2, kv_heads=2,
                             head_dim=16, page_budget_per_step=2)
    pcfg = PagedServeConfig(window_pages=2, pages_per_seq=8)
    scfg = ServeConfig(max_new_tokens=FAMILY_DECODE - 6)
    for arch in FAMILY_REFERENCE:
        cfg = get_config(arch).reduced()
        opt = ModelOptions(remat="none")
        if cfg.shared_attn_every:
            cfg = dataclasses.replace(cfg, window=FAMILY_WINDOW)
            opt = ModelOptions(remat="none", window_ring=True)
        params_cpu = init_model(cfg, torch.Generator().manual_seed(0))
        params = _to(params_cpu, DEV)
        prompts = torch.randint(2, 200, (2, 6),
                                generator=torch.Generator().manual_seed(1))
        tok_c, led_c = serve_batch_paged(params_cpu, cfg, prompts, scfg,
                                         store, pcfg, opt=opt, device="cpu")
        tok_g, led_g = serve_batch_paged(params, cfg, prompts.to(DEV), scfg,
                                         store, pcfg, opt=opt)
        for k, v in led_c.items():
            np.testing.assert_allclose(led_g[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{arch} {k}")
        st_c = init_decode_state(cfg, 2, FAMILY_DECODE, opt, device="cpu")
        st_g = init_decode_state(cfg, 2, FAMILY_DECODE, opt, device=DEV)
        worst = 0.0
        for pos in range(FAMILY_DECODE):
            tok = tok_c[:, pos:pos + 1]
            lc, st_c = decode_step(params_cpu, cfg, st_c, tok, pos, opt)
            lg, st_g = decode_step(params, cfg, st_g, tok.to(DEV), pos, opt)
            np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(),
                                       rtol=1e-3, atol=1e-3,
                                       err_msg=f"{arch} pos {pos}")
            worst = max(worst, float((lg.cpu() - lc).abs().max()))
        kv_rows = next((r["k"].shape[-3] for r in st_g["runs"]
                        if "k" in r), 0)
        same = float((tok_g.cpu() == tok_c).float().mean())
        if same != 1.0:
            raise AssertionError(f"{arch}: greedy tokens differ")
        extra = {}
        if cfg.frontend:
            extra["prefill_logits_max_abs_diff"] = \
                f"{frontend_reference(cfg, params_cpu, params, opt):.2e}"
        phase("families_reference", model=f"{cfg.name} f32",
              window_ring=opt.window_ring, kv_rows=kv_rows,
              decode_steps=FAMILY_DECODE, ledger_equal=True,
              logits_max_abs_diff=f"{worst:.2e}", tokens_equal_frac=same,
              **extra)


def frontend_reference(cfg, params_cpu, params, opt):
    """One-pass prefill of 6 tokens with the stub's frontend input from
    the data pipeline, card against CPU: logits within 1e-3. Returns the
    largest difference."""
    batch = synthetic_batch(cfg, ShapeConfig("fr", 6, 2, "prefill"),
                            DataConfig(), 0, device="cpu")
    batch = {"tokens": batch["tokens"], "frontend": batch["frontend"]}
    max_len = 6 + cfg.frontend_tokens + 4
    lc, _ = prefill(params_cpu, cfg, batch, max_len, opt)
    lg, _ = prefill(params, cfg, _to(batch, DEV), max_len, opt)
    np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), rtol=1e-3,
                               atol=1e-3, err_msg=f"{cfg.name} prefill")
    return float((lg.cpu() - lc).abs().max())


def _layer_view(tree):
    """Layer 0 of a stacked (L, ...) parameter tree."""
    return CP.tree_map(lambda t: t[0], tree)


def block_timing(cfg, params):
    """One layer of the family's own block at the decode shape (B = 8,
    one token): the MoE ffn of olmoe and qwen3-moe, a Mamba2 mixer of
    zamba2, an mLSTM mixer of xlstm, the cross attention of whisper over
    its encoder_seq-row cache, the dense MLP of internvl2. Device ms
    (CUDA graph) and eager call ms against the layer's weight bytes at
    the card's memory rate (for the mLSTM and the cross attention, the
    state or cache it reads, `block_state_bytes`, is in the bound too),
    and the memory one call allocates beyond its output (an operand
    copied to reach a GEMM's layout shows here)."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    h = torch.randn((SERVE_B, 1, cfg.d_model), generator=gen, device=DEV
                    ).to(torch.bfloat16)
    st = None
    block = params["runs"][0]
    if cfg.is_moe:
        p = _layer_view(block["ffn"])
        name = "moe_dense"

        def fn():
            return MOE.moe_dense(p, cfg, h)
    elif cfg.shared_attn_every:
        p = _layer_view(block["mixer"])
        state = SSM.init_mamba2_state(cfg, SERVE_B, device=DEV)
        name = "mamba2_decode"

        def fn():
            return SSM.mamba2_decode(p, cfg, h, state)
    elif cfg.family == "ssm":
        p = _layer_view(block["mixer"])
        st = XL.init_mlstm_state(cfg, SERVE_B, device=DEV)
        name = "mlstm_decode"

        def fn():
            return XL.mlstm_decode(p, cfg, h, st)
    elif cfg.cross_attention:
        p = _layer_view(block["xattn"])
        st = init_decode_state(cfg, SERVE_B, 1, ModelOptions(), device=DEV)
        st = {k: st["runs"][0][k][0] for k in ("xk", "xv")}
        name = "decode_cross_attention"

        def fn():
            return decode_cross_attention(p, cfg, h,
                                          {"k": st["xk"], "v": st["xv"]})
    else:
        p = _layer_view(block["ffn"])
        name = "mlp"

        def fn():
            return mlp(p, h)
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(p))
    state_bytes = {} if st is None else {"block_state_bytes": sum(
        t.numel() * t.element_size() for t in st.values())}
    bound_bytes = nbytes + state_bytes.get("block_state_bytes", 0)
    fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    del out
    return {"block": name, "block_weight_bytes": nbytes, **state_bytes,
            "block_bound_ms": f"{bound_bytes / HBM_BYTES_PER_MS:.5f}",
            "block_device_ms": f"{device_ms(fn):.5f}",
            "block_call_ms": f"{call_ms(fn, 20):.5f}",
            "block_alloc_mib": f"{extra / 2**20:.1f}"}


def serve_family_phase(arch):
    """Full-width `arch` (bf16 weights from seed 0) through
    serve_batch_paged at B = 8 with a store of the model's own KV
    geometry (SERVE_STORE's pages, sets and ways): the family's serve
    path. Checks launches of K1 and K2, every request counted, bytes
    conserved and the tokens in range; then the step split, the model
    part against its weight-byte bound, one layer of the family's block,
    and K1 (on the run's last-step inputs) and K2 (the K/V pair at the
    cell's remote pool and L = B*R) bit for bit against their plain
    versions at the model's row width; for a frontend arch, the one-pass
    prefill with its stub's input (`prefill_frontends_phase`). Frees the
    model. Returns (launch counts, K1's numbers, K2's numbers)."""
    short, prompt_len, new = FAMILY_SERVE[arch]
    cfg = get_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEV).manual_seed(0)
    t0 = time.perf_counter()
    params = init_model(cfg, gen, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_secs = time.perf_counter() - t0
    lv = leaves(params)
    n_params = sum(t.numel() for t in lv.values())
    # a decode step reads every weight once, of the embedding table only
    # the B gathered rows, and no encoder weight
    weight_bytes = sum(t.numel() * t.element_size() for k, t in lv.items()
                       if not k.startswith((".embed", ".encoder")))
    del lv
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_B, prompt_len),
                            generator=gen, device=DEV, dtype=torch.int32)
    store = DS.KVStoreConfig(**dict(SERVE_STORE,
                                    kv_heads=cfg.num_kv_heads,
                                    head_dim=cfg.resolved_head_dim))
    row = (store.page_tokens, store.kv_heads, store.head_dim)
    row_bytes = math.prod(row) * 2
    scfg = ServeConfig(max_new_tokens=new)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    PG.KERNEL.launches = 0
    RF.KERNEL.launches = 0
    SF.KERNEL.launches = 0
    t0 = time.perf_counter()
    tokens, led = serve_batch_paged(params, cfg, prompts, scfg, store,
                                    SERVE_PAGED)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {"paged_gather": PG.KERNEL.launches,
              "fused_residency_step": RF.KERNEL.launches,
              "schedule_fold": SF.KERNEL.launches}
    peak = torch.cuda.max_memory_allocated()
    steps = prompt_len + new
    r = SERVE_PAGED.window_pages
    if min(counts.values()) <= 0:
        raise AssertionError(f"{arch}: a kernel was not launched: {counts}")
    if led["requests"] != SERVE_B * r * steps:
        raise AssertionError(f"{arch}: requests {led['requests']} != "
                             f"B*R*steps")
    if abs(sum(led["module_bytes"]) - led["wire_bytes"]) > \
            1e-5 * max(led["wire_bytes"], 1.0):
        raise AssertionError(f"{arch}: module bytes do not sum to wire "
                             f"bytes")
    if tokens.shape != (SERVE_B, steps) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"{arch}: tokens out of range or of the "
                             f"wrong shape")
    phase(f"serve_{short}", model=arch, params=n_params, batch=SERVE_B,
          prompt=prompt_len, new=new, init_seconds=f"{init_secs:.3f}",
          seconds=f"{secs:.3f}", steps_per_s=f"{steps / secs:.2f}",
          tokens_per_s=f"{SERVE_B * new / secs:.2f}",
          peak_gib=f"{peak / 2**30:.2f}", launches=counts,
          row_bytes=row_bytes, requests=led["requests"],
          hit_rate=f"{led['local_hits'] / led['requests']:.4f}",
          wire_bytes=f"{led['wire_bytes']:.6g}")
    k1_inputs, ms, state = split_phase(cfg, params, prompts, store=store,
                                       new=new, arch=arch)
    del state
    bound = weight_bytes / HBM_BYTES_PER_MS
    phase(f"{short}_model_bound", model_ms=f"{ms['model']:.3f}",
          weight_bytes=weight_bytes, bound_ms=f"{bound:.4f}",
          model_over_bound=f"{ms['model'] / bound:.2f}",
          **block_timing(cfg, params))
    t1 = k1_timing(k1_inputs, f"fused_residency_step_{short}_shape")
    del k1_inputs
    if cfg.frontend:
        prefill_frontends_phase(cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    pool_rows = SERVE_B * SERVE_PAGED.pages_per_seq
    pool, idx, mask = gather_case(gen, pool_rows, SERVE_B * r, row=row)
    err2 = gather_check(pool, idx, mask)
    t2 = gather_timing(pool, idx)
    phase(f"paged_gather_{short}_shape", exact=True, rows=SERVE_B * r,
          pool_rows=pool_rows, row_bytes=row_bytes, **t2)
    del pool
    return (counts, {"row_bytes": row_bytes, **t1},
            {"row_bytes": row_bytes, "max_abs_err": err2, **t2})


def prefill_frontends_phase(cfg, params):
    """Full-width one-pass prefill at B = 8 of FRONTEND_PROMPT text
    tokens with the stub's input from the data pipeline: whisper-base
    encodes its 1500 frames (full attention over them, on the direct
    path), internvl2-26b prepends its 256 patch embeddings. Checks the
    logits are finite and of shape (B, F + S or S, vocab), the KV caches
    written for every input position and no further, whisper's cross
    cache left zero (as in the reference)."""
    opt = ModelOptions(remat="none")
    batch = synthetic_batch(cfg, ShapeConfig("pf", FRONTEND_PROMPT, SERVE_B,
                                             "prefill"), DataConfig(), 0)
    batch = {"tokens": batch["tokens"], "frontend": batch["frontend"]}
    t = FRONTEND_PROMPT + cfg.frontend_tokens
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, state = prefill(params, cfg, batch, t + SERVE_NEW, opt)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    kv = state["runs"][0]
    if tuple(logits.shape) != (SERVE_B, t, padded_vocab(cfg.vocab_size)) \
            or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name}: prefill logits not finite or "
                             f"of shape {tuple(logits.shape)}")
    if not bool(kv["k"][:, :, t - 1].any()) or bool(kv["k"][:, :, t:].any()):
        raise AssertionError(f"{cfg.name}: prefill caches not written at "
                             f"exactly {t} positions")
    if cfg.cross_attention and (kv["xk"].any() or kv["xv"].any()):
        raise AssertionError(f"{cfg.name}: the cross cache was written")
    phase("prefill_frontends", model=cfg.name, batch=SERVE_B,
          frontend=cfg.frontend, frontend_rows=batch["frontend"].shape[1],
          text_tokens=FRONTEND_PROMPT, positions=t, seconds=f"{secs:.4f}",
          peak_gib=f"{peak / 2**30:.2f}", logits_finite=True,
          logits_abs_max=f"{float(logits.abs().max()):.4g}")


# the paper's fig-8 network grid (benchmarks/common.py NETWORK_GRID):
# switch latency (ns) x network bandwidth factor
FIG8_NETS = tuple((sw, bf) for sw in (100.0, 400.0) for bf in (2.0, 4.0, 8.0))
# benchmarks/run.py --quick replays 20000 requests; at ~19 ms of host
# time per request that phase alone took 387 s on the card, so the
# smoke run replays 2000, a rate per request, to stay within its limit
FIG8_R = 2000
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
    give the device time and launches per request; `steady_t0` is the
    host clock when the profiled requests have ended."""

    def __init__(self, guard=0, start=None, n=0):
        self.guard, self.start, self.n = guard, start, n
        self.calls = 0
        self.kernels = []
        self.prof = None
        self.steady_t0 = None

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
                    self.steady_t0 = time.perf_counter()
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
          nets=len(nets), requests=r, cells=cells, max_rel_err=worst,
          beside="dryrun_cells", seconds_pr=f"{secs['pr']:.3f}",
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


def axes_lattice():
    """[sim_axes]' lattice: (workload, trace, SimConfig, nets, the axes'
    keyword arguments)."""
    w = WORKLOADS["pr"]
    tr = generate_trace(w, AXES_R, seed=1)
    cfg = SimConfig(num_cu=4, num_mc=2)
    sched = make_link_schedule("burst", float(np.sum(tr.gap)) * 2.0,
                               cfg.num_mc)
    nets = _sim_nets(((100.0, 4.0), (400.0, 8.0)), num_mc=cfg.num_mc,
                     schedule=sched)
    return w, tr, cfg, nets, dict(
        active_cus=(1, 2, 4), policies=POLICIES,
        telemetry_cfg=TelemetryConfig(level="histogram"))


def sim_axes_phase():
    """Every lattice axis on the card against the port on the CPU:
    daemon, daemon-adaptive, bp, remote x 2 nets under a `burst` link
    schedule x active C in (1, 2, 4) at num_cu = 4, num_mc = 2 x the 4
    policies, telemetry "histogram", r = 1200. Counts exact, clocks and
    metrics bit-equal or within the golden tolerance, percentiles equal
    or one bin apart. Then two-endpoint byte conservation on the card's
    final states at C = 1 and 4, whose every leaf equals the CPU's."""
    w, tr, cfg, nets, kw = axes_lattice()
    tel = kw["telemetry_cfg"]
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
    return card


def mesh_lattice_phase(card):
    """[sim_axes]' lattice through simulate_lattice_sharded on a
    world-1 NCCL mesh: every cell bit-equal (NaN equal to NaN) to
    [sim_axes]' card result, and no hand kernel launched."""
    w, tr, cfg, nets, kw = axes_lattice()
    _zero_launches()
    with nccl_world():
        mesh = make_data_mesh()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = MP.simulate_lattice_sharded(
            [SCHEMES[s] for s in AXES_SCHEMES], cfg, tr, nets, w.comp_ratio,
            mesh=mesh, device=DEV, **kw)
        secs = time.perf_counter() - t0
    launches = _launches()
    if any(launches.values()):
        raise AssertionError(f"the simulator launched a kernel: {launches}")
    cells = 0
    for i in range(len(AXES_SCHEMES)):
        for j in range(len(nets)):
            for c in range(3):
                for p in range(len(POLICIES)):
                    a, b = got[i][j][c][p], card[i][j][c][p]
                    if set(a) != set(b):
                        raise AssertionError(f"cell {i},{j},{c},{p}: keys")
                    for key, v in b.items():
                        if not (a[key] == v or (math.isnan(a[key])
                                                and math.isnan(v))):
                            raise AssertionError(
                                f"cell {i},{j},{c},{p} {key}: {a[key]} "
                                f"!= {v}")
                    cells += 1
    phase("mesh_lattice", backend="nccl", world=1, cells=cells,
          requests=AXES_R, bit_equal_sim_axes=True, seconds=f"{secs:.3f}",
          requests_per_s=f"{AXES_R / secs:.2f}",
          host_ms_per_request=f"{1e3 * secs / AXES_R:.3f}",
          hand_kernel_launches=0)


def sim_fig8_phase():
    """The paper's fig-8 lattice: PAPER_FIG8 x the 6 NETWORK_GRID nets on
    pr at r = FIG8_R. The first 200 requests run under sync-debug mode
    "error"; requests 200-249 under torch.profiler. Prints the
    simulator's speed on the card (host ms per request over the requests
    after the profiled ones, which run at their own pace) and the
    simulated DaeMon/Remote speedup geomean over the nets (the
    simulator's output, not a card speed)."""
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
        t1 = time.perf_counter()
    secs = t1 - t0
    steady = FIG8_R - SYNC_GUARD - PROFILED
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
    host_ms = 1e3 * (t1 - watch.steady_t0) / steady
    dev_ms = sum(e.time_range.elapsed_us() for e in watch.kernels) / 1e3
    kernels = len(watch.kernels)
    phase("sim_fig8", workload="pr", schemes=len(schemes), nets=len(nets),
          lanes=len(schemes) * len(nets), requests=FIG8_R,
          seconds=f"{secs:.3f}", requests_per_s=f"{FIG8_R / secs:.2f}",
          host_ms_per_request=f"{host_ms:.3f}", steady_requests=steady,
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
    run(name, smi)


def run(name, smi):
    gen = torch.Generator(device=DEV).manual_seed(0)
    k2 = gather_phase(gen)
    k1_err = residency_phase(gen)
    drive_phase()
    drive_replicated_phase()
    mesh_counts = drive_mesh_phase()
    drive_single_phase()
    chain_k2 = chain_phase()
    sf = schedule_fold_phase()
    reference_phase()
    replicated_reference_phase()
    telemetry_phase()
    cfg, params, prompts, counts = serve_phase()
    k1_inputs, _, state = split_phase(cfg, params, prompts)
    kcache = state["runs"][0]["k"]
    del state
    k1 = k1_phase(k1_inputs, gen, k1_err)
    del k1_inputs
    prefill_phase(cfg, params, prompts)
    rep_counts, rep_inputs, rep_result = serve_replicated_phase(
        cfg, params, prompts)
    t = k1_timing(rep_inputs, "fused_residency_step_replicated_shape")
    del rep_inputs
    rep_mesh_counts = serve_replicated_mesh_phase(cfg, params, prompts,
                                                  rep_result)
    del rep_result
    k1["max_abs_err"] = max(k1["max_abs_err"], t.pop("max_abs_err"))
    k1["replicated_shape"] = {"sequences": REP_C * SERVE_B, **t}
    replicated_split_phase(cfg, params, prompts)
    k1["launches"] = counts["fused_residency_step"]
    k2["launches"] = counts["paged_gather"]
    k1["launches_by_path"] = {
        "serve_batch_paged": counts["fused_residency_step"],
        "serve_replicated": rep_counts["fused_residency_step"],
        "serve_replicated_mesh": rep_mesh_counts["fused_residency_step"],
        "store_drive_mesh": mesh_counts["fused_residency_step"]}
    k2["launches_by_path"] = {
        "serve_batch_paged": counts["paged_gather"],
        "serve_replicated": rep_counts["paged_gather"],
        "serve_replicated_mesh": rep_mesh_counts["paged_gather"],
        "store_drive_mesh": mesh_counts["paged_gather"],
        "store_chain": chain_k2}
    sf["launches"] = counts["schedule_fold"]
    sf["launches_by_path"] = {
        "serve_batch_paged": counts["schedule_fold"],
        "serve_replicated": rep_counts["schedule_fold"],
        "serve_replicated_mesh": rep_mesh_counts["schedule_fold"],
        "store_drive_mesh": mesh_counts["schedule_fold"]}
    del params                       # free the serve phases before training
    gc.collect()
    torch.cuda.empty_cache()
    families_reference_phase()
    for arch in FAMILY_ARCHS:
        short = FAMILY_SERVE[arch][0]
        fam_counts, t1, t2 = serve_family_phase(arch)
        k1["launches_by_path"][f"serve_{short}"] = \
            fam_counts["fused_residency_step"]
        k2["launches_by_path"][f"serve_{short}"] = fam_counts["paged_gather"]
        sf["launches_by_path"][f"serve_{short}"] = \
            fam_counts["schedule_fold"]
        k1["max_abs_err"] = max(k1["max_abs_err"], t1.pop("max_abs_err"))
        k2["max_abs_err"] = max(k2["max_abs_err"], t2.pop("max_abs_err"))
        k1[f"{short}_shape"] = t1
        k2[f"{short}_shape"] = t2
    k3q, k3d = qdq_phase(gen)
    k4c, k4d = bdi_phase(gen, kcache)
    dot_phase(gen)
    model_options_phase()
    train_reference_phase()
    dist_counts = train_reference_dist_phase()
    tcfg, params, opt_state, step_fn, k3_counts, sums = train_phase()
    k3q["launches"], k3d["launches"] = k3_counts
    train_split_phase(tcfg, params, opt_state, step_fn)
    del params, opt_state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    restart_counts = train_restart_phase(sums)
    gc.collect()
    torch.cuda.empty_cache()
    pipeline_phase()
    moe_ep_phase()
    gc.collect()
    torch.cuda.empty_cache()
    dvc_counts = dryrun_vs_card_phase(smi)
    for i, k3 in enumerate((k3q, k3d)):
        k3["launches_by_path"] = {"train": k3_counts[i],
                                  "train_reference_dist": dist_counts[i],
                                  "train_restart": restart_counts[i],
                                  "dryrun_vs_card": dvc_counts[i]}
    examples_phase()
    gc.collect()
    torch.cuda.empty_cache()
    # the cells load the host's cores: they run beside [sim_golden], a
    # check of values, and no timed phase runs beside them
    dr_out, dr_procs = dryrun_cells_start()
    try:
        sim_golden_phase()
        dryrun_cells_phase(dr_out, dr_procs)
    finally:
        dryrun_cells_stop(dr_procs)
    mesh_lattice_phase(sim_axes_phase())
    sim_fig8_phase()
    print(smi)
    print(json.dumps({"kernels": [k1, k2, sf, k3q, k3d, k4c, k4d]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
