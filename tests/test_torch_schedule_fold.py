"""The store's request fold (`ops.schedule_fold`): the CUDA kernel
against its plain version, and the dispatch around it.

The kernel is held to the plain fold bit for bit on the card, on every
output and with its inputs untouched, through several steps of the real
store (K1's `local_hit`, `_writebacks` before it) at four shapes: the
paged cell's store, a replicated store with the NIC active, and the
adaptive ratio with selection off under hash and affinity placement on a
bursty link. The CPU tests hold the dispatch: `impl="cuda"` refuses CPU
tensors, each stepper calls `daemon_store._schedule` through the module
global once a step (the benchmark's traced runs wrap it by that name),
and the launch's layout agrees with the .cu file's."""
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import daemon_store as DS
from repro_torch.core import fabric
from repro_torch.core.compute_plane import tree_leaves
from repro_torch.core.fabric import FabricConfig, scheduled_link
from repro_torch.kernels import ops
from repro_torch.kernels import schedule_fold as SF
from repro_torch.runtime.serve_loop import paged_request_window
from repro_torch.sim.workloads import make_link_schedule

STEPS = 24
SMALL = dict(num_local_pages=16, pool_ways=4, page_tokens=4, kv_heads=2,
             head_dim=16, page_budget_per_step=32)
FOLD_CASES = {
    # the paged cell's store and requests: B 16, R 4 (each sequence's
    # window of its 4 newest pages, the newest written), 2 sets x 2 ways,
    # LRU, int8 pages
    "paged": dict(store=dict(num_local_pages=4, pool_ways=2, page_tokens=16,
                             kv_heads=8, head_dim=128),
                  replicas=None, batch=16, burst=False, window=True),
    # C = 2 replicas x B = 8 tenants, the NIC leg active
    "replicated": dict(store=dict(SMALL, fabric=FabricConfig(num_modules=4)),
                       replicas=2, batch=8, burst=False),
    "adaptive_hash": dict(
        store=dict(SMALL, adaptive_ratio=True, selection=False,
                   fabric=FabricConfig(num_modules=4, placement="hash")),
        replicas=None, batch=8, burst=True),
    "adaptive_affinity": dict(
        store=dict(SMALL, adaptive_ratio=True, selection=False,
                   fabric=FabricConfig(num_modules=4, placement="affinity",
                                       affinity_block=4)),
        replicas=2, batch=4, burst=True),
}


def _bits(t):
    """A tensor's bits, so that a NaN or a signed zero compares too."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_bit_equal(got, want, what):
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, i)
        assert torch.equal(_bits(a), _bits(b)), (what, i)


def _requests(rng, shape, pages):
    need = ((rng.zipf(1.3, shape) - 1) % pages).astype(np.int32)
    return (need, rng.integers(0, 7, shape).astype(np.int32),
            rng.random(shape) < 0.4)


def _window(start, step, page_tokens):
    """The paged serve loop's requests at decode step `step` of
    sequences that started at positions `start` (B,)."""
    b = start.shape[0]
    return paged_request_window(start + step, torch.arange(b), page_tokens,
                                4, 16)


def drive(case, dev, schedule):
    """STEPS steps of the case's store on `dev` with
    `daemon_store._schedule` replaced by `schedule` (same signature).
    Returns the final state."""
    store = DS.KVStoreConfig(**case["store"])
    m = store.fabric.num_modules
    c, b = case["replicas"], case["batch"]
    link = None
    if case["burst"]:
        link = scheduled_link(DS.link_bytes_per_step(store),
                              make_link_schedule("burst", float(STEPS), m,
                                                 knots=8), m, device=dev)
    rng = np.random.default_rng(7)
    start = torch.from_numpy(rng.integers(0, 160, b).astype(np.int32))
    pages = 16 * (b if c is None else c * b)
    row = (store.page_tokens, store.kv_heads, store.head_dim)
    remote = torch.from_numpy(rng.standard_normal((pages,) + row).astype(
        np.float32)).to(torch.bfloat16).to(dev)
    shape = (b, 4) if c is None else (c, b, 4)
    saved = DS._schedule
    DS._schedule = schedule
    try:
        if c is None:
            state = DS.init_kv_store_batch(store, b, link=link, device=dev)
        else:
            state = DS.init_kv_store_replicated(store, c, b, link=link,
                                                device=dev)
        for i in range(STEPS):
            if case.get("window"):
                reqs = _window(start, i, store.page_tokens)
            else:
                reqs = (torch.from_numpy(x)
                        for x in _requests(rng, shape, pages))
            need, offs, wr = (x.to(dev) for x in reqs)
            step = (DS.step_fetch_batch if c is None
                    else DS.step_fetch_replicated)
            state, *_ = step(state, store, remote, remote, need, offs, wr)
    finally:
        DS._schedule = saved
    return state


def kernel_against_plain(calls):
    """A `_schedule` that runs the kernel and the plain fold on the same
    inputs, asserts every output bit-equal and the inputs untouched, and
    returns the plain fold's result."""
    def checked(eng, fab, cfg, need, offs, hit, clock, nic=None, cus=None,
                active=None):
        st = DS._fold_statics(cfg)
        args = (eng, fab, need, offs, hit, clock, st)
        before = [t.clone() for t in tree_leaves((eng, fab, nic))]
        got = ops.schedule_fold(*args, nic=nic, cus=cus, active=active,
                                impl="cuda")
        want = ops.schedule_fold(*args, nic=nic, cus=cus, active=active,
                                 impl="ref")
        _assert_bit_equal(got, want, f"step {len(calls)}")
        _assert_bit_equal(tree_leaves((eng, fab, nic)), before,
                          f"inputs of step {len(calls)}")
        calls.append(int(hit.numel()))
        return want
    return checked


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FOLD_CASES))
def test_kernel_matches_plain_fold_on_card(name):
    """The kernel against the plain fold on the card, every step of a
    drive through the real store: each engine and fabric leaf, the NIC
    leaves, line_sent, page_sent, stalls and the `seen` rows bit for bit,
    and the inputs bit-identical after the call; one launch a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check "
                    "on the card")
    calls = []
    SF.KERNEL.launches = 0
    state = drive(FOLD_CASES[name], torch.device("cuda"),
                  kernel_against_plain(calls))
    assert len(calls) == STEPS and SF.KERNEL.launches == STEPS
    led = DS.ledger(state)
    assert led["page_moves"] > 0 and led["local_hits"] > 0
    if not FOLD_CASES[name].get("window"):
        assert led["evictions"] > 0 and led["dirty_evicts"] > 0


def _cpu_step_args(nic: bool):
    store = DS.KVStoreConfig(**SMALL)
    if nic:
        state = DS.init_kv_store_replicated(store, 2, 2, device="cpu")
        extra = dict(nic=state.nic, cus=torch.tensor([0, 0, 1, 1]),
                     active=torch.tensor(True))
        b = 4
    else:
        state = DS.init_kv_store_batch(store, 2, device="cpu")
        extra = {}
        b = 2
    need = torch.zeros((b, 4), dtype=torch.int32)
    args = (state.seqs.eng, state.fab, need, need.clone(),
            torch.zeros((b, 4), dtype=torch.bool), state.clock + 1.0,
            DS._fold_statics(store))
    return args, extra


@pytest.mark.parametrize("nic", [False, True])
def test_cuda_impl_raises_on_cpu_tensors(nic):
    """impl="cuda" launches the kernel or raises: CPU tensors are refused
    before anything is built or launched."""
    args, extra = _cpu_step_args(nic)
    launches = SF.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.schedule_fold(*args, **extra, impl="cuda")
    assert SF.KERNEL.launches == launches


@pytest.mark.parametrize("impl,kernel_calls", [("auto", 0), ("ref", 0),
                                               ("cuda", 1)])
def test_dispatch_picks_by_device_and_impl(monkeypatch, impl, kernel_calls):
    """On CPU tensors "auto" and "ref" run the plain fold; "cuda" goes to
    the kernel's wrapper, with no fallback."""
    args, extra = _cpu_step_args(False)
    seen = []
    monkeypatch.setattr(SF, "schedule_fold",
                        lambda *a, **k: seen.append(1) or "kernel")
    out = ops.schedule_fold(*args, **extra, impl=impl)
    assert len(seen) == kernel_calls
    assert (out == "kernel") == bool(kernel_calls)


@pytest.mark.parametrize("stepper", ["step_fetch", "step_fetch_batch",
                                     "step_fetch_replicated"])
def test_steppers_call_schedule_through_module_global(monkeypatch,
                                                       stepper):
    """Each stepper calls `daemon_store._schedule` through the module
    global exactly once a step, so a wrap of that name (the benchmark's
    traced runs label the store's parts so) sees every fold."""
    store = DS.KVStoreConfig(**SMALL)
    counted = []
    real = DS._schedule

    def counting(*args, **kwargs):
        counted.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(DS, "_schedule", counting)
    rng = np.random.default_rng(3)
    remote = torch.zeros((64, 4, 2, 16), dtype=torch.bfloat16)
    if stepper == "step_fetch":
        state, shape = DS.init_kv_store(store, device="cpu"), (4,)
    elif stepper == "step_fetch_batch":
        state = DS.init_kv_store_batch(store, 3, device="cpu")
        shape = (3, 4)
    else:
        state = DS.init_kv_store_replicated(store, 2, 2, device="cpu")
        shape = (2, 2, 4)
    for _ in range(5):
        need, offs, wr = (torch.from_numpy(x)
                          for x in _requests(rng, shape, 64))
        state, *_ = getattr(DS, stepper)(state, store, remote, remote, need,
                                         offs, wr)
    assert len(counted) == 5


def test_launch_layout_matches_cu_file():
    """The wrapper's pointer, integer and float arrays have the lengths
    the .cu launcher checks, its bank leaves are FabricState's in the
    .cu file's `Leaf` order, and its controller gain is
    `fabric.adapt_ratio_at`'s default."""
    src = (Path(SF.__file__).resolve().parents[1] / "csrc"
           / "schedule_fold.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kNumPtrs"]) == len(SF._PTRS) == 69
    assert int(consts["kNumInts"]) == 14
    assert int(consts["kNumFloats"]) == 11
    assert int(consts["kLeaves"]) == len(SF.LEAVES)
    leaf_enum = re.search(r"enum Leaf \{([^}]*)\}", src).group(1)
    names = [n.strip()[1:] for n in leaf_enum.split(",")]
    assert [n.lower() for n in names] == [f.replace("_", "")
                                          for f in SF.LEAVES]
    gain = inspect.signature(fabric.adapt_ratio_at).parameters["gain"]
    assert gain.default == SF.GAIN
    for i, key in enumerate(("needed_pages", "needed_offsets", "local_hit",
                             "clock", "cus", "active", "line_sent",
                             "page_sent", "stalls", "seen_busy",
                             "seen_ratio")):
        assert SF._PTRS.index(key) == 58 + i
        assert f"ptrs[{58 + i}]" in src
