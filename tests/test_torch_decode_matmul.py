"""Decode's weight products (`ops.decode_matmul`, `layers.dot` on the
card): the CUDA kernel against the f64 product, and its plan, plain
version and dispatch on the CPU.

The kernel sums the exact bf16 x bf16 products in f32 in its own order,
so on the card it is held to the f64 product within f32 accumulation
error (`K * 2^-24 * sum|a||w|`, `test_torch_options`' bound) and never to
the bf16-rounded GEMM output; two launches give the same bits. On the
CPU the plain version, run through the kernel's own plan (its strides
and views), equals `dot`'s widened einsum bit for bit at every form of
decode, at reduced and at the benchmark cells' shapes; `dot` sends a
product to the kernel only where every condition holds, and widens
everything else exactly as before. With the card's route rehearsed on
the CPU (`layers._on_card` patched, so `ops` runs the plain version), a
reduced qwen3 and a reduced OLMoE decode step take every weight product
through the route, bit for bit the widened step, and the `model.decode`
span counts them. The file imports no JAX: run its `cuda` tests on the
card with `-m cuda --noconftest`."""
import contextlib
import dataclasses
import re
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import decode_matmul as DM
from repro_torch.kernels import ops
from repro_torch.kernels import ref as REF
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.models.layers import padded_vocab
from repro_torch.runtime.obs import SpanRecorder

BF16 = torch.bfloat16

# (spec, activation shape, weight shape): each weight product of decode at
# the cells' shapes (B = 16) and at a reduced size
QWEN3_V, OLMOE_V = padded_vocab(151936), padded_vocab(50304)
FORMS = {
    "qwen3.q": ("bsd,dnh->bsnh", (16, 1, 2048), (2048, 16, 128)),
    "qwen3.kv": ("btd,dkh->btkh", (16, 1, 2048), (2048, 8, 128)),
    "qwen3.o": ("bsnh,nhd->bsd", (16, 1, 16, 128), (16, 128, 2048)),
    "qwen3.gate": ("bsd,df->bsf", (16, 1, 2048), (2048, 6144)),
    "qwen3.down": ("bsf,fd->bsd", (16, 1, 6144), (6144, 2048)),
    "qwen3.head": ("bsd,vd->bsv", (16, 1, 2048), (QWEN3_V, 2048)),
    "olmoe.kv": ("btd,dkh->btkh", (16, 1, 2048), (2048, 16, 128)),
    "olmoe.router": ("bsd,de->bse", (16, 1, 2048), (2048, 64)),
    "olmoe.experts_in": ("bsd,edf->bsef", (16, 1, 2048), (64, 2048, 1024)),
    "olmoe.experts_out": ("bsef,efd->bsed", (16, 1, 64, 1024),
                          (64, 1024, 2048)),
    "olmoe.head": ("bsd,vd->bsv", (16, 1, 2048), (OLMOE_V, 2048)),
    "reduced.q": ("bsd,dnh->bsnh", (2, 1, 64), (64, 4, 16)),
    "reduced.o": ("bsnh,nhd->bsd", (3, 1, 4, 16), (4, 16, 64)),
    "reduced.mlp": ("bsd,df->bsf", (4, 3, 64), (64, 128)),
    "reduced.router": ("bsd,de->bse", (2, 1, 64), (64, 8)),
    "reduced.experts_in": ("bsd,edf->bsef", (2, 1, 64), (8, 64, 32)),
    "reduced.experts_out": ("bsef,efd->bsed", (2, 1, 8, 32), (8, 32, 64)),
    "reduced.head": ("bsd,vd->bsv", (5, 1, 64), (512, 64)),
}
CELL = [f for f in FORMS if not f.startswith("reduced.")]


def _operands(name, seed=0, device="cpu"):
    spec, sa, sw = FORMS[name]
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.empty(sa, dtype=BF16, device=device).uniform_(
        -1, 1, generator=gen)
    w = torch.empty(sw, dtype=BF16, device=device).uniform_(
        -1, 1, generator=gen)
    return spec, a, w


def _widened(spec, a, w):
    """`dot`'s widened product: the parent's f32 path."""
    return torch.einsum(spec, a.float(), w.float())


# ------------------------------------------------------------------- CPU
@pytest.mark.parametrize("name", sorted(FORMS))
def test_plain_through_the_plan_is_the_widened_product(name):
    """The plain version reads the operands through the kernel's plan
    (views of the same storage, no copy of an operand's layout) and
    equals the widened einsum bit for bit."""
    spec, a, w = _operands(name)
    p = DM.plan(a, w, spec)
    assert p is not None, "the kernel takes every form at these shapes"
    want = _widened(spec, a, w)
    got = REF.decode_matmul(a, w, spec, p)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)


def test_plan_reads_strides_without_copies():
    """The o projection's input as decode attention leaves it (a permuted
    einsum output) and the experts' down input (B, S, E, F) are planned
    by strides; the experts' gate input is broadcast over E (stride 0)."""
    p_, v_ = (torch.randn(s).to(BF16) for s in ((16, 4, 1, 10),
                                                (16, 10, 4, 32)))
    out = torch.einsum("bnst,btnh->bsnh", p_.float(), v_.float()).to(BF16)
    w = torch.randn(4, 32, 64).to(BF16)
    p = DM.plan(out, w, "bsnh,nhd->bsd")
    assert (p.m, p.k1, p.k2, p.n, p.nk) == (16, 4, 32, 64, False)
    assert p.a_strides == (0,) + out.stride()[:1] + out.stride()[2:]
    assert p.k2_first        # einsum takes h before n
    assert torch.equal(REF.decode_matmul(out, w, "bsnh,nhd->bsd", p),
                       _widened("bsnh,nhd->bsd", out, w))
    _, x, we = _operands("reduced.experts_in")
    assert DM.plan(x, we, "bsd,edf->bsef").a_strides[0] == 0
    _, h, wd = _operands("reduced.experts_out")
    assert DM.plan(h, wd, "bsef,efd->bsed").a_strides[:2] == (32, 8 * 32)


@pytest.mark.parametrize("case", ["unlisted", "rows_65", "k_not_32",
                                  "n_not_4", "misaligned", "rows_strided",
                                  "wrong_rank"])
def test_plan_refuses_what_the_kernel_does_not_take(case):
    x = torch.randn(16, 1, 64).to(BF16)
    w = torch.randn(64, 32).to(BF16)
    spec = "bsd,df->bsf"
    if case == "unlisted":
        spec, w = "bsnh,btnh->bnst", torch.randn(16, 5, 4, 16).to(BF16)
        x = x.view(16, 1, 4, 16)
    elif case == "rows_65":
        x = torch.randn(65, 1, 64).to(BF16)
    elif case == "k_not_32":
        x, w = x[..., :48], w[:48]
    elif case == "n_not_4":
        w = torch.randn(64, 30).to(BF16)
    elif case == "misaligned":
        x = torch.randn(16 * 64 + 1).to(BF16)[1:].view(16, 1, 64)
    elif case == "rows_strided":
        x = torch.randn(4, 8, 64).to(BF16)[:, :4]      # (4, 4, 64)
    elif case == "wrong_rank":
        x = x[:, 0]
    assert DM.plan(x, w, spec) is None


def test_launch_geometry_at_the_cells():
    """A cluster across K only where the columns x experts leave the card
    short of two blocks an SM, and every warp keeps two chunks; the .cu
    file's layout constants are the wrapper's."""
    want = {"qwen3.q": 8, "qwen3.kv": 8, "qwen3.o": 8, "qwen3.gate": 4,
            "qwen3.down": 8, "qwen3.head": 1, "olmoe.kv": 8,
            "olmoe.router": 8, "olmoe.experts_in": 1,
            "olmoe.experts_out": 1, "olmoe.head": 1}
    for name in CELL:
        spec, sa, sw = FORMS[name]
        a, w = torch.empty(sa, dtype=BF16), torch.empty(sw, dtype=BF16)
        p = DM.plan(a, w, spec)
        assert p.ks == want[name], name
        chunks = p.k1 * p.k2 // DM.CHUNK
        assert chunks // (p.ks * DM.WARPS_K) >= DM.MIN_CHUNKS
    src = (Path(DM.__file__).resolve().parents[1] / "csrc"
           / "decode_matmul.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const("kWarpsK") == DM.WARPS_K
    assert const("kWarpsN") * const("kWarpCols") == DM.BLOCK_COLS
    assert const("kChunk") == DM.CHUNK
    assert const("kMaxRows") == DM.MAX_ROWS
    assert const("kMaxCluster") == DM.MAX_CLUSTER


def test_cuda_impl_raises_on_cpu_tensors():
    """impl="cuda" launches the kernel or raises: CPU tensors are refused
    before anything is built or launched."""
    spec, a, w = _operands("reduced.mlp")
    launches = DM.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.decode_matmul(a, w, spec, impl="cuda")
    assert DM.KERNEL.launches == launches


@pytest.mark.parametrize("impl,kernel_calls", [("auto", 0), ("ref", 0),
                                               ("cuda", 1)])
def test_dispatch_picks_by_device_and_impl(monkeypatch, impl, kernel_calls):
    """On CPU tensors "auto" and "ref" run the plain version; "cuda" goes
    to the kernel's wrapper, with no fallback."""
    spec, a, w = _operands("reduced.mlp")
    seen = []
    monkeypatch.setattr(DM, "decode_matmul",
                        lambda *args: seen.append(1) or "kernel")
    out = ops.decode_matmul(a, w, spec, impl=impl)
    assert len(seen) == kernel_calls
    if kernel_calls:
        assert out == "kernel"
    else:
        assert torch.equal(out, _widened(spec, a, w))


@pytest.fixture
def on_card(monkeypatch):
    """The card's route rehearsed on the CPU: `dot` takes CPU tensors for
    the card's, and `ops` runs the plain version for the kernel (CPU
    tensors); returns the list of the specs that went that way."""
    monkeypatch.setattr(layers, "_on_card", lambda a, b: True)
    routed = []
    route = ops.decode_matmul

    def counted(a, w, spec, plan=None, impl="auto"):
        routed.append(spec)
        return route(a, w, spec, plan, impl)
    monkeypatch.setattr(ops, "decode_matmul", counted)
    return routed


@pytest.fixture
def dtensor():
    """A world-1 gloo mesh; makes a replicated DTensor of a tensor."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch import mesh as mesh_mod
    mesh_mod.init_distributed("cpu")
    try:
        mesh = mesh_mod.build_mesh((1,), ("data",))
        yield lambda t: distribute_tensor(t, mesh, [Replicate()])
    finally:
        mesh_mod.shutdown_distributed()


DOT_CASES = {
    # case: (kernel products, widened products)
    "listed": (1, 0),
    "kv_letters": (1, 0),
    "grad": (0, 1),
    "grad_off": (1, 0),
    "rows_65": (0, 1),
    "f32": (0, 1),
    "bf16_out": (0, 0),
    "unlisted": (0, 0),
    "op_counter": (0, 1),
    "dtensor": (0, 1),
}


@pytest.mark.parametrize("case", sorted(DOT_CASES))
def test_dot_routes_only_the_listed_products(on_card, case, request):
    """With the card's route rehearsed: a listed weight product of bf16
    operands takes the kernel's route; under grad, above 64 rows, on f32
    operands, under an op counter or on DTensors it widens (counted);
    with a bf16 `out_dtype` or an unlisted spec it takes its old path
    (not counted). Every result is bit for bit the parent's."""
    from repro_torch.launch.op_analysis import OpCounter
    spec, a, w = _operands("reduced.mlp")
    out_dtype, mode = torch.float32, None
    if case == "kv_letters":
        spec, a, w = _operands("reduced.q")
        spec = "btd,dkh->btkh"
    elif case in ("grad", "grad_off"):
        w.requires_grad_(True)
    elif case == "rows_65":
        a = torch.randn(65, 1, 64).to(BF16)
    elif case == "f32":
        a, w = a.float(), w.float()
    elif case == "bf16_out":
        out_dtype = BF16
    elif case == "unlisted":
        spec = "bsd,df->bfs"
    elif case == "op_counter":
        mode = OpCounter()
    elif case == "dtensor":
        wrap = request.getfixturevalue("dtensor")
        a, w = wrap(a), wrap(w)
    before = (layers.dot_counts.kernel, layers.dot_counts.widened)
    with torch.set_grad_enabled(case != "grad_off"), \
            (mode or contextlib.nullcontext()):
        got = layers.dot(a, w, spec, out_dtype=out_dtype)
    counts = (layers.dot_counts.kernel - before[0],
              layers.dot_counts.widened - before[1])
    assert counts == DOT_CASES[case]
    assert on_card == [spec] * counts[0]
    if case == "dtensor":
        got, a, w = got.full_tensor(), a.full_tensor(), w.full_tensor()
    if out_dtype == torch.float32:
        want = torch.einsum(spec, a.detach().float(), w.detach().float())
    else:
        want = torch.einsum(spec, a, w).to(out_dtype)
    assert got.dtype == want.dtype and torch.equal(got.detach(), want)


def test_dot_on_cpu_tensors_widens_and_counts_nothing():
    spec, a, w = _operands("reduced.q")
    before = (layers.dot_counts.kernel, layers.dot_counts.widened)
    assert torch.equal(layers.dot(a, w, spec), _widened(spec, a, w))
    assert (layers.dot_counts.kernel, layers.dot_counts.widened) == before


def test_dot_under_a_fake_mode_widens(on_card):
    """The dry run's fake tensors keep the widened einsum (counted)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    spec, a, w = _operands("reduced.mlp")
    before = layers.dot_counts.widened
    with FakeTensorMode(allow_non_fake_inputs=True):
        got = layers.dot(a, w, spec)
    assert got.shape == (4, 3, 128) and got.dtype == torch.float32
    assert on_card == [] and layers.dot_counts.widened == before + 1


ARCHS = {"qwen3-1.7b": 7, "olmoe-1b-7b": 8}     # weight products a layer


def _decode_counts(arch, steps=3):
    """A reduced bf16 `arch` decoding `steps` tokens (B = 3) under a
    recorder: (logits of each step, the `model.decode` spans' counts)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    opt = M.ModelOptions(remat="none")
    params = M.init_model(cfg, torch.Generator().manual_seed(0),
                          dtype=BF16)
    tokens = torch.randint(0, cfg.vocab_size, (3, steps),
                           generator=torch.Generator().manual_seed(1))
    state = M.init_decode_state(cfg, 3, steps, opt, device="cpu")
    rec, logits = SpanRecorder(), []
    with rec.active(), torch.no_grad():
        for pos in range(steps):
            out, state = M.decode_step(params, cfg, state,
                                       tokens[:, pos:pos + 1], pos, opt)
            logits.append(out)
    counts = [(e["args"]["dot_kernel"], e["args"]["dot_widened"])
              for e in rec.events if e["name"] == "model.decode"]
    return cfg, logits, counts


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decode_span_counts_on_cpu(arch):
    """On the CPU no product goes to the kernel and none counts as
    widened on the card."""
    _, _, counts = _decode_counts(arch)
    assert counts == [(0, 0)] * 3


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decode_step_through_the_route_is_the_widened_step(arch, on_card,
                                                           monkeypatch):
    """Every weight product of a reduced decode step takes the route
    (layers x products a layer + the head, none widened), and the step's
    logits are the widened step's bit for bit."""
    cfg, routed, counts = _decode_counts(arch)
    monkeypatch.setattr(layers, "_on_card", lambda a, b: False)
    _, widened, none = _decode_counts(arch)
    per_step = cfg.num_layers * ARCHS[arch] + 1
    assert counts == [(per_step, 0)] * 3 and none == [(0, 0)] * 3
    assert len(on_card) == 3 * per_step
    assert all(torch.equal(r, w) for r, w in zip(routed, widened))


# ------------------------------------------------------------------ card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py's [decode_matmul] "
                    "runs these checks on the card")
    return torch.device("cuda")


def _within_f32_accumulation(got, spec, a, w):
    """`got` within f32 accumulation error of the f64 product of bf16
    `a`, `w`, not the bf16-rounded GEMM output, and nearer the f64
    product than that output is. Returns the largest error."""
    a64, w64 = a.double(), w.double()
    exact = torch.einsum(spec, a64, w64)
    scale = torch.einsum(spec, a64.abs(), w64.abs())
    sa, rest = spec.split(",")
    k = 1
    for letter, size in zip(sa, a.shape):
        if letter not in rest.split("->")[1]:
            k *= size
    err = (got.double() - exact).abs()
    assert got.dtype == torch.float32
    assert bool((err <= k * 2.0 ** -24 * scale).all())
    rounded = torch.einsum(spec, a, w).float()
    assert not torch.equal(got, rounded)
    assert err.max() < (rounded.double() - exact).abs().max()
    return float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FORMS))
def test_kernel_within_f32_accumulation_of_f64_on_card(name):
    dev = _card()
    spec, a, w = _operands(name, device=dev)
    got = DM.decode_matmul(a, w, spec)
    _within_f32_accumulation(got, spec, a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELL)
def test_kernel_bit_identical_across_launches_on_card(name):
    dev = _card()
    spec, a, w = _operands(name, device=dev)
    first = DM.decode_matmul(a, w, spec)
    assert torch.equal(first, DM.decode_matmul(a, w, spec))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELL)
def test_dot_is_one_launch_per_product_on_card(name):
    dev = _card()
    spec, a, w = _operands(name, device=dev)
    launches, kernel = DM.KERNEL.launches, layers.dot_counts.kernel
    with torch.no_grad():
        got = layers.dot(a, w, spec)
    assert DM.KERNEL.launches == launches + 1
    assert layers.dot_counts.kernel == kernel + 1
    assert torch.equal(got, DM.decode_matmul(a, w, spec))
