"""Decode's weight products on the card.

Wrapper of the hand-written CUDA kernel ``csrc/decode_matmul.cu``: the
f32 sum of the exact products of bf16 activations (at most `MAX_ROWS`
rows) and a bf16 weight, each operand read once in bf16, with no f32
copy of either. It replaces no TPU kernel: the reference leaves these
products to XLA (``jnp.einsum(..., preferred_element_type=F32)``).

`plan` turns one of the weight-product forms of decode (`FORMS`) into
(E, M, K) x (E, K, N) or (E, N, K) by strides alone: the activation's
leading axes are M, a weight axis that the output keeps beside M is E
(the experts), and the product's result is written into an output laid
out as the spec's. The plain version ``ref.decode_matmul`` computes the
same product through the same plan; ``ops.decode_matmul`` picks between
them by the tensors' device, and ``layers.dot`` sends its bf16 products
to ``ops`` where the kernel takes them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels._build import CudaKernel

KERNEL = CudaKernel(
    "decode_matmul.cu", "decode_matmul_launch",
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] * 3
    + [ctypes.c_int] * 6 + [ctypes.c_void_p])

MAX_ROWS = 64               # rows of the activation (B * S) the kernel takes
CHUNK = 32                  # K is a multiple of this
BLOCK_COLS = 64             # output columns of one block (kBlockCols)
WARPS_K = 4                 # warps of a block across K (kWarpsK)
MAX_CLUSTER = 8             # blocks of a cluster across K
MIN_CHUNKS = 2              # chunks a warp gets at least, split over K
TARGET_BLOCKS = 2 * 132     # two blocks on each of the H100's SMs


class Plan(NamedTuple):
    """One product as the kernel sees it: out[e, m, n] = sum over (k1, k2)
    of A[e, m, k1, k2] * W[e, k1, k2, n] (KN) or W[e, n, k1, k2] (NK),
    each operand and the output by its strides (in elements) from its own
    first element. `k2_first` is the order in which ``torch.einsum``
    flattens the two contraction axes (by their letters): the plain
    version sums in that order so that it equals the widened einsum."""
    e: int
    m: int
    k1: int
    k2: int
    n: int
    nk: bool
    a_strides: tuple            # (e, m, k1, k2)
    w_strides: tuple            # KN (e, k1, k2, n); NK (e, n, k1, k2)
    out_shape: tuple
    out_strides: tuple          # (e, m); n is contiguous
    k2_first: bool
    ks: int                     # blocks of a cluster (`cluster_size`)


def _merge(sizes, strides):
    """(size, stride) of adjacent axes as one axis, or None where no
    single stride walks them."""
    m, stride = 1, 0
    for size, st in zip(sizes, strides):
        if size == 1:
            continue
        if m > 1 and stride != size * st:
            return None
        m, stride = m * size, st
    return m, stride


def _mm(a, w):
    """bsd,df->bsf (the MLP, the router): W (K, N)."""
    (b, s, k), (kw, n) = a.shape, w.shape
    rows = _merge(a.shape[:2], a.stride()[:2])
    if rows is None or kw != k:
        return None
    return dict(e=1, m=rows[0], k1=1, k2=k, n=n, nk=False,
                a_strides=(0, rows[1], 0, a.stride(2)),
                w_strides=(0, 0, w.stride(0), w.stride(1)),
                out_shape=(b, s, n), out_strides=(0, n))


def _qkv(a, w):
    """bsd,dnh->bsnh (q, k, v): W (K, N1, N2) with N = N1 N2."""
    (b, s, k), (kw, n1, n2) = a.shape, w.shape
    rows = _merge(a.shape[:2], a.stride()[:2])
    cols = _merge(w.shape[1:], w.stride()[1:])
    if rows is None or cols is None or kw != k:
        return None
    return dict(e=1, m=rows[0], k1=1, k2=k, n=n1 * n2, nk=False,
                a_strides=(0, rows[1], 0, a.stride(2)),
                w_strides=(0, 0, w.stride(0), cols[1]),
                out_shape=(b, s, n1, n2), out_strides=(0, n1 * n2))


def _o(a, w):
    """bsnh,nhd->bsd (o): the contraction over two axes (K1, K2)."""
    (b, s, k1, k2), (w1, w2, n) = a.shape, w.shape
    rows = _merge(a.shape[:2], a.stride()[:2])
    if rows is None or (w1, w2) != (k1, k2):
        return None
    return dict(e=1, m=rows[0], k1=k1, k2=k2, n=n, nk=False,
                a_strides=(0, rows[1], a.stride(2), a.stride(3)),
                w_strides=(0, w.stride(0), w.stride(1), w.stride(2)),
                out_shape=(b, s, n), out_strides=(0, n))


def _experts_in(a, w):
    """bsd,edf->bsef (expert gate and up): A broadcast over the E
    experts' W (E, K, N)."""
    (b, s, k), (e, kw, n) = a.shape, w.shape
    rows = _merge(a.shape[:2], a.stride()[:2])
    if rows is None or kw != k:
        return None
    return dict(e=e, m=rows[0], k1=1, k2=k, n=n, nk=False,
                a_strides=(0, rows[1], 0, a.stride(2)),
                w_strides=(w.stride(0), 0, w.stride(1), w.stride(2)),
                out_shape=(b, s, e, n), out_strides=(n, e * n))


def _experts_out(a, w):
    """bsef,efd->bsed (expert down): A (B, S, E, K) per expert."""
    (b, s, e, k), (ew, kw, n) = a.shape, w.shape
    rows = _merge(a.shape[:2], a.stride()[:2])
    if rows is None or (ew, kw) != (e, k):
        return None
    return dict(e=e, m=rows[0], k1=1, k2=k, n=n, nk=False,
                a_strides=(a.stride(2), rows[1], 0, a.stride(3)),
                w_strides=(w.stride(0), 0, w.stride(1), w.stride(2)),
                out_shape=(b, s, e, n), out_strides=(n, e * n))


def _head(a, w):
    """bsd,vd->bsv (the output head): W laid out (N, K)."""
    (b, s, k), (n, kw) = a.shape, w.shape
    rows = _merge(a.shape[:2], a.stride()[:2])
    if rows is None or kw != k:
        return None
    return dict(e=1, m=rows[0], k1=1, k2=k, n=n, nk=True,
                a_strides=(0, rows[1], 0, a.stride(2)),
                w_strides=(0, w.stride(0), 0, w.stride(1)),
                out_shape=(b, s, n), out_strides=(0, n))


# the forms by their specs written with letters in order of first use
FORMS = {"abc,cde->abde": _qkv, "abcd,cde->abe": _o, "abc,cd->abd": _mm,
         "abc,dce->abde": _experts_in, "abcd,cde->abce": _experts_out,
         "abc,dc->abd": _head}


@functools.lru_cache(maxsize=None)
def form_of(spec: str):
    """(planner, k2_first, ranks of the two operands) of an einsum spec
    that is one of `FORMS`, or None: the weight products of decode,
    whatever their letters."""
    names = {}
    canon = "".join(names.setdefault(c, chr(ord("a") + len(names)))
                    if c.isalpha() else c for c in spec)
    planner = FORMS.get(canon)
    if planner is None:
        return None
    sa, sw = spec.split("->")[0].split(",")
    # the two contraction letters of the o form, in the activation's order
    return planner, planner is _o and sa[3] < sa[2], len(sa), len(sw)


_PLANS = {}                 # plan's results by what they depend on
_MAX_PLANS = 4096


def plan(a, w, spec: str):
    """The kernel's `Plan` of `spec` on `a` and `w`, or None where the
    kernel does not take them: an unlisted spec, more than `MAX_ROWS`
    rows, axes no stride walks, a K that is not a multiple of `CHUNK`, or
    operands the kernel's vector loads cannot read (KN: 8-byte aligned,
    N and the strides multiples of 4 elements; NK: 16 bytes and 8). A
    plan depends on the shapes, the strides and the alignment alone, and
    is kept for the next call with the same (a decode step repeats its
    products layer after layer)."""
    key = (spec, a.shape, a.stride(), w.shape, w.stride(),
           a.data_ptr() % 16, w.data_ptr() % 16)
    p = _PLANS.get(key, False)
    if p is False:
        if len(_PLANS) >= _MAX_PLANS:
            _PLANS.clear()
        p = _PLANS[key] = _plan(a, w, spec)
    return p


def _plan(a, w, spec: str):
    form = form_of(spec)
    if form is None or (a.dim(), w.dim()) != form[2:]:
        return None
    planner, k2_first = form[:2]
    p = planner(a, w)
    if p is None or not 1 <= p["m"] <= MAX_ROWS or p["n"] < 1:
        return None
    k1, k2 = p["k1"], p["k2"]
    sae, sam, sak1, sak2 = p["a_strides"]
    ws = p["w_strides"]
    nk = p["nk"]
    # the contraction is one contiguous axis in both operands
    swe, swk1, swk2, swn = ((ws[0], ws[2], ws[3], ws[1]) if nk else ws)
    flat_a = sak2 == 1 and (k1 == 1 or sak1 == k2)
    if nk:
        flat_w, row = swk2 == 1 and (k1 == 1 or swk1 == k2), swn
    else:
        flat_w, row = swn == 1 and (k1 == 1 or swk1 == k2 * swk2), swk2
    vec = 8 if nk else 4
    if not (flat_a and flat_w and (k1 * k2) % CHUNK == 0
            and (nk or p["n"] % vec == 0)
            and a.data_ptr() % (2 * vec) == 0
            and w.data_ptr() % (2 * vec) == 0
            and sae % vec == 0 and sam % vec == 0
            and swe % vec == 0 and row % vec == 0):
        return None
    return Plan(k2_first=k2_first,
                ks=cluster_size(p["e"], k1 * k2, p["n"]), **p)


def cluster_size(e: int, k: int, n: int) -> int:
    """Blocks of a cluster across K: doubled while the launch has fewer
    than `TARGET_BLOCKS` blocks and each warp keeps `MIN_CHUNKS` chunks."""
    blocks = -(-n // BLOCK_COLS) * e
    chunks = k // CHUNK
    ks = 1
    while (ks < MAX_CLUSTER and blocks * ks < TARGET_BLOCKS
           and chunks >= MIN_CHUNKS * WARPS_K * 2 * ks):
        ks *= 2
    return ks


def require_plan(a, w, spec: str) -> Plan:
    """`plan(a, w, spec)`, raising where it is None."""
    p = plan(a, w, spec)
    if p is None:
        raise ValueError(f"the decode matmul kernel does not take {spec!r} "
                         f"on {tuple(a.shape)} x {tuple(w.shape)}")
    return p


def _check(name, t):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name} must be torch.bfloat16, got {t.dtype}")


def decode_matmul(a, w, spec: str, p: Plan | None = None):
    """The f32 product of bf16 CUDA tensors `a` and `w` by `spec`, one
    launch, no host read, no synchronise; `p` is `plan(a, w, spec)` where
    the caller has it. Raises on operands the kernel does not take."""
    _check("a", a)
    _check("w", w)
    if p is None:
        p = require_plan(a, w, spec)
    out = torch.empty(p.out_shape, dtype=torch.float32, device=a.device)
    sae, sam = p.a_strides[:2]
    swe, swr = ((p.w_strides[0], p.w_strides[1]) if p.nk
                else (p.w_strides[0], p.w_strides[2]))
    KERNEL.launch(a.data_ptr(), sae, sam, w.data_ptr(), swe, swr,
                  out.data_ptr(), *p.out_strides, p.e, p.m, p.k1 * p.k2,
                  p.n, int(p.nk), p.ks)
    return out
