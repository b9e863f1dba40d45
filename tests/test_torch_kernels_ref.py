"""The port's plain kernel versions against the reference's.

`fused_residency_step` on the `_rand_case` snapshots of
tests/test_residency_fused.py (plus three more geometries) under every
policy, the same-set overflow case, and `paged_gather` / `paged_scatter`
including clamped and dropped indices. Everything must be equal. The
CUDA kernels are held to these plain versions on the card by
chip_smoke.py; `test_kernels_match_plain_on_card` repeats that here when
a card is present.

The CUDA K1 reads each request's row without waiting for the landing
stores (a slot landed this step is read from the remote row that lands
there), takes a set's victims from one sort of its (score, way) keys,
and lays its launch out in `launch_geometry`; the tests below hold those
three premises against the reference on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import residency as JR
from repro.kernels import ref as JK
from repro_torch.core import residency as TR
from repro_torch.kernels import ops
from repro_torch.kernels import ref as TK
from repro_torch.kernels import residency_fused as TRF

from test_residency_fused import _rand_case

torch.set_num_threads(1)

POLICY_NAMES = ("lru", "fifo", "rrip", "dirty-averse")
OUT_NAMES = ("res.page", "res.age", "res.ready", "res.dirty", "res.rrpv",
             "kpool", "vpool", "evicted", "n_ev", "k_local", "v_local",
             "hit")
CASES = [dict(), dict(s=1, w=12), dict(s=4, w=3), dict(s=16, w=4, p=9)]


def _to_torch(args):
    res, *rest = args
    t_res = TR.ResidencyState(*(torch.from_numpy(np.array(x)) for x in res))
    return (t_res,) + tuple(torch.from_numpy(np.array(x)) for x in rest)


def _flat(out):
    return list(out[0]) + list(out[1:])


def _assert_same(ref_out, port_out):
    for name, a, b in zip(OUT_NAMES, _flat(ref_out), _flat(port_out)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=name)


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("pol_name", POLICY_NAMES)
def test_fused_residency_step_matches_reference(case, pol_name):
    for seed in (0, 1, 2):
        args = _rand_case(seed, **CASES[case])
        ref = JK.fused_residency_step(*args, JR.as_policy(pol_name))
        port = TK.fused_residency_step(*_to_torch(args),
                                       TR.as_policy(pol_name))
        _assert_same(ref, port)


@pytest.mark.parametrize("pol_name", POLICY_NAMES)
def test_fused_same_set_overflow_drops(pol_name):
    s, w, p, pr = 2, 2, 6, 32
    row = (2, 1, 4)
    rng = np.random.default_rng(0)
    res = jax.tree.map(lambda x: x[None], JR.init_residency(s, w))
    rk = rng.standard_normal((pr,) + row).astype(np.float32)
    args = (res, np.zeros((1, s * w) + row, np.float32),
            np.zeros((1, s * w) + row, np.float32), rk, rk,
            np.ones((1, p), bool),
            np.array([[0, 2, 4, 6, 8, 10]], np.int32),
            np.array([[0, 2, 4]], np.int32), np.zeros((1, 3), bool),
            np.float32(1.0))
    ref = JK.fused_residency_step(*(jnp.asarray(a) if i else a
                                    for i, a in enumerate(args)),
                                  JR.as_policy(pol_name))
    port = TK.fused_residency_step(*_to_torch(args),
                                   TR.as_policy(pol_name))
    _assert_same(ref, port)
    assert set(port[0].page[0, 0].tolist()) == {0, 2}
    assert port[7].tolist() == [[True, True, False]]


def test_paged_gather_clamps_and_masks():
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((8, 2, 1, 4)).astype(np.float32)
    idx = np.array([3, -2, 7, 11, 0], np.int32)
    ref = JK.paged_gather(jnp.asarray(pool), jnp.asarray(idx))
    got = ops.paged_gather(torch.from_numpy(pool), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    mask = np.array([True, False, True, True, False])
    got = ops.paged_gather(torch.from_numpy(pool), torch.from_numpy(idx),
                           torch.from_numpy(mask))
    want = np.where(mask[:, None, None, None], np.asarray(ref), 0.0)
    np.testing.assert_array_equal(got.numpy(), want)
    got_k, got_v = ops.paged_gather_pair(
        torch.from_numpy(pool), torch.from_numpy(-pool),
        torch.from_numpy(idx), torch.from_numpy(mask))
    np.testing.assert_array_equal(got_k.numpy(), want)
    np.testing.assert_array_equal(got_v.numpy(), -want)


def test_paged_scatter_drop_never_clobbers():
    rng = np.random.default_rng(1)
    pool = rng.standard_normal((6, 3)).astype(np.float32)
    pages = rng.standard_normal((5, 3)).astype(np.float32)
    idx = np.array([6, 2, -1, 4, -9], np.int32)      # lanes 0, 4 dropped
    ref = JK.paged_scatter(jnp.asarray(pool), jnp.asarray(idx),
                           jnp.asarray(pages), mode="drop")
    got = ops.paged_scatter(torch.from_numpy(pool.copy()),
                            torch.from_numpy(idx), torch.from_numpy(pages),
                            mode="drop")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    none_live = np.array([-7, 9], np.int32)
    got = ops.paged_scatter(torch.from_numpy(pool.copy()),
                            torch.from_numpy(none_live),
                            torch.from_numpy(pages[:2]), mode="drop")
    np.testing.assert_array_equal(got.numpy(), pool)


# Fully associative (one set; 40 ways take the block-wide path) and
# set-associative geometries, each with requests that hit this step's
# landings.
DATAFLOW_CASES = [dict(s=1, w=12, p=9), dict(s=1, w=40, p=12, pr=96),
                  dict(s=4, w=3, p=9), dict(s=16, w=4, p=9, pr=96)]


def _with_landing_requests(args):
    """Request 0 asks for a page landing this step (it hits the victim
    slot just filled); request 1 for a page of a landing lane's set that
    is nowhere resident (a miss, which reads the set's way 0)."""
    res, kpool, vpool, rk, rv, landed, lp, needed, writes, clock = args
    page = np.asarray(res.page)
    s = page.shape[1]
    lp_np, needed = np.asarray(lp), np.array(needed)
    for bi in range(page.shape[0]):
        pid = int(lp_np[bi].max())
        if pid < 0:
            continue
        needed[bi, 0] = pid
        miss = pid + s
        while miss in page[bi] or miss in lp_np[bi]:
            miss += s
        needed[bi, 1] = miss
    return (res, kpool, vpool, rk, rv, landed, lp, jnp.asarray(needed),
            writes, clock)


def _overflow_case():
    s, w, p, pr = 2, 2, 6, 32
    rng = np.random.default_rng(0)
    res = jax.tree.map(lambda x: x[None], JR.init_residency(s, w))
    rk = jnp.asarray(rng.standard_normal((pr, 2, 1, 4)), jnp.float32)
    pool = jnp.asarray(rng.standard_normal((1, s * w, 2, 1, 4)),
                       jnp.float32)
    return (res, pool, pool + 1.0, rk, rk - 1.0, jnp.ones((1, p), bool),
            jnp.asarray([[0, 2, 4, 6, 8, 10]], jnp.int32),
            jnp.asarray([[0, 2, 4, 1]], jnp.int32), jnp.zeros((1, 4), bool),
            jnp.asarray(1.0, jnp.float32))


def _landing_lanes(args, pol_name, bi):
    """Sequence bi's compacted landing lanes as the reference takes them:
    (pids, sets, ways, live), live = landed and not a same-set overflow."""
    res, _, _, _, _, landed, lp = args[:7]
    page = np.asarray(res.page)
    k = min(landed.shape[1], page.shape[1] * page.shape[2])
    pick = np.argsort(~np.asarray(landed[bi]), kind="stable")[:k]
    pids = np.asarray(lp[bi])[pick]
    one = JR.ResidencyState(*(x[bi] for x in res))
    sets, ways, ok = JR.landing_victims(one, jnp.asarray(pids),
                                        JR.as_policy(pol_name))
    live = np.asarray(landed[bi])[pick] & np.asarray(ok)
    return pids, np.asarray(sets), np.asarray(ways), live


@pytest.mark.parametrize("case", range(len(DATAFLOW_CASES) + 1))
@pytest.mark.parametrize("pol_name", POLICY_NAMES)
def test_fused_rows_read_without_landing_barrier(case, pol_name):
    """The reference's k_local / v_local are the rows the CUDA K1 reads
    with no barrier after its landing stores: remote[clamp(pid)] where
    the probed slot (a miss's way-0 slot too) is a landing victim of this
    step, the pre-step pool row otherwise."""
    landed_reads = 0
    for seed in (0, 1, 2):
        if case < len(DATAFLOW_CASES):
            args = _with_landing_requests(
                _rand_case(seed, **DATAFLOW_CASES[case]))
        else:
            args = _overflow_case()
        ref = JK.fused_residency_step(*args, JR.as_policy(pol_name))
        res, kpool, vpool, rk, rv, _, _, needed = args[:8]
        kpool, vpool = np.asarray(kpool), np.asarray(vpool)
        rk, rv, needed = np.asarray(rk), np.asarray(rv), np.asarray(needed)
        b, s, w = np.asarray(res.page).shape
        out_page = np.asarray(ref[0].page)      # after insert (and touch)
        for bi in range(b):
            pids, sets, ways, live = _landing_lanes(args, pol_name, bi)
            landed_row = {int(st) * w + int(wy): int(np.clip(pg, 0,
                                                             len(rk) - 1))
                          for pg, st, wy, ok in zip(pids, sets, ways, live)
                          if ok}
            for r, pg in enumerate(needed[bi]):
                st = int(pg) % s
                found = np.flatnonzero(out_page[bi, st] == pg)
                slot = st * w + (int(found[0]) if found.size else 0)
                if slot in landed_row:
                    landed_reads += 1
                    want_k, want_v = rk[landed_row[slot]], rv[landed_row[slot]]
                else:
                    want_k, want_v = kpool[bi, slot], vpool[bi, slot]
                np.testing.assert_array_equal(np.asarray(ref[5])[bi, r],
                                              want_k)
                np.testing.assert_array_equal(np.asarray(ref[6])[bi, r],
                                              want_v)
    assert landed_reads > 0


def _bitonic32(score, way):
    """The CUDA K1's warp sort, lane for lane: a bitonic network over 32
    (score, way) keys; lane i ends with the i-th smallest."""
    score, way = list(score), list(way)
    k = 2
    while k <= 32:
        j = k // 2
        while j > 0:
            new_s, new_w = score[:], way[:]
            for lane in range(32):
                o = lane ^ j
                keep_min = ((lane & j) == 0) == ((lane & k) == 0)
                other_less = (score[o], way[o]) < (score[lane], way[lane])
                if keep_min == other_less:
                    new_s[lane], new_w[lane] = score[o], way[o]
            score, way = new_s, new_w
            j //= 2
        k *= 2
    return way


def _np_score(age, dirty, rrpv, pol_name):
    """repro.core.residency._score in numpy f32, op for op."""
    f = np.float32
    spec = TR.POLICIES[pol_name]
    amin = age.min()
    span = f(age.max() - amin) + f(1.0)
    if spec.rrip:
        return f(f(3.0) - rrpv) * span + f(age - amin)
    return age + np.where(dirty, f(spec.dirty_penalty) * span, f(0.0))


@pytest.mark.parametrize("case", range(len(DATAFLOW_CASES)))
@pytest.mark.parametrize("pol_name", POLICY_NAMES)
def test_landing_victims_are_stable_score_way_order(case, pol_name):
    """Each set's landing victims, lane by lane in rank order, are its
    ways in (score, way) order — the stable argsort — and for W <= 32 the
    kernel's 32-lane bitonic network yields that order. Ages are floored
    so that ties are common."""
    sorted_sets = 0
    for seed in (0, 1, 2):
        args = list(_rand_case(seed, **DATAFLOW_CASES[case]))
        res = args[0]
        args[0] = res._replace(age=jnp.floor(res.age))
        res = args[0]
        age, dirty, rrpv = (np.asarray(x) for x in (res.age, res.dirty,
                                                    res.rrpv))
        b, s, w = age.shape
        for bi in range(b):
            pids, sets, ways, live = _landing_lanes(args, pol_name, bi)
            for st in np.unique(sets[live]):
                sc = _np_score(age[bi, st], dirty[bi, st], rrpv[bi, st],
                               pol_name).astype(np.float32)
                order = sorted(range(w), key=lambda x: (sc[x], x))
                got = [int(wy) for wy, x, ok in zip(ways, sets, live)
                       if ok and x == st]
                assert got == order[:len(got)]
                if w <= 32:
                    pad = [np.inf] * (32 - w)
                    net = _bitonic32(list(sc) + pad,
                                     list(range(w)) + list(range(w, 32)))
                    assert net[:w] == order
                sorted_sets += 1
    assert sorted_sets > 0


# (batch, sets, ways, in-flight lanes, requests, row bytes): a tiny test
# shape, the 48-step drive's, the serving shape in both geometries, and
# the store benchmark's hot path in both.
GEOMETRY_SHAPES = [(2, 4, 3, 6, 5, 32), (8, 4, 4, 256, 4, 256),
                   (256, 256, 16, 16, 4, 64),
                   (8, 256, 16, 256, 4, 32768), (8, 1, 4096, 256, 4, 32768),
                   (64, 256, 16, 16, 4, 64), (64, 1, 4096, 16, 4, 64)]


@pytest.mark.parametrize("shape", GEOMETRY_SHAPES)
def test_k1_launch_geometry(shape):
    """The K1 launch fits a Hopper block's shared memory, gives each
    sequence 2 to 32 blocks with the grid resident at once where 2 per
    sequence allow it, bounds the touched sets by the landed lanes plus
    the requests, and has ranks 1..C-1 cover every set's metadata copy
    and every row column exactly once."""
    b, s, w, p, r, row = shape
    geo = TRF.launch_geometry(b, s, w, p, r, row)
    assert geo.smem <= 232448
    per_sm = min(2, 233472 // (geo.smem + 1024))
    assert 2 <= geo.blocks <= 32
    assert geo.grid == b * geo.blocks
    assert geo.grid <= per_sm * 132 or geo.blocks == 2
    assert geo.blocks == 32 or (geo.blocks + 1) * b > per_sm * 132
    assert geo.lanes == min(p, s * w)
    assert geo.touched == min(s, p + r)
    sets = [x for rank in range(1, geo.blocks)
            for x in range((rank - 1) * geo.sets_per_cta,
                           min(s, rank * geo.sets_per_cta))]
    assert sorted(sets) == list(range(s))
    vecs = row // 16
    cols = [c for rank in range(1, geo.blocks)
            for c in range((rank - 1) * geo.cols_per_cta,
                           min(vecs, rank * geo.cols_per_cta))]
    assert sorted(cols) == list(range(vecs))
    tw = geo.touched * w
    assert geo.smem >= 25 * tw + 28 * geo.lanes + 14 * r + 5 * p


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Both CUDA kernels equal their plain versions bit for bit (the
    same comparison chip_smoke.py makes at the serving shapes): K1 in
    both geometries (one warp-sorted set path, one block-wide) with
    requests that hit this step's landings, the overflow case, and K2 at
    L = 32 and 256, masked and unmasked, alone and as the K/V pair."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check "
                    "on the card")
    dev = torch.device("cuda")
    cases = [_with_landing_requests(_rand_case(5, row=(4, 1, 8), **c))
             for c in DATAFLOW_CASES] + [_overflow_case()]
    for pol_name in POLICY_NAMES:
        for case in cases:
            args = _to_torch(case)
            args = tuple(a.to(dev) if isinstance(a, torch.Tensor) else
                         TR.ResidencyState(*(x.to(dev) for x in a))
                         for a in args)
            pol = TR.as_policy(pol_name, device=dev)
            clone = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                          for a in args)
            ref = ops.residency_fused(*clone, pol, impl="ref")
            got = ops.residency_fused(*args, pol, impl="cuda")
            for name, a, b in zip(OUT_NAMES, _flat(ref), _flat(got)):
                assert torch.equal(a, b), (pol_name, name)
    for rows in (32, 256):
        pool = torch.randn(512, 16, 8, 128, device=dev).to(torch.bfloat16)
        idx = torch.randint(-520, 530, (rows,), device=dev,
                            dtype=torch.int32)
        mask = torch.rand(rows, device=dev) < 0.5
        for m in (None, mask):
            want = ops.paged_gather(pool, idx, m, impl="ref")
            assert torch.equal(ops.paged_gather(pool, idx, m, impl="cuda"),
                               want)
            got_k, got_v = ops.paged_gather_pair(pool, pool + 1, idx, m,
                                                 impl="cuda")
            assert torch.equal(got_k, want)
            assert torch.equal(got_v, ops.paged_gather(pool + 1, idx, m,
                                                       impl="ref"))


@pytest.mark.cuda
def test_kernels_match_plain_on_card_at_replicated_shapes():
    """The replicated store and the chain comparator run the kernels at
    shapes no other check holds: K1 over C*B = 16 sequences and over one
    sequence (`step_fetch`), and K2 on one pool at the chain's gathers
    (landing lanes B*k masked by `landed`, lookups B*R over the pools
    viewed flat as (B*N, row))."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check "
                    "on the card")
    dev = torch.device("cuda")
    for b in (16, 1):
        for c in (dict(s=16, w=4, p=9), dict(s=1, w=12, p=9)):
            args = _to_torch(_with_landing_requests(
                _rand_case(b, b=b, row=(4, 1, 8), **c)))
            args = tuple(a.to(dev) if isinstance(a, torch.Tensor) else
                         TR.ResidencyState(*(x.to(dev) for x in a))
                         for a in args)
            for pol_name in POLICY_NAMES:
                pol = TR.as_policy(pol_name, device=dev)
                clone = tuple(a.clone() if isinstance(a, torch.Tensor)
                              else a for a in args)
                ref = ops.residency_fused(*clone, pol, impl="ref")
                got = ops.residency_fused(*args, pol, impl="cuda")
                for name, x, y in zip(OUT_NAMES, _flat(ref), _flat(got)):
                    assert torch.equal(x, y), (b, pol_name, name)
    for b, n, rows in ((16, 64, 16 * 9), (16, 64, 16 * 4), (1, 64, 4)):
        pool = torch.randn(b * n, 16, 8, 128, device=dev).to(torch.bfloat16)
        idx = torch.randint(0, b * n, (rows,), device=dev,
                            dtype=torch.int32)
        mask = torch.rand(rows, device=dev) < 0.5
        for m in (None, mask):
            assert torch.equal(ops.paged_gather(pool, idx, m, impl="cuda"),
                               ops.paged_gather(pool, idx, m, impl="ref"))
