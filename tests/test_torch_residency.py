"""The port's residency primitives against the reference's, batched.

Each reference primitive runs under `jax.vmap` over a batch of random
tables (made with numpy from a seed) and the port's primitive on the
same batch; page ids, ways, masks and metadata must be equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import residency as JR
from repro_torch.core import residency as TR

torch.set_num_threads(1)

POLICY_NAMES = ("lru", "fifo", "rrip", "dirty-averse")
GEOMETRIES = ((1, 12), (4, 3), (16, 4))


def _tables(seed, b, s, w, pr=64):
    """Random tables that keep the CAM invariants: page % S == set, no
    duplicate page within a set, some slots empty, ties in age."""
    rng = np.random.default_rng(seed)
    page = np.full((b, s, w), -1, np.int32)
    for bi in range(b):
        for si in range(s):
            cand = rng.permutation(np.arange(si, pr, s))[:w]
            occ = rng.random(len(cand)) < 0.7
            page[bi, si, :len(cand)] = np.where(occ, cand, -1)
    occ = page >= 0
    age = np.where(occ, rng.integers(0, 6, (b, s, w)), 0).astype(np.float32)
    ready = np.where(occ, np.where(rng.random((b, s, w)) < 0.3, 20.0, age),
                     3.0e38).astype(np.float32)
    dirty = occ & (rng.random((b, s, w)) < 0.4)
    rrpv = np.where(occ, rng.integers(0, 4, (b, s, w)), 3).astype(np.float32)
    return rng, (page, age, ready, dirty, rrpv)


def _both(arrays):
    j = JR.ResidencyState(*(jnp.asarray(a) for a in arrays))
    t = TR.ResidencyState(*(torch.from_numpy(np.array(a)) for a in arrays))
    return j, t


def _eq(t, j, msg=""):
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j), err_msg=msg)


def _eq_state(t, j):
    for f in JR.ResidencyState._fields:
        _eq(getattr(t, f).numpy(), getattr(j, f), f)


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("pol_name", POLICY_NAMES)
def test_lookup_touch_mark_dirty(geom, pol_name):
    s, w = geom
    b, r = 3, 7
    rng, arrays = _tables(1, b, s, w)
    j, t = _both(arrays)
    pages = rng.integers(0, 64, (b, r)).astype(np.int32)
    pages[:, -2:] = pages[:, :2]              # duplicate requests
    now = np.float32(10.0)
    jp, tp = JR.as_policy(pol_name), TR.as_policy(pol_name)
    j_out = jax.vmap(lambda res, p: JR.lookup(res, p, now))(
        j, jnp.asarray(pages))
    t_out = TR.lookup(t, torch.from_numpy(pages), torch.tensor(now))
    for name, a, bb in zip(("present", "set", "way", "ready_ok"), j_out,
                           t_out):
        _eq(bb.numpy(), a, name)
    present, set_idx, way, ready_ok = j_out
    hit = present & ready_ok
    writes = rng.random((b, r)) < 0.5
    j2 = jax.vmap(lambda res, si, wy, g: JR.touch(res, si, wy, now, jp,
                                                   gate=g))(
        j, set_idx, way, hit)
    j2 = jax.vmap(lambda res, si, wy, wr, g: JR.mark_dirty(
        res, si, wy, wr, gate=g))(j2, set_idx, way, jnp.asarray(writes),
                                  hit)
    tpresent, tset, tway, tready = t_out
    thit = tpresent & tready
    t2 = TR.touch(t, tset, tway, torch.tensor(now), tp, gate=thit)
    t2 = TR.mark_dirty(t2, tset, tway, torch.from_numpy(writes), gate=thit)
    _eq_state(t2, j2)


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("pol_name", POLICY_NAMES)
def test_evict_order_and_landing_victims(geom, pol_name):
    s, w = geom
    b, k = 3, min(6, s * w)
    rng, arrays = _tables(2, b, s, w)
    j, t = _both(arrays)
    jp, tp = JR.as_policy(pol_name), TR.as_policy(pol_name)
    _eq(TR.evict_order_sets(t, tp).numpy(),
        jax.vmap(lambda res: JR.evict_order_sets(res, jp))(j))
    pids = rng.integers(-1, 64, (b, k)).astype(np.int32)
    j_out = jax.vmap(lambda res, p: JR.landing_victims(res, p, jp))(
        j, jnp.asarray(pids))
    t_out = TR.landing_victims(t, torch.from_numpy(pids), tp)
    for name, a, bb in zip(("sets", "ways", "ok"), j_out, t_out):
        _eq(bb.numpy(), a, name)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_insert_with_masked_duplicate_lanes(geom):
    """Gated-off lanes that share a slot with a live lane must not clobber
    it (the reference's mode="drop" scatter)."""
    s, w = geom
    b = 2
    rng, arrays = _tables(3, b, s, w)
    j, t = _both(arrays)
    # lanes 0 and 1 target distinct slots; lane 2 duplicates lane 0's
    # slot but is gated off; lane 3 is gated off at lane 1's slot
    sets = np.array([[0, s - 1, 0, s - 1]] * b, np.int32)
    ways = np.array([[0, w - 1, 0, w - 1]] * b, np.int32)
    gate = np.array([[True, True, False, False]] * b)
    pages = rng.integers(100, 200, (b, 4)).astype(np.int32)
    now = np.float32(7.0)
    j2 = jax.vmap(lambda res, si, wy, p, g: JR.insert(
        res, si, wy, p, now=now, ready=now + 1, dirty=False, gate=g))(
        j, jnp.asarray(sets), jnp.asarray(ways), jnp.asarray(pages),
        jnp.asarray(gate))
    t2 = TR.insert(t, torch.from_numpy(sets), torch.from_numpy(ways),
                   torch.from_numpy(pages), now=torch.tensor(now),
                   ready=torch.tensor(now + 1), dirty=False,
                   gate=torch.from_numpy(gate))
    _eq_state(t2, j2)
    assert (t2.page[:, 0, 0].numpy() == pages[:, 0]).all()


def test_policy_flags_and_init():
    for name in POLICY_NAMES:
        jp, tp = JR.as_policy(name), TR.as_policy(name)
        for a, bb in zip(jp, tp):
            _eq(bb.numpy(), a)
    _eq_state(TR.init_residency(4, 3), JR.init_residency(4, 3))
