"""The port's single-sequence, replicated and chain store steps, and its
compute plane, against the reference's, step by step.

The drives run the `_drive` loop of tests/test_residency_fused.py
through both packages from the same numpy inputs. Page ids, masks,
counters, metadata, NIC and module byte ledgers and moved payloads must
be equal; float clocks, busy times and stall_steps within rtol 1e-5,
atol 1e-6 (tests/test_movement_plane.py:63)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compute_plane as JC
from repro.core import daemon_store as JS
from repro.core import fabric as JF
from repro.core import residency as JR
from repro.core.fabric import FabricConfig as JFabricConfig
from repro.core.params import DaemonParams as JDP
from repro_torch import convert
from repro_torch.core import compute_plane as TC
from repro_torch.core import daemon_store as TS
from repro_torch.core import fabric as TF
from repro_torch.core import residency as TR
from repro_torch.core.fabric import FabricConfig
from repro_torch.core.params import DaemonParams as TDP
from test_torch_store import (_flatten, assert_ledgers_match,
                              assert_states_match)

torch.set_num_threads(1)

POLICY_NAMES = ("lru", "fifo", "rrip", "dirty-averse")
PAGES = 32


def _cfgs(ways=0, modules=2, impl="ref", threshold=None, **kw):
    common = dict(num_local_pages=4, page_tokens=8, kv_heads=2,
                  head_dim=16, pool_ways=ways, **kw)
    jd, td = {}, {}
    if threshold is not None:
        jd["daemon"] = JDP(dirty_flush_threshold=threshold,
                           inflight_page_buf=8)
        td["daemon"] = TDP(dirty_flush_threshold=threshold,
                           inflight_page_buf=8)
    return (JS.KVStoreConfig(kernel_impl="ref" if impl == "chain" else impl,
                             fabric=JFabricConfig(num_modules=modules),
                             **common, **jd),
            TS.KVStoreConfig(kernel_impl=impl,
                             fabric=FabricConfig(num_modules=modules),
                             **common, **td))


def _remote():
    remote = np.random.default_rng(3).standard_normal(
        (PAGES, 8, 2, 16)).astype(np.float32)
    return jnp.asarray(remote), torch.from_numpy(remote)


def _requests(rng, shape):
    return (rng.integers(0, PAGES, shape).astype(np.int32),
            rng.integers(0, 8, shape).astype(np.int32),
            rng.random(shape) < 0.5)


# ------------------------------------------------------------ step_fetch
@pytest.mark.parametrize("pol_name", POLICY_NAMES)
@pytest.mark.parametrize("ways", [0, 2])
def test_step_fetch_matches_reference(pol_name, ways):
    """One sequence through the batched path at B = 1, against the
    reference's `step_fetch`, every state leaf every step."""
    jcfg, tcfg = _cfgs(ways)
    j_remote, t_remote = _remote()
    rng = np.random.default_rng(7)
    j_state = JS.init_kv_store(jcfg)
    t_state = TS.init_kv_store(tcfg, device="cpu")
    j_pol, t_pol = JR.as_policy(pol_name), TR.as_policy(pol_name)
    fetch = jax.jit(lambda s, need, off, wr, pol: JS.step_fetch(
        s, jcfg, j_remote, j_remote, need, off, wr, policy=pol))
    for i in range(10):
        need, off, wr = _requests(rng, (3,))
        j_state, jk, jv, jhit = fetch(j_state, need, off, wr, j_pol)
        t_state, tk, tv, thit = TS.step_fetch(
            t_state, tcfg, t_remote, t_remote, torch.from_numpy(need),
            torch.from_numpy(off), torch.from_numpy(wr), policy=t_pol)
        assert_states_match(j_state, t_state, f"step {i}")
        np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert_ledgers_match(JS.ledger(j_state), TS.ledger(t_state))


# -------------------------------------------------- step_fetch_replicated
def drive_replicated(c, b=2, steps=14, active=None, impl="ref", modules=2,
                     seed=11):
    jcfg, tcfg = _cfgs(0, modules=modules, impl=impl, threshold=1,
                       page_budget_per_step=16)
    j_remote, t_remote = _remote()
    rng = np.random.default_rng(seed)
    j_state = JS.init_kv_store_replicated(jcfg, c, b)
    t_state = TS.init_kv_store_replicated(tcfg, c, b, device="cpu")
    fetch = jax.jit(lambda s, need, off, wr: JS.step_fetch_replicated(
        s, jcfg, j_remote, j_remote, need, off, wr, active=active))
    for i in range(steps):
        need, off, wr = _requests(rng, (c, b, 2))
        j_state, jk, jv, jhit = fetch(j_state, need, off, wr)
        t_state, tk, tv, thit = TS.step_fetch_replicated(
            t_state, tcfg, t_remote, t_remote, torch.from_numpy(need),
            torch.from_numpy(off), torch.from_numpy(wr), active=active)
        assert_states_match(j_state, t_state, f"step {i}")
        np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    led = TS.ledger(t_state)
    assert_ledgers_match(JS.ledger(j_state), led)
    return t_state, led


@pytest.mark.parametrize("c", [1, 2, 3])
def test_step_fetch_replicated_matches_reference(c):
    """C replicas x 2 tenants against the reference, with dirty evictions
    written back from several units (the port runs every sequence's
    writebacks before the request fold; the reference interleaves them
    sequence by sequence): NIC and module banks leaf for leaf, and
    two-endpoint byte conservation."""
    state, led = drive_replicated(c)
    assert led["dirty_evicts"] > 0
    np.testing.assert_allclose(sum(led["module_bytes"]), led["wire_bytes"],
                               rtol=1e-6)
    if c == 1:
        assert not any(led["unit_bytes"])
    else:
        np.testing.assert_allclose(sum(led["unit_bytes"]),
                                   led["wire_bytes"], rtol=1e-6)
        wb_units = state.nic.wb_bytes.numpy()
        assert (wb_units > 0).sum() >= 2, wb_units


@pytest.mark.parametrize("c,active", [(2, False), (1, True)])
def test_step_fetch_replicated_active_override(c, active):
    """The NIC gate as the mesh plane overrides it: off with C = 2 (the
    NIC bank stays all zeros), on with C = 1."""
    state, led = drive_replicated(c, active=active, steps=8)
    if active:
        np.testing.assert_allclose(sum(led["unit_bytes"]),
                                   led["wire_bytes"], rtol=1e-6)
    else:
        assert not any(led["unit_bytes"])


def test_replicated_c1_is_batched_bit_for_bit():
    """C = 1 is `step_fetch_batch` bit for bit on every leaf and output,
    and the NIC bank stays exactly as it was built."""
    _, tcfg = _cfgs(2, threshold=1, page_budget_per_step=16)
    _, t_remote = _remote()
    rng = np.random.default_rng(5)
    rep = TS.init_kv_store_replicated(tcfg, 1, 3, device="cpu")
    nic0 = _flatten(rep.nic)
    bat = TS.init_kv_store_batch(tcfg, 3, device="cpu")
    for _ in range(12):
        need, off, wr = (torch.from_numpy(a) for a in _requests(rng, (3, 2)))
        rep, rk, rv, rhit = TS.step_fetch_replicated(
            rep, tcfg, t_remote, t_remote, need[None], off[None], wr[None])
        bat, bk, bv, bhit = TS.step_fetch_batch(bat, tcfg, t_remote,
                                                t_remote, need, off, wr)
        for a, b in ((rk[0], bk), (rv[0], bv), (rhit[0], bhit)):
            assert torch.equal(a, b)
        got, want = _flatten(rep.seqs), _flatten(bat.seqs)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], key)
        got, want = _flatten(rep.fab), _flatten(bat.fab)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], key)
    assert TS.ledger(bat)["dirty_evicts"] > 0
    for key, a in _flatten(rep.nic).items():
        np.testing.assert_array_equal(a, nic0[key], key)


# ------------------------------------------------------------- the chain
@pytest.mark.parametrize("pol_name", POLICY_NAMES)
@pytest.mark.parametrize("ways", [0, 2])
def test_chain_matches_reference_and_fused(pol_name, ways):
    """`kernel_impl="chain"` against the reference's chain, and bit for
    bit against the port's fused path, every leaf and output each step
    (the reference pins chain == fused in test_residency_fused.py)."""
    jcfg, _ = _cfgs(ways)
    jcfg = JS.KVStoreConfig(**{**jcfg.__dict__, "kernel_impl": "chain"})
    _, ccfg = _cfgs(ways, impl="chain")
    _, fcfg = _cfgs(ways, impl="ref")
    j_remote, t_remote = _remote()
    rng = np.random.default_rng(7)
    j_state = JS.init_kv_store_batch(jcfg, 3)
    c_state = TS.init_kv_store_batch(ccfg, 3, device="cpu")
    f_state = TS.init_kv_store_batch(fcfg, 3, device="cpu")
    pol_j, pol_t = JR.as_policy(pol_name), TR.as_policy(pol_name)
    fetch = jax.jit(lambda s, need, off, wr, pol: JS.step_fetch_batch(
        s, jcfg, j_remote, j_remote, need, off, wr, policy=pol))
    for i in range(10):
        need, off, wr = _requests(rng, (3, 2))
        j_state, jk, _, jhit = fetch(j_state, need, off, wr, pol_j)
        args = [torch.from_numpy(a) for a in (need, off, wr)]
        c_state, ck, cv, chit = TS.step_fetch_batch(
            c_state, ccfg, t_remote, t_remote, *args, policy=pol_t)
        f_state, fk, fv, fhit = TS.step_fetch_batch(
            f_state, fcfg, t_remote, t_remote, *args, policy=pol_t)
        assert_states_match(j_state, c_state, f"step {i}")
        np.testing.assert_array_equal(ck.numpy(), np.asarray(jk))
        for a, b in ((ck, fk), (cv, fv), (chit, fhit)):
            assert torch.equal(a, b)
        got, want = _flatten(c_state), _flatten(f_state)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], key)
    assert TS.ledger(c_state)["evictions"] > 0


def test_chain_replicated_matches_fused():
    """The chain under the replicated stepper (C = 2, dirty writebacks)
    equals the fused path there too, bit for bit."""
    chain, led_c = drive_replicated(2, impl="chain", steps=10)
    fused, led_f = drive_replicated(2, impl="ref", steps=10)
    got, want = _flatten(chain), _flatten(fused)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], key)
    assert led_c == led_f


# ---------------------------------------------------------- compute plane
def _rand_fabric(rng, m, jmod, tmod):
    vals = {f: rng.uniform(0, 6, m).astype(np.float32)
            for f in ("line_busy", "page_busy", "wb_busy", "line_bytes",
                      "page_bytes", "wb_bytes", "line_rate", "page_rate")}
    vals["ratio"] = rng.uniform(0.1, 0.6, m).astype(np.float32)
    sched = (np.array([0.0, 2.5], np.float32),
             rng.uniform(0.3, 2, (2, m)).astype(np.float32),
             rng.uniform(0.2, 1, (2, m)).astype(np.float32))
    bw = rng.uniform(50, 400, m).astype(np.float32)
    j = JF.FabricState(**{k: jnp.asarray(v) for k, v in vals.items()},
                       link=JF.scheduled_link(bw, sched, m))
    t = TF.FabricState(**{k: torch.from_numpy(v) for k, v in vals.items()},
                       link=TF.scheduled_link(bw, sched, m))
    return j, t


def _fab_equal(j, t, exact=()):
    for f in j._fields:
        if f == "link":
            continue
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        if f in exact:
            np.testing.assert_array_equal(b, a, f)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6,
                                       err_msg=f)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("active", [True, False])
def test_two_leg_service_matches_reference(seed, active):
    """`serve_dual_two_leg` and `serve_writeback_two_leg` on random
    module and NIC banks, every gate combination: both banks and the
    combined and module-leg completions; with `active` False the NIC
    bank's clocks and byte ledgers are untouched bit for bit (its demand
    EMAs decay, as the reference's do)."""
    rng = np.random.default_rng(seed)
    j_mem, t_mem = _rand_fabric(rng, 3, JF, TF)
    j_nic, t_nic = _rand_fabric(rng, 2, JF, TF)
    nic0 = _flatten(t_nic)
    for step in range(8):
        mc, cu = int(rng.integers(0, 3)), int(rng.integers(0, 2))
        now = np.float32(rng.uniform(0, 5))
        lg, pg = bool(rng.random() < 0.7), bool(rng.random() < 0.7)
        kw = dict(partition=True, line_ready=now, line_bytes=64.0,
                  page_ready=now, page_bytes=1032.0)
        j_mem, j_nic, *j_out = JC.serve_dual_two_leg(
            j_mem, j_nic, jnp.int32(mc), jnp.int32(cu), now=now,
            line_gate=lg, page_gate=pg, active=active, **kw)
        t_mem, t_nic, *t_out = TC.serve_dual_two_leg(
            t_mem, t_nic, torch.tensor(mc), torch.tensor(cu),
            now=torch.tensor(now), line_gate=torch.tensor(lg),
            page_gate=torch.tensor(pg), active=active,
            **{k: (torch.tensor(v) if isinstance(v, np.float32) else v)
               for k, v in kw.items()})
        for a, b in zip(j_out, t_out):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
        gate = bool(rng.random() < 0.7)
        j_mem, j_nic, jd = JC.serve_writeback_two_leg(
            j_mem, j_nic, jnp.int32(mc), jnp.int32(cu), now, 1032.0,
            gate=gate, active=active)
        t_mem, t_nic, td = TC.serve_writeback_two_leg(
            t_mem, t_nic, torch.tensor(mc), torch.tensor(cu),
            torch.tensor(now), 1032.0, gate=torch.tensor(gate),
            active=active)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
        _fab_equal(j_mem, t_mem, exact=("line_bytes", "page_bytes",
                                        "wb_bytes"))
        _fab_equal(j_nic, t_nic, exact=("line_bytes", "page_bytes",
                                        "wb_bytes"))
    if not active:
        for key in ("line_busy", "page_busy", "wb_busy", "line_bytes",
                    "page_bytes", "wb_bytes"):
            np.testing.assert_array_equal(getattr(t_nic, key).numpy(),
                                          nic0[key], key)


def test_shard_unit_matches_reference_with_overflow():
    """The int32 Knuth mix wraps: ids whose product overflows int32,
    negative ids and the int32 extremes shard as the reference does."""
    rng = np.random.default_rng(0)
    ids = np.concatenate([
        np.arange(0, 4096), rng.integers(-2 ** 31, 2 ** 31 - 1, 4096),
        [2 ** 31 - 1, -2 ** 31, -1, 1 << 20, 1 << 30]]).astype(np.int32)
    for units in (1, 2, 3, 7, 64):
        want = np.asarray(JC.shard_unit(jnp.asarray(ids), units))
        got = TC.shard_unit(torch.from_numpy(ids), units)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.min() >= 0 and got.max() < units


@pytest.mark.parametrize("seed", range(4))
def test_nic_link_for_matches_reference(seed):
    """The NIC link's mean bandwidth and schedule, bit for bit: the
    reference's f32 mean is an in-order sum times the reciprocal of the
    count (`compute_plane.mean_last`)."""
    rng = np.random.default_rng(seed)
    m = int(rng.integers(1, 8))
    bw = (rng.random(m) * 10 ** rng.uniform(1, 8)).astype(np.float32)
    sched = (np.array([0.0, 1.5, 4.0], np.float32),
             rng.uniform(0.1, 3, (3, m)).astype(np.float32),
             rng.uniform(0, 1, (3, m)).astype(np.float32))
    want = JC.nic_link_for(JF.scheduled_link(bw, sched, m), 3)
    got = TC.nic_link_for(TF.scheduled_link(bw, sched, m), 3)
    for f in JF.LinkModel._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    j_bank = JC.init_nic_bank(3, want, ratio=0.3)
    t_bank = TC.init_nic_bank(3, got, ratio=0.3)
    _fab_equal(j_bank, t_bank, exact=JF.FabricState._fields[:-1])


def test_unit_slice_and_update_match_reference():
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.integers(0, 9, (3, 2)).astype(np.int32)}
    new = {"a": np.ones(4, np.float32), "b": np.full(2, 7, np.int32)}
    jt = jax.tree.map(jnp.asarray, tree)
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    for cu in range(3):
        want = JC.unit_update(jt, jnp.int32(cu), jax.tree.map(jnp.asarray,
                                                             new))
        got = TC.unit_update(tt, torch.tensor(cu),
                             {k: torch.from_numpy(v) for k, v in
                              new.items()})
        for k in tree:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
            np.testing.assert_array_equal(
                TC.unit_slice(tt, cu)[k].numpy(),
                np.asarray(JC.unit_slice(jt, cu)[k]))


def test_fabric_readers_match_reference():
    rng = np.random.default_rng(2)
    j_fab, t_fab = _rand_fabric(rng, 3, JF, TF)
    for now in (0.0, 2.4, 2.5, 9.0):
        np.testing.assert_array_equal(
            TF.module_health(t_fab.link, torch.tensor(now)).numpy(),
            np.asarray(JF.module_health(j_fab.link, now)))
        for mc in range(3):
            for a, b in zip(TF.sample_link(t_fab.link, torch.tensor(mc),
                                           torch.tensor(now)),
                            JF.sample_link(j_fab.link, mc, now)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(float(TF.total_bytes(t_fab)),
                               float(JF.total_bytes(j_fab)), rtol=1e-6)


def test_replicated_state_roundtrip_through_numpy():
    """A reference replicated state (NIC bank included) and a
    single-sequence state carried into the port field by field."""
    jcfg, _ = _cfgs(2)
    for j_state in (JS.init_kv_store_replicated(jcfg, 2, 3),
                    JS.init_kv_store(jcfg)):
        t_state = convert.state_from_numpy(jax.device_get(j_state), "cpu")
        assert type(t_state).__name__ == type(j_state).__name__
        assert_states_match(j_state, t_state)
    again = convert.state_to_numpy(t_state)
    assert again["seq"]["res"]["page"].shape == (2, 2)
