"""The port's batched store step against the reference's, step by step.

The `_drive` loop of tests/test_residency_fused.py runs through both
packages' `step_fetch_batch` from the same numpy inputs, for every policy
and both pool geometries (fully associative 1x4, set-associative 2x2).
Page ids, masks, counters, metadata and moved payloads must be equal;
float clocks, busy times and stall_steps within rtol 1e-5, atol 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import daemon_store as JS
from repro.core import residency as JR
from repro.core import engine as JE
from repro.core import fabric as JF
from repro.core.fabric import FabricConfig as JFabricConfig
from repro.core.params import DaemonParams as JDP
from repro_torch import convert
from repro_torch.core import daemon_store as TS
from repro_torch.core import fabric as TF
from repro_torch.core import residency as TR
from repro_torch.core.engine import EngineState
from repro_torch.core.fabric import FabricConfig
from repro_torch.core.params import DaemonParams as TDP

torch.set_num_threads(1)

POLICY_NAMES = ("lru", "fifo", "rrip", "dirty-averse")
# float leaves compared with a tolerance: clocks, busy times, the stall
# sum, the controller EMAs; everything else must be equal
FLOAT_LEAVES = ("age", "ready", "page_arrival", "page_issue", "sb_arrival",
                "line_busy", "page_busy", "wb_busy", "line_rate",
                "page_rate", "ratio", "stall_steps", "clock")


def _cfgs(ways, modules=2, **kw):
    common = dict(num_local_pages=4, page_tokens=8, kv_heads=2,
                  head_dim=16, pool_ways=ways, **kw)
    return (JS.KVStoreConfig(kernel_impl="ref",
                             fabric=JFabricConfig(num_modules=modules),
                             **common),
            TS.KVStoreConfig(kernel_impl="ref",
                             fabric=FabricConfig(num_modules=modules),
                             **common))


def _flatten(tree, prefix=""):
    """Flatten a state (NamedTuples / dicts) into {path: numpy}."""
    out = {}
    if tree is None:
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: convert.to_numpy(tree)}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = ((f, getattr(tree, f)) for f in tree._fields)
    else:
        return {prefix: np.asarray(tree).astype(np.float32)
                if np.asarray(tree).dtype.name == "bfloat16"
                else np.asarray(tree)}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}.{k}" if prefix else k))
    return out


def assert_states_match(jax_state, torch_state, where=""):
    ref = _flatten(jax.device_get(jax_state))
    got = _flatten(torch_state)
    assert set(ref) == set(got), (set(ref) ^ set(got))
    for path, a in ref.items():
        b = got[path]
        leaf = path.rsplit(".", 1)[-1]
        msg = f"{where} {path}"
        if leaf in FLOAT_LEAVES:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6,
                                       err_msg=msg)
        else:
            np.testing.assert_array_equal(b, a, err_msg=msg)


def assert_ledgers_match(ref, got):
    assert set(ref) == set(got)
    for k, a in ref.items():
        np.testing.assert_allclose(got[k], a, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def drive_both(jcfg, tcfg, pol_name, steps=8, batch=3, schedule=None):
    rng = np.random.default_rng(7)
    remote = rng.standard_normal((32, 8, 2, 16)).astype(np.float32)
    j_remote = jnp.asarray(remote)
    t_remote = torch.from_numpy(remote)
    j_link = t_link = None
    if schedule is not None:
        m = jcfg.fabric.num_modules
        bw = JS.link_bytes_per_step(jcfg)
        j_link = JF.scheduled_link(bw, schedule, m)
        t_link = TF.scheduled_link(bw, schedule, m)
    j_state = JS.init_kv_store_batch(jcfg, batch, link=j_link)
    t_state = TS.init_kv_store_batch(tcfg, batch, link=t_link,
                                     device="cpu")
    j_pol = JR.as_policy(pol_name)
    t_pol = TR.as_policy(pol_name)
    fetch = jax.jit(lambda s, need, wr, pol: JS.step_fetch_batch(
        s, jcfg, j_remote, j_remote, need, needed_writes=wr, policy=pol))
    for i in range(steps):
        need = rng.integers(0, 32, (batch, 2)).astype(np.int32)
        wr = rng.random((batch, 2)) < 0.5
        j_state, jk, jv, jhit = fetch(j_state, jnp.asarray(need),
                                      jnp.asarray(wr), j_pol)
        t_state, tk, tv, thit = TS.step_fetch_batch(
            t_state, tcfg, t_remote, t_remote, torch.from_numpy(need),
            needed_writes=torch.from_numpy(wr), policy=t_pol)
        assert_states_match(j_state, t_state, f"step {i}")
        np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert_ledgers_match(JS.ledger(j_state), TS.ledger(t_state))
    return t_state


@pytest.mark.parametrize("pol_name", POLICY_NAMES)
@pytest.mark.parametrize("ways", [0, 2])
def test_step_fetch_batch_matches_reference(pol_name, ways):
    jcfg, tcfg = _cfgs(ways)
    drive_both(jcfg, tcfg, pol_name)


def test_time_varying_link_matches_reference():
    """A piecewise link schedule (bursts, a degraded module) sampled at
    the decode-step clock: segments, per-module bandwidth and health."""
    schedule = (np.array([0.0, 3.0, 5.5], np.float32),
                np.array([[1.0, 0.5], [0.25, 2.0], [1.0, 1.0]], np.float32),
                np.array([[1.0, 1.0], [1.0, 0.1], [0.5, 1.0]], np.float32))
    jcfg, tcfg = _cfgs(2, page_budget_per_step=8)
    drive_both(jcfg, tcfg, "rrip", schedule=schedule)


def _reference_writebacks(eng, fab, cfg, evicted, clock, page_wire):
    """The reference's order, lane by lane: the `wb_one` scan of
    `repro.core.daemon_store._schedule`, sequence by sequence."""
    n_wb = []
    engs = []
    for b in range(evicted.shape[0]):
        e = jax.tree.map(lambda x: x[b], eng)
        cnt = 0
        for pid in evicted[b]:
            pid = jnp.int32(pid)
            ok = pid >= 0
            mc = JF.place(cfg.fabric, jnp.maximum(pid, 0))
            new_e, buffered = JE.note_dirty_eviction(e, pid, cfg.daemon)
            e = JE.gate_tree(ok, e, new_e)
            wb = ok & ~buffered
            fab, _ = JF.serve_writeback_at(fab, mc, clock, page_wire,
                                           gate=wb)
            cnt += int(wb)
        engs.append(e)
        n_wb.append(cnt)
    return jax.tree.map(lambda *x: jnp.stack(x), *engs), fab, n_wb


@pytest.mark.parametrize("seed", range(4))
def test_writebacks_match_sequential_reference(seed):
    """The vectorised dirty-eviction path against the reference's
    sequential one on random engines and eviction lists with repeated
    pages, pages not in flight (which reset entry 0's counter) and -1
    padding, under a threshold small enough to throttle."""
    rng = np.random.default_rng(seed)
    b, p, k = 3, 6, 10
    daemon = dict(dirty_flush_threshold=2, inflight_page_buf=p)
    jcfg = JS.KVStoreConfig(num_local_pages=4, page_tokens=8, kv_heads=2,
                            head_dim=16, daemon=JDP(**daemon),
                            fabric=JFabricConfig(num_modules=3))
    tcfg = TS.KVStoreConfig(num_local_pages=4, page_tokens=8, kv_heads=2,
                            head_dim=16, daemon=TDP(**daemon),
                            fabric=FabricConfig(num_modules=3))
    keys = np.stack([np.where(rng.random(p) < 0.8,
                              rng.permutation(12)[:p], -1)
                     for _ in range(b)]).astype(np.int32)
    arrays = dict(
        page_key=keys,
        page_state=rng.choice([0, 1, 3], (b, p)).astype(np.int8),
        page_arrival=rng.uniform(0, 9, (b, p)).astype(np.float32),
        page_issue=rng.uniform(0, 9, (b, p)).astype(np.float32),
        page_dirty=rng.integers(0, 3, (b, p)).astype(np.int8),
        sb_key=np.full((b, 4), -1, np.int32),
        sb_arrival=np.full((b, 4), 3.4e38, np.float32))
    evicted = np.where(rng.random((b, k)) < 0.7,
                       rng.integers(0, 14, (b, k)), -1).astype(np.int32)
    clock = np.float32(4.0)
    page_wire = JS._wire_bytes(jcfg, 8, True)
    j_fab = JS._init_fab(jcfg)
    j_fab = j_fab._replace(wb_busy=jnp.asarray([0.0, 7.5, 2.0], jnp.float32))
    j_eng = JE.EngineState(**{f: jnp.asarray(a) for f, a in arrays.items()})
    j_eng, j_fab, j_nwb = _reference_writebacks(j_eng, j_fab, jcfg, evicted,
                                                clock, page_wire)
    t_fab = TS._init_fab(tcfg, device="cpu")
    t_fab = t_fab._replace(wb_busy=torch.tensor([0.0, 7.5, 2.0]))
    t_eng = EngineState(**{f: torch.from_numpy(a) for f, a in arrays.items()})
    t_eng, t_fab, t_nwb = TS._writebacks(t_eng, t_fab, tcfg,
                                         torch.from_numpy(evicted),
                                         torch.tensor(clock), page_wire)
    for f in EngineState._fields:
        np.testing.assert_array_equal(getattr(t_eng, f).numpy(),
                                      np.asarray(getattr(j_eng, f)), f)
    np.testing.assert_array_equal(t_nwb.numpy(), j_nwb)
    np.testing.assert_allclose(t_fab.wb_busy.numpy(),
                               np.asarray(j_fab.wb_busy), rtol=1e-5)
    np.testing.assert_array_equal(t_fab.wb_bytes.numpy(),
                                  np.asarray(j_fab.wb_bytes))


def test_writeback_path_matches_reference():
    """A long drive on a one-module fabric with a short dirty threshold:
    dirty evictions, dirty-unit buffering and throttling all occur, and
    the byte ledgers still agree and conserve."""
    jcfg, tcfg = _cfgs(0, modules=1, page_budget_per_step=16)
    jcfg = jcfg.__class__(**{**jcfg.__dict__, "daemon": JDP(
        dirty_flush_threshold=1, inflight_page_buf=8)})
    tcfg = tcfg.__class__(**{**tcfg.__dict__, "daemon": TDP(
        dirty_flush_threshold=1, inflight_page_buf=8)})
    state = drive_both(jcfg, tcfg, "lru", steps=24)
    led = TS.ledger(state)
    assert led["dirty_evicts"] > 0 and led["evictions"] > 0
    np.testing.assert_allclose(sum(led["module_bytes"]), led["wire_bytes"],
                               rtol=1e-6)


def test_state_roundtrip_through_numpy():
    jcfg, tcfg = _cfgs(2)
    j_state = JS.init_kv_store_batch(jcfg, 2)
    t_state = convert.state_from_numpy(jax.device_get(j_state), "cpu")
    assert_states_match(j_state, t_state)
    again = convert.state_to_numpy(t_state)
    assert again["seqs"]["res"]["page"].shape == (2, 2, 2)
