"""The port's telemetry plane, span export and link-health monitor
against the reference's, on the same numpy inputs.

Histogram counts and series cursors must be equal; series rows and
percentiles within rtol 1e-5, atol 1e-6 (tests/test_movement_plane.py:63).
The bin index is floor(log(v / lat_lo) / span * bins) in f32 on both
sides, but the two `log`s may round one ulp apart, so a sample within an
ulp of a bin edge can fall on the other side: the direct histogram test
draws its samples at random, away from the edges, as the store's stalls
are."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import daemon_store as JS
from repro.core import fabric as JF
from repro.core import telemetry as JT
from repro.core.fabric import FabricConfig as JFabricConfig
from repro.runtime import obs as JO
from repro.runtime.fault import LinkHealthMonitor as JMonitor
from repro.sim.workloads import make_link_schedule
from repro_torch.core import daemon_store as TS
from repro_torch.core import fabric as TF
from repro_torch.core import telemetry as TT
from repro_torch.core.fabric import FabricConfig
from repro_torch.runtime import obs as TO
from repro_torch.runtime.fault import LinkHealthMonitor as TMonitor
from test_torch_store import assert_ledgers_match

torch.set_num_threads(1)

LEVELS = ("counters", "histogram", "trace")


def _cfg_pair(level, **kw):
    return (JT.TelemetryConfig(level=level, **kw),
            TT.TelemetryConfig(level=level, **kw))


def test_off_level_has_no_state():
    assert TT.init_state(TT.TelemetryConfig(), 6) is None
    assert TT.init_state(None, 6) is None
    cfg = TS.KVStoreConfig(num_local_pages=4, page_tokens=8, kv_heads=2,
                           head_dim=16)
    assert TS.init_kv_store_batch(cfg, 2, device="cpu").seqs.tel is None


@pytest.mark.parametrize("lo,hi,bins", [(0.01, 1e4, 64), (1.0, 1e8, 64),
                                        (0.5, 300.0, 17)])
def test_histogram_and_percentiles_match_reference(lo, hi, bins):
    jc, tc = _cfg_pair("histogram", lat_lo=lo, lat_hi=hi, bins=bins)
    np.testing.assert_array_equal(TT.bin_edges(tc), JT.bin_edges(jc))
    rng = np.random.default_rng(0)
    j_tel, t_tel = JT.init_state(jc, 3), TT.init_state(tc, 3)
    np.testing.assert_array_equal(t_tel.edges.numpy(),
                                  np.asarray(j_tel.edges))
    for _ in range(6):
        v = np.concatenate([rng.uniform(0, hi * 1.5, 300),
                            10 ** rng.uniform(np.log10(lo) - 2,
                                              np.log10(hi) + 1, 300),
                            np.zeros(4)]).astype(np.float32)
        gate = rng.random(v.shape) < 0.8
        j_tel = JT.record_latency(j_tel, jc, jnp.asarray(v),
                                  jnp.asarray(gate))
        t_tel = TT.record_latency(t_tel, tc, torch.from_numpy(v),
                                  torch.from_numpy(gate))
    np.testing.assert_array_equal(t_tel.hist.numpy(), np.asarray(j_tel.hist))
    qs = [0.5, 0.9, 0.95, 0.99, 1.0]
    assert TT.percentiles_from_state(t_tel, qs) == \
        JT.percentiles_from_state(j_tel, qs)
    np.testing.assert_allclose(
        TT.approx_percentiles(t_tel.hist, t_tel.edges, qs).numpy(),
        np.asarray(JT.approx_percentiles(j_tel.hist, j_tel.edges, qs)),
        rtol=1e-6)
    merged = TT.merge(t_tel, t_tel)
    np.testing.assert_array_equal(merged.hist.numpy(),
                                  2 * t_tel.hist.numpy())


@pytest.mark.parametrize("every,cap,steps", [(1, 8, 5), (1, 8, 21),
                                             (3, 4, 40)])
def test_series_ring_matches_reference(every, cap, steps):
    jc, tc = _cfg_pair("counters", series_cap=cap, series_every=every)
    j_tel, t_tel = JT.init_state(jc, 2), TT.init_state(tc, 2)
    for step in range(steps):
        row = np.array([step, step * 0.5], np.float32)
        j_tel = JT.record_series(j_tel, jc, step, jnp.asarray(row))
        t_tel = TT.record_series(t_tel, tc, torch.tensor(step),
                                 torch.from_numpy(row))
    np.testing.assert_array_equal(t_tel.series.numpy(),
                                  np.asarray(j_tel.series))
    assert float(t_tel.series_n) == float(j_tel.series_n)
    for a, b in zip(TT.series_rows(t_tel, tc), JT.series_rows(j_tel, jc)):
        np.testing.assert_array_equal(a, b)
    # below the level, the instrument is a no-op
    hc = TT.TelemetryConfig(level="counters")
    assert TT.record_latency(t_tel, hc, torch.ones(3)) is t_tel


def _store_cfgs(level, schedule=None):
    common = dict(num_local_pages=4, page_tokens=8, kv_heads=2,
                  head_dim=16, pool_ways=2, kernel_impl="ref",
                  page_budget_per_step=4)
    tel = dict(level=level, lat_lo=0.01, lat_hi=1e4, series_cap=16)
    return (JS.KVStoreConfig(fabric=JFabricConfig(num_modules=2),
                             telemetry=JT.TelemetryConfig(**tel), **common),
            TS.KVStoreConfig(fabric=FabricConfig(num_modules=2),
                             telemetry=TT.TelemetryConfig(**tel), **common))


SCHEDULE = (np.array([0.0, 4.0, 9.0], np.float32),
            np.array([[1.0, 0.5], [0.25, 2.0], [1.0, 1.0]], np.float32),
            np.array([[1.0, 1.0], [1.0, 0.1], [0.5, 1.0]], np.float32))


@pytest.mark.parametrize("level", LEVELS)
def test_store_telemetry_matches_reference(level):
    """A batched store drive over a scheduled link with telemetry on:
    per-tenant histograms exact, series rows (the fabric after each
    tenant's own requests) and the ledger's stall percentiles."""
    jcfg, tcfg = _store_cfgs(level)
    rng = np.random.default_rng(7)
    remote = rng.standard_normal((32, 8, 2, 16)).astype(np.float32)
    bw = JS.link_bytes_per_step(jcfg)
    j_state = JS.init_kv_store_batch(jcfg, 3, link=JF.scheduled_link(
        bw, SCHEDULE, 2))
    t_state = TS.init_kv_store_batch(tcfg, 3, link=TF.scheduled_link(
        bw, SCHEDULE, 2), device="cpu")
    fetch = jax.jit(lambda s, need, wr: JS.step_fetch_batch(
        s, jcfg, jnp.asarray(remote), jnp.asarray(remote), need,
        needed_writes=wr))
    for _ in range(20):
        need = rng.integers(0, 32, (3, 2)).astype(np.int32)
        wr = rng.random((3, 2)) < 0.5
        j_state, *_ = fetch(j_state, need, wr)
        t_state, *_ = TS.step_fetch_batch(
            t_state, tcfg, torch.from_numpy(remote),
            torch.from_numpy(remote), torch.from_numpy(need),
            needed_writes=torch.from_numpy(wr))
    j_tel, t_tel = j_state.seqs.tel, t_state.seqs.tel
    np.testing.assert_array_equal(t_tel.hist.numpy(), np.asarray(j_tel.hist))
    np.testing.assert_array_equal(t_tel.series_n.numpy(),
                                  np.asarray(j_tel.series_n))
    np.testing.assert_allclose(t_tel.series.numpy(),
                               np.asarray(j_tel.series), rtol=1e-5,
                               atol=1e-6)
    for b in range(3):
        jb = jax.tree.map(lambda x: x[b], j_tel)
        tb = TT.TelemetryState(*(x[b] for x in t_tel))
        steps_t, rows_t = TT.series_rows(tb, tcfg.telemetry)
        steps_j, rows_j = JT.series_rows(jb, jcfg.telemetry)
        np.testing.assert_array_equal(steps_t, steps_j)
        np.testing.assert_allclose(rows_t, rows_j, rtol=1e-5, atol=1e-6)
    assert float(t_tel.hist.sum()) == (20 * 6 if level != "counters"
                                       else 0)
    j_led, t_led = JS.ledger(j_state), TS.ledger(t_state)
    assert_ledgers_match(j_led, t_led)
    if level != "counters":
        assert t_led["stall_p99_steps"] > 0


def test_replicated_store_telemetry_matches_reference():
    """Telemetry rides the flattened C*B axis of the replicated store."""
    jcfg, tcfg = _store_cfgs("histogram")
    rng = np.random.default_rng(9)
    remote = rng.standard_normal((32, 8, 2, 16)).astype(np.float32)
    j_state = JS.init_kv_store_replicated(jcfg, 2, 2)
    t_state = TS.init_kv_store_replicated(tcfg, 2, 2, device="cpu")
    fetch = jax.jit(lambda s, need: JS.step_fetch_replicated(
        s, jcfg, jnp.asarray(remote), jnp.asarray(remote), need))
    for _ in range(12):
        need = rng.integers(0, 32, (2, 2, 2)).astype(np.int32)
        j_state, *_ = fetch(j_state, need)
        t_state, *_ = TS.step_fetch_replicated(
            t_state, tcfg, torch.from_numpy(remote),
            torch.from_numpy(remote), torch.from_numpy(need))
    np.testing.assert_array_equal(t_state.seqs.tel.hist.numpy(),
                                  np.asarray(j_state.seqs.tel.hist))
    np.testing.assert_allclose(t_state.seqs.tel.series.numpy(),
                               np.asarray(j_state.seqs.tel.series),
                               rtol=1e-5, atol=1e-6)
    assert_ledgers_match(JS.ledger(j_state), TS.ledger(t_state))


def _strip_times(events):
    """Events without their wall-clock fields (`ts` of spans, `dur`)."""
    out = []
    for ev in events:
        ev = dict(ev)
        if ev["ph"] in ("X", "i"):
            ev.pop("ts")
        ev.pop("dur", None)
        out.append(ev)
    return out


def test_counter_events_and_trace_export_match_reference(tmp_path):
    """Same spans and series through both exporters: the documents are
    equal but for wall-clock times, and the written JSON parses."""
    jc, tc = _cfg_pair("counters", series_cap=8)
    j_tel, t_tel = JT.init_state(jc, 2), TT.init_state(tc, 2)
    for step in range(11):
        row = np.array([step, 0.5 + step], np.float32)
        j_tel = JT.record_series(j_tel, jc, step, jnp.asarray(row))
        t_tel = TT.record_series(t_tel, tc, step, torch.from_numpy(row))
    labels = ("backlog", "ratio")
    j_cnt = JO.counter_events(j_tel, jc, labels, pid=1, name_prefix="s.",
                              step_us=10.0, t0_us=5.0)
    t_cnt = TO.counter_events(t_tel, tc, labels, pid=1, name_prefix="s.",
                              step_us=10.0, t0_us=5.0)
    assert t_cnt == j_cnt
    with pytest.raises(ValueError):
        TO.counter_events(t_tel, tc, ("one",))
    docs = []
    for obs, sync in ((JO, jnp.ones(())), (TO, torch.ones(()))):
        rec = obs.SpanRecorder(pid=2)
        with rec.span("prefill", tokens=4) as sp:
            sp["sync"] = sync
        with rec.span("decode_step", tid=1, step=np.int64(3)):
            pass
        path = tmp_path / f"{obs.__name__}.json"
        cnt = j_cnt if obs is JO else t_cnt
        doc = obs.trace_export(str(path), spans=rec.events, counters=cnt,
                               metadata={"serve": 0})
        assert json.loads(path.read_text()) == doc
        assert all(ev["dur"] >= 0 for ev in doc["traceEvents"]
                   if ev["ph"] == "X")
        docs.append(doc)
    assert _strip_times(docs[1]["traceEvents"]) == \
        _strip_times(docs[0]["traceEvents"])
    assert docs[1]["displayTimeUnit"] == docs[0]["displayTimeUnit"]


def test_summary_matches_reference():
    jcfg, tcfg = _store_cfgs("trace")
    tel_j = JT.init_state(jcfg.telemetry, 6)
    tel_t = TT.init_state(tcfg.telemetry, 6)
    for step in range(3):
        row = np.arange(6, dtype=np.float32) + step
        v = np.array([0.5, 2.0, 7.0 + step], np.float32)
        tel_j = JT.record_series(JT.record_latency(tel_j, jcfg.telemetry,
                                                   jnp.asarray(v)),
                                 jcfg.telemetry, step, jnp.asarray(row))
        tel_t = TT.record_series(TT.record_latency(tel_t, tcfg.telemetry,
                                                   torch.from_numpy(v)),
                                 tcfg.telemetry, step, torch.from_numpy(row))
    assert TO.summary("t", tel_t, tcfg.telemetry, TS.SERIES_CHANNELS) == \
        JO.summary("t", tel_j, jcfg.telemetry, JS.SERIES_CHANNELS)


def _flap_sequences():
    healthy = np.ones(4, np.float32)
    flap = healthy.copy()
    flap[2] = 0.05
    return [healthy] * 20 + [flap] * 3 + [healthy] * 3


@pytest.mark.parametrize("case", ["flapping", "schedule"])
def test_link_health_monitor_matches_reference(case):
    """The health sequences of tests/test_link_plane.py:275-310 through
    both monitors: the same advisories at every step."""
    if case == "flapping":
        seq = _flap_sequences()
        kw = dict(floor=0.5, patience=3)
    else:
        t, m, h = make_link_schedule("flap", 100.0, 4, knots=10)
        link = TF.LinkModel(bw=torch.ones(4), sched_t=torch.from_numpy(t),
                            sched_mult=torch.from_numpy(np.asarray(m)),
                            health=torch.from_numpy(np.asarray(h)))
        seq = [TF.module_health(link, torch.tensor(float(s))).numpy()
               for s in range(100)]
        kw = dict(floor=0.5, patience=2)
    jm, tm = JMonitor(**kw), TMonitor(**kw)
    for health in seq:
        assert tm.observe(health) == jm.observe(health)
        assert tm.flagged == jm.flagged
    if case == "flapping":
        assert tm.flagged == []
