"""The port's request-level simulator against the reference's.

Traces, scheme flags, the residency primitives the simulator adds, the
substrate functions that now take tensor flags, and the simulator itself
(a lattice over schemes x link-profile nets x active compute units x
policies with telemetry, `run_trace`'s final state, `simulate_grid`, the
input checks, two-endpoint byte conservation), each on the same numpy
inputs through both packages. Counts, page ids, masks and flags must be
equal; clocks, times and derived metrics within rtol 1e-5, atol 1e-6
(tests/test_movement_plane.py:63). The seed golden is
tests/test_torch_sim_golden.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bandwidth as JB
from repro.core import compute_plane as JC
from repro.core import engine as JE
from repro.core import fabric as JF
from repro.core import residency as JR
from repro.core.params import NetworkParams as JNetworkParams
from repro.core.telemetry import TelemetryConfig as JTelemetryConfig
from repro.runtime import obs as JO
from repro.sim import desim as JD
from repro.sim import schemes as JS
from repro.sim import trace as JT
from repro.sim import workloads as JW
from repro_torch.core import bandwidth as TB
from repro_torch.core import compute_plane as TC
from repro_torch.core import engine as TE
from repro_torch.core import fabric as TF
from repro_torch.core import residency as TR
from repro_torch.core.params import DaemonParams, NetworkParams
from repro_torch.core.telemetry import TelemetryConfig
from repro_torch.runtime import obs as TO
from repro_torch.sim import (SCHEMES, WORKLOADS, SimConfig, generate_trace,
                             make_net, merge_traces, run_trace,
                             simulate_grid, simulate_lattice)
from repro_torch.sim import desim as TD
from repro_torch.sim import schemes as TS
from repro_torch.sim.workloads import make_link_schedule

torch.set_num_threads(1)

POLICY_NAMES = ("lru", "fifo", "rrip", "dirty-averse")
RTOL, ATOL = 1e-5, 1e-6
# metrics that count events: equal, not close
COUNT_KEYS = ("pages_moved", "lines_moved", "page_drops")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(t, j, msg=""):
    np.testing.assert_allclose(_np(t), np.asarray(j), rtol=RTOL, atol=ATOL,
                               err_msg=msg)


def _eq(t, j, msg=""):
    np.testing.assert_array_equal(_np(t), np.asarray(j), err_msg=msg)


# ------------------------------------------------------------ traces
@pytest.mark.parametrize("seed", (0, 5))
@pytest.mark.parametrize("wl", ("kc", "pr", "ts", "dr"))
def test_generate_trace_equals_reference(wl, seed):
    t = generate_trace(WORKLOADS[wl], 700, seed=seed)
    j = JT.generate_trace(JW.WORKLOADS[wl], 700, seed=seed)
    for f in ("page", "off", "gap", "wr"):
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype, f
        _eq(a, b, f)
    assert t.n_pages == j.n_pages


def test_merge_traces_equals_reference():
    names = ("kc", "bf", "sp")
    t = merge_traces([generate_trace(WORKLOADS[n], 300, seed=2)
                      for n in names], seed=4)
    j = JT.merge_traces([JT.generate_trace(JW.WORKLOADS[n], 300, seed=2)
                         for n in names], seed=4)
    for f in ("page", "off", "gap", "wr"):
        _eq(getattr(t, f), getattr(j, f), f)
    assert t.n_pages == j.n_pages


def test_link_schedules_equal_reference():
    for name in JW.LINK_PROFILES:
        for a, b in zip(make_link_schedule(name, 5e4, 3, 6),
                        JW.make_link_schedule(name, 5e4, 3, 6)):
            _eq(a, b, name)


# ------------------------------------------------------------ schemes
def test_stack_flags_equals_reference():
    names = list(SCHEMES)
    assert len(names) == 10
    variants = [TS.with_ratio(SCHEMES[n], 0.4) if n == "bp" else SCHEMES[n]
                for n in names]
    jvariants = [JS.with_ratio(JS.SCHEMES[n], 0.4) if n == "bp"
                 else JS.SCHEMES[n] for n in names]
    t = TS.stack_flags(variants, "cpu")
    j = JS.stack_flags(jvariants)
    for f in JS.TraceableFlags._fields:
        a, b = getattr(t, f), getattr(j, f)
        assert a.shape == (10,)
        assert str(a.dtype).split(".")[-1] == str(b.dtype), f
        _eq(a, b, f)
    one = TS.as_traceable(SCHEMES["daemon"], "cpu")
    assert TS.as_traceable(one) is one
    assert TS.PAPER_FIG8 == JS.PAPER_FIG8 and TS.PAPER_FIG3 == JS.PAPER_FIG3


# ---------------------------------------------------------- residency
def _table(seed, s, w, pr=96):
    """One random (S, W) table keeping the CAM invariants (page % S ==
    set, no duplicate within a set), with ties in age and set 0 fully
    tied: equal ages, dirtiness and RRPVs."""
    rng = np.random.default_rng(seed)
    page = np.full((s, w), -1, np.int32)
    for si in range(s):
        cand = rng.permutation(np.arange(si, pr, s))[:w]
        occ = rng.random(len(cand)) < 0.75
        page[si, :len(cand)] = np.where(occ, cand, -1)
    page[0, :] = np.arange(w) * s
    occ = page >= 0
    age = np.where(occ, rng.integers(0, 5, (s, w)), 0).astype(np.float32)
    ready = np.where(occ, np.where(rng.random((s, w)) < 0.3, 20.0, age),
                     3.0e38).astype(np.float32)
    dirty = occ & (rng.random((s, w)) < 0.4)
    rrpv = np.where(occ, rng.integers(0, 4, (s, w)), 3).astype(np.float32)
    age[0], dirty[0], rrpv[0], ready[0] = 3.0, True, 2.0, 1.0
    arrays = (page, age, ready, dirty, rrpv)
    return (rng, JR.ResidencyState(*(jnp.asarray(a) for a in arrays)),
            TR.ResidencyState(*(torch.from_numpy(a.copy())
                                for a in arrays)))


@pytest.mark.parametrize("pol_name", POLICY_NAMES)
def test_residency_primitives_equal_reference(pol_name):
    jpol, tpol = JR.as_policy(pol_name), TR.as_policy(pol_name)
    for seed, (s, w) in enumerate(((4, 8), (16, 4), (1, 12))):
        rng, jres, tres = _table(seed, s, w)
        assert TR.capacity(tres) == JR.capacity(jres)
        _eq(TR.occupancy(tres), JR.occupancy(jres))
        for si in range(s):
            set_t = torch.tensor(si, dtype=torch.int32)
            _eq(TR.evict_victim(tres, set_t, tpol),
                JR.evict_victim(jres, jnp.int32(si), jpol), f"set {si}")
            for page in list(np.asarray(jres.page[si])) + [si + 96 * s]:
                for now in (0.0, 3.0, 25.0):
                    got = TR.lookup_one(tres, set_t,
                                        torch.tensor(int(page)),
                                        torch.tensor(now))
                    want = JR.lookup_one(jres, jnp.int32(si),
                                         jnp.int32(page), jnp.float32(now))
                    for a, b in zip(got, want):
                        _eq(a, b, f"set {si} page {page} now {now}")
        if s == 1:
            _eq(TR.evict_order(tres, tpol), JR.evict_order(jres, jpol))
    # the tied set: the first way is the victim, slot order is the order
    _, jres, tres = _table(9, 4, 6)
    _eq(TR.evict_victim(tres, torch.tensor(0), tpol), 0)
    _eq(TR.evict_victim(tres, torch.tensor(0), tpol),
        JR.evict_victim(jres, jnp.int32(0), jpol))


def test_geometry_and_stack_policies_equal_reference():
    for n_pages, frac, ways in ((6144, 0.2, 8), (20, 0.2, 8), (4097, 0.33, 4),
                                (3, 0.5, 8)):
        assert TR.geometry(n_pages, frac, ways) == \
            JR.geometry(n_pages, frac, ways)
    t = TR.stack_policies(POLICY_NAMES, "cpu")
    j = JR.stack_policies(POLICY_NAMES)
    for f in JR.PolicyFlags._fields:
        _eq(getattr(t, f), getattr(j, f), f)


# ------------------------------------------- substrate: tensor flags
@pytest.mark.parametrize("flag", (False, True))
def test_shares_and_serve_dual_bool_equals_tensor(flag):
    rng = np.random.default_rng(int(flag))
    for _ in range(20):
        lb, pb, ratio, bw, lr, pr = (rng.random(6) * [50, 50, 0.7, 8, 60, 60]
                                     ).astype(np.float32)
        lgate, pgate = rng.random(2) < 0.6
        args = dict(ratio=ratio, bw=bw, line_ready=lr, line_bytes=64.0,
                    line_gate=lgate, page_ready=pr, page_bytes=1024.0,
                    page_gate=pgate)
        want = JB.serve_dual(jnp.float32(lb), jnp.float32(pb),
                             partition=jnp.bool_(flag),
                             **{k: jnp.asarray(v) for k, v in args.items()})
        targs = {k: torch.tensor(v) for k, v in args.items()}
        for part in (flag, torch.tensor(flag)):
            got = TB.serve_dual(torch.tensor(lb), torch.tensor(pb),
                                partition=part, **targs)
            for a, b in zip(got, want):
                _eq(a, b)
            for a, b in zip(TB.shares(part, torch.tensor(ratio)),
                            JB.shares(jnp.bool_(flag), jnp.float32(ratio))):
                _eq(a, b)


def _fabrics(seed, m=3):
    rng = np.random.default_rng(seed)
    k = 4
    arrays = dict(
        line_busy=rng.random(m) * 400, page_busy=rng.random(m) * 900,
        wb_busy=rng.random(m) * 100, line_bytes=rng.random(m) * 1e4,
        page_bytes=rng.random(m) * 1e5, wb_bytes=rng.random(m) * 1e3,
        ratio=rng.uniform(0.05, 0.75, m), line_rate=rng.random(m) * 50,
        page_rate=rng.random(m) * 900)
    arrays = {f: v.astype(np.float32) for f, v in arrays.items()}
    link = (rng.random(m).astype(np.float32) * 4 + 1,
            np.linspace(0, 300, k, dtype=np.float32),
            rng.uniform(0.2, 1, (k, m)).astype(np.float32),
            rng.uniform(0.05, 1, (k, m)).astype(np.float32))
    jf = JF.FabricState(**{f: jnp.asarray(v) for f, v in arrays.items()},
                        link=JF.LinkModel(*(jnp.asarray(a) for a in link)))
    tf = TF.FabricState(**{f: torch.from_numpy(v)
                           for f, v in arrays.items()},
                        link=TF.LinkModel(*(torch.from_numpy(a)
                                            for a in link)))
    return rng, jf, tf


@pytest.mark.parametrize("flag", (False, True))
def test_adapt_ratio_at_bool_equals_tensor(flag):
    rng, jf, tf = _fabrics(3 + flag)
    for mc in range(3):
        for now in (50.0, 180.0, 500.0):
            occ = rng.random(2).astype(np.float32)
            kw = dict(r_idle=np.float32(0.25), page_unit=np.float32(900.0),
                      line_occ=occ[0], page_occ=occ[1])
            want = JF.adapt_ratio_at(jf, jnp.int32(mc), jnp.float32(now),
                                     adaptive=jnp.bool_(flag),
                                     **{k: jnp.asarray(v)
                                        for k, v in kw.items()})
            for ad in (flag, torch.tensor(flag)):
                got = TF.adapt_ratio_at(
                    tf, torch.tensor(mc), torch.tensor(np.float32(now)),
                    adaptive=ad, **{k: torch.tensor(v)
                                    for k, v in kw.items()})
                _eq(got.ratio, want.ratio, f"mc {mc} now {now}")
            # the store's form: a Python float seed ratio
            got = TF.adapt_ratio_at(
                tf, torch.tensor(mc), torch.tensor(np.float32(now)),
                adaptive=flag, r_idle=0.25, page_unit=900.0,
                line_occ=torch.tensor(occ[0]), page_occ=torch.tensor(occ[1]))
            _eq(got.ratio, want.ratio)


def _engines(seed, pb=8, sb=6):
    rng = np.random.default_rng(seed)
    keys = np.where(rng.random(pb) < 0.6, rng.integers(0, 12, pb), -1)
    keys = np.where(np.arange(pb) == 2, 5, keys).astype(np.int32)
    arrays = dict(
        page_key=keys,
        page_state=np.where(keys >= 0, 1, 0).astype(np.int8),
        page_arrival=rng.random(pb).astype(np.float32) * 100,
        page_issue=rng.random(pb).astype(np.float32) * 60,
        page_dirty=np.zeros(pb, np.int8),
        sb_key=np.where(rng.random(sb) < 0.5, rng.integers(0, 700, sb),
                        -1).astype(np.int32),
        sb_arrival=rng.random(sb).astype(np.float32) * 80)
    return (JE.EngineState(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            TE.EngineState(**{k: torch.from_numpy(v)
                              for k, v in arrays.items()}))


@pytest.mark.parametrize("selection", (False, True))
def test_select_granularity_bool_equals_tensor(selection):
    for seed in range(6):
        je, te = _engines(seed)
        for page in (5, 3, 11, 40):
            for now in (10.0, 45.0):
                for pressure in (None, 0.3):
                    kw = {} if pressure is None else \
                        {"module_pressure": pressure}
                    want = JE.select_granularity(
                        je, jnp.int32(page), jnp.float32(now),
                        selection_enabled=jnp.bool_(selection),
                        always_both=jnp.bool_(not selection), **kw)
                    for sel, both in ((selection, not selection),
                                      (torch.tensor(selection),
                                       torch.tensor(not selection))):
                        got = TE.select_granularity(
                            te, torch.tensor(page, dtype=torch.int32),
                            torch.tensor(now), selection_enabled=sel,
                            always_both=both,
                            **{k: torch.tensor(np.float32(v))
                               for k, v in kw.items()})
                        for a, b in zip(got, want):
                            _eq(a, b, f"page {page} now {now}")


# ---------------------------------------------------------- simulator
def _net_pairs(make, params, pairs, **kw):
    return [make(params(bw_factor=bf, switch_latency_ns=sw), **kw)
            for sw, bf in pairs]


def _assert_cells(got, want, where):
    assert set(got) == set(want), where
    for key, v in want.items():
        if key in COUNT_KEYS:
            assert got[key] == v, f"{where}/{key}: {got[key]} != {v}"
        else:
            np.testing.assert_allclose(got[key], v, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{where}/{key}")


def test_lattice_all_axes_matches_reference():
    """schemes (daemon-adaptive included) x nets carrying a 4-knot link
    profile x active C {1, 3} at num_cu = 3 x 4 policies, telemetry at
    `histogram`, r = 1200: every cell of both packages."""
    w = WORKLOADS["pr"]
    r = 1200
    names = ("remote", "bp", "daemon", "daemon-adaptive")
    horizon = r * w.gap_ns * 2.0
    pairs = ((100.0, 4.0), (400.0, 8.0))
    sched = make_link_schedule("burst", horizon, 2, knots=4)
    jsched = JW.make_link_schedule("burst", horizon, 2, knots=4)
    nets = _net_pairs(make_net, NetworkParams, pairs, num_mc=2,
                      schedule=sched)
    jnets = _net_pairs(JD.make_net, JNetworkParams, pairs, num_mc=2,
                       schedule=jsched)
    got = simulate_lattice(
        [SCHEMES[s] for s in names], SimConfig(num_cu=3, num_mc=2),
        generate_trace(w, r, seed=1), nets, w.comp_ratio,
        active_cus=(1, 3), policies=POLICY_NAMES,
        telemetry_cfg=TelemetryConfig(level="histogram"), device="cpu")
    want = JD.simulate_lattice(
        [JS.SCHEMES[s] for s in names], JD.SimConfig(num_cu=3, num_mc=2),
        JT.generate_trace(JW.WORKLOADS["pr"], r, seed=1), jnets,
        w.comp_ratio, active_cus=(1, 3), policies=POLICY_NAMES,
        telemetry_cfg=JTelemetryConfig(level="histogram"))
    for i, s in enumerate(names):
        for j in range(len(pairs)):
            for c in range(2):
                for p, pol in enumerate(POLICY_NAMES):
                    cell = got[i][j][c][p]
                    assert "p99_access_ns" in cell
                    _assert_cells(cell, want[i][j][c][p],
                                  f"{s}/net{j}/c{c}/{pol}")


def _flatten_state(st, prefix=""):
    out = {}
    if st is None:
        return out
    if isinstance(st, dict):
        items = st.items()
    else:
        items = zip(st._fields, st)
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, (tuple, dict)) or v is None:
            out.update(_flatten_state(v, name + "."))
        else:
            out[name] = v
    return out


@pytest.mark.parametrize("c", (1, 3))
def test_run_trace_final_state_matches_reference(c):
    """Every leaf of the final SimState (residency, engines, the net /
    mem / NIC banks with their links, stats, telemetry) under a `flap`
    link on 2 modules, the adaptive scheme, at C = 1 and C = 3."""
    w = WORKLOADS["kc"]
    r = 900
    horizon = r * w.gap_ns * 2.0
    net = make_net(NetworkParams(), num_mc=2,
                   schedule=make_link_schedule("flap", horizon, 2, 6))
    jnet = JD.make_net(JNetworkParams(), num_mc=2,
                       schedule=JW.make_link_schedule("flap", horizon, 2, 6))
    tel = dict(level="trace", series_cap=32)
    got = run_trace(SCHEMES["daemon-adaptive"], SimConfig(num_cu=3,
                                                          num_mc=2),
                    generate_trace(w, r, seed=2), net, w.comp_ratio,
                    active_cu=c, policy="rrip",
                    telemetry_cfg=TelemetryConfig(**tel), device="cpu")
    want = JD.run_trace(JS.SCHEMES["daemon-adaptive"],
                        JD.SimConfig(num_cu=3, num_mc=2),
                        JT.generate_trace(JW.WORKLOADS["kc"], r, seed=2),
                        jnet, w.comp_ratio, active_cu=c, policy="rrip",
                        telemetry_cfg=JTelemetryConfig(**tel))
    g, h = _flatten_state(got), _flatten_state(want)
    assert set(g) == set(h)
    assert len(g) > 50
    for k in sorted(h):
        b = np.asarray(h[k])
        a = _np(g[k])
        assert a.shape == b.shape, k
        if b.dtype.kind in "biu":
            _eq(a, b, k)
        else:
            _close(a, b, k)
    # the NIC bank carries bytes only when more than one unit is active
    assert (float(TC.unit_bytes(got.nic).sum()) > 0) == (c > 1)
    # `.tel` exports as the reference's does (runtime.obs); the adaptive
    # ratio channel may sit an ulp apart, within the clocks' tolerance
    cfg, jcfg = TelemetryConfig(**tel), JTelemetryConfig(**tel)
    labels = TD.SERIES_CHANNELS
    events = TO.counter_events(got.tel, cfg, labels)
    jevents = JO.counter_events(want.tel, jcfg, labels)
    assert len(events) == len(jevents) > 0
    for e, je in zip(events, jevents):
        assert {k: e[k] for k in ("name", "ph", "ts", "pid")} == \
            {k: je[k] for k in ("name", "ph", "ts", "pid")}
        _close(e["args"][e["name"]], je["args"][je["name"]], e["name"])
    assert TO.summary("sim", got.tel, cfg, labels, unit="ns") == \
        JO.summary("sim", want.tel, jcfg, labels, unit="ns")


def test_simulate_grid_is_a_lattice_slice():
    w = WORKLOADS["kc"]
    tr = generate_trace(w, 400, seed=3)
    nets = _net_pairs(make_net, NetworkParams, ((100.0, 4.0), (400.0, 8.0)))
    names = ("remote", "daemon")
    lat = simulate_lattice([SCHEMES[s] for s in names], SimConfig(), tr,
                           nets, w.comp_ratio, device="cpu")
    for i, s in enumerate(names):
        grid = simulate_grid(SCHEMES[s], SimConfig(), tr, nets,
                             w.comp_ratio, device="cpu")
        assert grid == lat[i]


def test_lattice_inputs_raise_like_the_reference():
    w = WORKLOADS["bc"]
    tr = generate_trace(w, 20, seed=5)
    nets = [make_net(NetworkParams())]
    cases = (
        dict(schemes=[]),
        dict(active_cus=[4], cfg=SimConfig(num_cu=2)),
        dict(active_cus=[0]),
        dict(active_cus=[]),
        dict(policies=[]),
    )
    for case in cases:
        kw = dict(schemes=[SCHEMES["remote"]], cfg=SimConfig())
        kw.update(case)
        with pytest.raises(ValueError):
            simulate_lattice(kw.pop("schemes"), kw.pop("cfg"), tr, nets,
                             w.comp_ratio, device="cpu", **kw)


def test_two_endpoint_byte_conservation():
    """C = 4 active units x M = 4 modules: the NIC ledgers' sum and the
    module ledgers' sum both equal the stats' net_bytes."""
    w = WORKLOADS["pr"]
    tr = generate_trace(w, 1500, seed=7)
    fin = run_trace(SCHEMES["daemon"], SimConfig(num_cu=4, num_mc=4), tr,
                    make_net(NetworkParams(), num_mc=4), w.comp_ratio,
                    device="cpu")
    total = float(fin.stats["net_bytes"])
    assert total > 0
    np.testing.assert_allclose(float(TF.total_bytes(fin.net)), total,
                               rtol=1e-5)
    np.testing.assert_allclose(float(TC.unit_bytes(fin.nic).sum()), total,
                               rtol=1e-5)
    assert int((TC.unit_bytes(fin.nic) > 0).sum()) > 1


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    w = WORKLOADS["bc"]
    tr = generate_trace(w, 8, seed=5)
    net = make_net(NetworkParams())
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate_lattice([SCHEMES["remote"]], SimConfig(), tr, [net], 2.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_trace(SCHEMES["remote"], SimConfig(), tr, net, 2.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate_grid(SCHEMES["remote"], SimConfig(), tr, [net], 2.0)


def test_sim_config_is_the_reference_shape():
    assert TD.STAT_KEYS == JD.STAT_KEYS
    assert TD.SERIES_CHANNELS == JD.SERIES_CHANNELS
    cfg = SimConfig(fifo=True, num_cu=2)
    assert cfg.default_policy().name == "fifo"
    assert cfg.compute_config().num_units == 2
    net, jnet = make_net(NetworkParams(), num_mc=3), \
        JD.make_net(JNetworkParams(), num_mc=3)
    assert set(net) == set(jnet)
    for k in jnet:
        _eq(net[k], jnet[k], k)
    assert isinstance(DaemonParams(), type(cfg.daemon))
