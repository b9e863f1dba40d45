"""The attribution of device work to the program's layer spans
(`portbench/spans.py`) on synthetic events, the span metrics' readers on
a recorder's events, and a CPU dry run of the paged entry with the
spans on (`portbench/spanrun.py`)."""
from __future__ import annotations

import itertools
import time

import pytest

from portbench import harness, smoke, spanrun, spans

# host spans: a step holding the model's decode and the store's step,
# which holds its schedule; times in ns
SPANS = [(0, 100, "serve.step"), (10, 40, "model.decode"),
         (50, 90, "store.step"), (60, 80, "store.schedule")]


def test_innermost_span_owns_the_launch():
    launches = {1: 15, 2: 55, 3: 65, 4: 85, 5: 95, 6: 40}
    acts = [(200, 210, 1), (220, 230, 2), (240, 250, 3), (260, 270, 4),
            (280, 290, 5), (300, 305, 6)]
    got = spans.attribute(acts, launches, SPANS)
    assert {k: v["launches"] for k, v in got.items()} == {
        "model.decode": 1, "store.step": 2, "store.schedule": 1,
        "serve.step": 2}
    assert got["store.step"]["device_s"] == pytest.approx(20e-9)


def test_overlapping_device_work_counts_once():
    launches = {1: 61, 2: 62, 3: 63}
    acts = [(100, 200, 1), (150, 250, 2), (300, 310, 3)]
    got = spans.attribute(acts, launches, SPANS)
    assert got["store.schedule"] == {"launches": 3,
                                     "device_s": pytest.approx(160e-9)}


def test_work_outside_every_span_is_unattributed():
    launches = {1: 5, 2: 150, 3: 20}
    acts = [(200, 210, 1), (220, 230, 2), (240, 250, 3), (260, 270, 9)]
    got = spans.attribute(acts, launches, SPANS)
    assert got[spans.UNATTRIBUTED]["launches"] == 2      # 2, and 9 unlaunched
    assert got["model.decode"]["launches"] == 1
    assert got["serve.step"]["launches"] == 1            # at 5, in no child
    assert spans.attributed_share(got) == pytest.approx(0.5)
    assert spans.attributed_share({}) == 0.0


def test_sibling_spans_close_before_the_next_opens():
    seq = [(0, 10, "a"), (10, 20, "b"), (20, 30, "a")]
    launches = {1: 9, 2: 10, 3: 19, 4: 25, 5: 30}
    acts = [(40 + i, 41 + i, i) for i in launches]
    got = spans.attribute(acts, launches, seq)
    assert got["a"]["launches"] == 2 and got["b"]["launches"] == 2
    assert got[spans.UNATTRIBUTED]["launches"] == 1


def _events(steps: int, requests: int = 12):
    """A recorder's layer spans: one call of `steps` steps, each a model
    decode and a store step whose schedule takes `k + 1` ms."""
    ev, ids = [], itertools.count(1)

    def add(name, ts, dur, parent, **counts):
        sid = next(ids)
        ev.append({"name": name, "ph": "X", "ts": ts, "dur": dur,
                   "args": {"id": sid, "parent": parent, "call": 1,
                            **counts}})
        return sid
    call = add("serve.call", 0.0, 1e9, None)
    for k in range(steps):
        t = 1e6 * k
        step = add("serve.step", t, 9e5, call, phase="decode", step=k)
        add("model.decode", t + 1, 1e5, step, batch=4)
        store = add("store.step", t + 2e5, 5e5, step, requests=requests)
        add("store.schedule", t + 3e5, 1e3 * (k + 1), store)
    ev.append({"name": "decode_step", "ph": "X", "ts": 0.0, "dur": 1.0,
               "args": {"step": 0}})             # a phase span: no id
    return ev


def test_step_index_follows_the_serve_steps():
    ev = _events(5)
    where = spans.step_index(ev)
    sched = [where[e["args"]["id"]] for e in ev
             if e["name"] == "store.schedule"]
    assert sched == [0, 1, 2, 3, 4]
    inside, rest = spans.split_steps(ev, "store.schedule", (1, 3))
    assert [e["dur"] for e in inside] == [2e3, 3e3]
    assert [e["dur"] for e in rest] == [1e3, 4e3, 5e3]


def test_span_metric_readers():
    ev = _events(6, requests=12)
    owned = {"model.decode": {"launches": 600, "device_s": 0.03},
             "store.step": {"launches": 40, "device_s": 0.001},
             "store.schedule": {"launches": 200, "device_s": 0.002},
             "serve.step": {"launches": 8, "device_s": 0.0},
             spans.UNATTRIBUTED: {"launches": 1, "device_s": 0.0}}
    ctx = {"span_events": ev, "span_devices": owned, "trace_steps": [2, 4]}
    read = {m: harness.load_metric(m)(ctx) for m in spanrun.SPAN_METRICS}
    assert read["schedule_ms_per_step"] == pytest.approx((1 + 2 + 5 + 6) / 4)
    assert read["store_launches_per_request"] == pytest.approx(240 / 24)
    assert read["model_launches_per_step"] == pytest.approx(300)
    assert read["model_device_ms_per_step"] == pytest.approx(15)
    for empty in ({"span_events": None, "span_devices": None},
                  {"span_events": [], "span_devices": {}}):
        ctx = {**empty, "trace_steps": [2, 4]}
        assert all(harness.load_metric(m)(ctx) is None
                   for m in spanrun.SPAN_METRICS)


@pytest.mark.parametrize("trace", [False, True])
def test_paged_dry_run_reports_the_schedule_span(trace):
    result = spanrun.run_spans(smoke.spec("serve_batch_paged"), 2 ** 31 + 5,
                               0.2, trace, "cpu", time.perf_counter())
    assert result["correct"] is True
    got = result["spans"]
    assert got["metrics"]["schedule_ms_per_step"] > 0
    assert got["per_step"] == pytest.approx(8, rel=0.1)
    assert {"serve.step", "model.decode", "store.step", "store.schedule",
            "serve.step.decode"} <= set(got["host_ms"])
    assert set(got["span_us"]) == {"off", "on"}
    if trace:
        assert set(result["metrics"]) >= {"step_ms_p95", "store_ms_per_step"}
        assert got["activities"] == 0          # the CPU has no device work
    assert harness.make_entry.__module__ == "portbench.harness"
    assert harness.Tracer.__module__ == "portbench.harness"
