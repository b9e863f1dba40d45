"""The port's layer spans (`core.telemetry.span`, recorded by an active
`runtime.obs.SpanRecorder`): off by default, no effect on tokens or the
store's ledger, the tree of a paged call, and their place in a
`torch.profiler` trace. Reduced qwen3-1.7b in f32 on the CPU, with the
port's own initialisation (no reference is needed here)."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import telemetry
from repro_torch.core.daemon_store import KVStoreConfig
from repro_torch.models.model import init_model
from repro_torch.runtime import serve_loop as SL
from repro_torch.runtime.obs import SpanRecorder

STORE = dict(num_local_pages=4, page_tokens=2, kv_heads=2, head_dim=16,
             page_budget_per_step=2)
PAGED = SL.PagedServeConfig(window_pages=3, pages_per_seq=8)
STORE_PARTS = ["store.residency", "store.remote_fetch", "store.writebacks",
               "store.schedule", "store.fold"]
B, P, N = 2, 4, 5


@pytest.fixture(scope="module")
def model():
    cfg = get_config("qwen3-1.7b").reduced()
    params = init_model(cfg, torch.Generator().manual_seed(0))
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        2, 200, (B, P)).astype(np.int32))
    return cfg, params, prompts


def _paged(model, rec=None):
    cfg, params, prompts = model
    return SL.serve_batch_paged(params, cfg, prompts,
                                SL.ServeConfig(max_new_tokens=N),
                                KVStoreConfig(**STORE), PAGED, recorder=rec,
                                device="cpu")


def _batch(model):
    cfg, params, prompts = model
    return SL.serve_batch(params, cfg, prompts,
                          SL.ServeConfig(max_new_tokens=N), device="cpu")


def test_off_is_one_shared_no_op():
    rec = SpanRecorder()
    first = telemetry.span("serve.step", phase="decode", step=0, tokens=B)
    assert telemetry.span("model.decode", batch=B) is first
    with first:
        with telemetry.span("store.step", requests=4):
            pass
    assert rec.events == []
    with rec.active():
        with telemetry.span("model.decode", batch=B):
            pass
    assert telemetry.span("model.decode", batch=B) is first
    assert [e["name"] for e in rec.events] == ["model.decode"]


def test_recorders_nest_and_restore():
    outer, inner = SpanRecorder(), SpanRecorder()
    with outer.active():
        with inner.active():
            with telemetry.span("a"):
                pass
        with telemetry.span("b"):
            pass
    assert [e["name"] for e in inner.events] == ["a"]
    assert [e["name"] for e in outer.events] == ["b"]
    assert telemetry._recorder is None


@pytest.mark.parametrize("entry", ["paged", "batch"])
def test_spans_change_no_token_and_no_ledger(model, entry):
    run = (lambda: _paged(model)) if entry == "paged" else \
        (lambda: (_batch(model), {}))
    tokens, led = run()
    rec = SpanRecorder()
    with rec.active():
        tokens_on, led_on = run()
    assert rec.events
    assert torch.equal(tokens_on, tokens)
    assert led_on.keys() == led.keys()
    for k, v in led.items():
        assert np.array_equal(np.asarray(led_on[k]), np.asarray(v)), k


def test_paged_call_span_tree(model):
    rec = SpanRecorder()
    with rec.active():
        _paged(model)
    ev = rec.events
    by_id = {e["args"]["id"]: e for e in ev}
    assert len(by_id) == len(ev)
    calls = [e for e in ev if e["name"] == "serve.call"]
    assert len(calls) == 1
    call = calls[0]["args"]
    assert (call["entry"], call["batch"], call["prompt"],
            call["new_tokens"]) == ("serve_batch_paged", B, P, N)
    assert call["parent"] is None and call["call"] == call["id"]
    assert all(e["args"]["call"] == call["id"] for e in ev)
    steps = sorted((e for e in ev if e["name"] == "serve.step"),
                   key=lambda e: e["ts"])
    assert [(e["args"]["phase"], e["args"]["step"]) for e in steps] == \
        [("prefill", i) for i in range(P)] + [("decode", i)
                                              for i in range(N)]
    assert all(e["args"]["parent"] == call["id"]
               and e["args"]["tokens"] == B for e in steps)

    def children(parent):
        return sorted((e for e in ev if e["args"]["parent"] == parent),
                      key=lambda e: e["ts"])
    for s in steps:
        kids = children(s["args"]["id"])
        assert [k["name"] for k in kids] == ["model.decode", "store.step"]
        model_decode, store = kids
        assert model_decode["args"]["batch"] == B
        assert store["args"]["requests"] == B * PAGED.window_pages
        assert [k["name"] for k in children(store["args"]["id"])] == \
            STORE_PARTS
        assert s["ts"] <= model_decode["ts"] and \
            store["ts"] + store["dur"] <= s["ts"] + s["dur"]
    assert len(ev) == 1 + (P + N) * (3 + len(STORE_PARTS))


def test_phase_spans_keep_their_names_with_layer_spans(model):
    rec = SpanRecorder()
    with rec.active():
        _, led = _paged(model, rec)
    names = [e["name"] for e in led["trace_spans"]]
    phase = [n for n in names if "." not in n]
    assert phase == ["prefill"] + ["decode_step"] * N + ["decode"]


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return prof.profiler.kineto_results.events()


def test_spans_are_profiler_annotations_on_its_clock(model):
    # a process's first `record_function` sets the profiler's op up (ms)
    _profiled(lambda: _batch(model))
    rec = SpanRecorder()
    with rec.active():
        events = _profiled(lambda: _paged(model))
    ann = {}
    for e in events:
        if e.is_user_annotation():
            ann.setdefault(e.name(), []).append(e.start_ns())
    for name in ["serve.call", "serve.step", "model.decode", "store.step",
                 *STORE_PARTS]:
        mine = sorted(e["ts"] * 1e3 for e in rec.events if e["name"] == name)
        theirs = sorted(ann[name])
        assert len(theirs) == len(mine) > 0, name
        assert max(abs(a - b) for a, b in zip(mine, theirs)) < 1e6, name


def test_profiler_alone_annotates_without_a_recorder(model):
    names = [e.name() for e in _profiled(lambda: _batch(model))
             if e.is_user_annotation()]
    assert names.count("serve.call") == 1
    assert names.count("serve.step") == names.count("model.decode") == P + N
