"""A whole run of the harness at a tiny size on the CPU, past its look
for a card: the result line's schema, the refusal of JAX and of the JAX
package by whole top-level names, and `correct` coming out false with
the timed path broken underneath."""
from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness, smoke
from portbench.cell import ROOT

DRY_RUN = """
import sys, time
sys.path[:0] = [{src!r}, {root!r}]
{inject}
from portbench import harness, smoke
import run
result = harness.run_cell(smoke.spec({entry!r}), 2**31 + 5, 0.2, {trace},
                          "cpu", time.perf_counter())
sys.exit(run.report(result))
"""


def _dry_run(entry="serve_batch_paged", trace=False, inject=""):
    code = DRY_RUN.format(src=str(ROOT / "src"), root=str(ROOT), entry=entry,
                          trace=trace, inject=inject)
    return subprocess.run([sys.executable, "-c", code],
                          cwd=ROOT / "portbench", capture_output=True,
                          text=True, timeout=600)


@pytest.mark.parametrize("entry,trace", [("serve_batch_paged", False),
                                         ("serve_batch_paged", True),
                                         ("serve_batch", True)])
def test_result_line_schema(entry, trace):
    proc = _dry_run(entry, trace)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 3
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"step_ms_p95", "model_ms_per_step",
                "step_mfu"} <= set(line["metrics"])
        if entry == "serve_batch_paged":
            assert {"store_ms_per_step",
                    "schedule_ms_per_step"} <= set(line["metrics"])
    else:
        assert set(line["metrics"]) == {m["name"]
                                         for m in bench["end_to_end"]}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    err = proc.stderr.strip().splitlines()
    names = list(line["checks"])
    assert [e.split()[1] for e in err[-len(names):]] == names


@pytest.mark.parametrize("module", ["jax", "repro", "repro.core", "flax"])
def test_refuses_jax_and_the_jax_package(module):
    inject = (f"import types; sys.modules[{module!r}] = "
              f"types.ModuleType({module!r})")
    proc = _dry_run(inject=inject)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert module.split(".")[0] in proc.stderr


def test_forbidden_names_are_whole_top_level_names():
    before = dict(sys.modules)
    try:
        sys.modules["repro_torch_lookalike"] = type(sys)("x")
        found = harness.forbidden_modules(("repro",))
        assert "repro_torch_lookalike" not in found
        assert not any(m.startswith("repro_torch") for m in found)
    finally:
        sys.modules.clear()
        sys.modules.update(before)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the refusal")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "qwen3-1.7b.decode-b16", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def _run(spec, trace=False):
    return harness.run_cell(spec, 2 ** 31 + 9, 0.1, trace, "cpu",
                            time.perf_counter())


@pytest.mark.parametrize("trace", [False, True])
def test_only_a_traced_run_records_layer_spans(trace, monkeypatch):
    from repro_torch.runtime import obs
    made = []

    class Counted(obs.SpanRecorder):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)
    monkeypatch.setattr(obs, "SpanRecorder", Counted)
    result = _run(smoke.spec(), trace)
    assert result["correct"]
    layer = [r for r in made
             if any(e["name"] == "store.schedule" for e in r.events)]
    if trace:
        assert len(layer) == 1
        assert "schedule_ms_per_step" in result["metrics"]
    else:
        assert made == []


def test_sound_run_is_correct():
    assert _run(smoke.spec())["correct"]


def _state_unchanged_decode(sl):
    real = sl.decode_step

    def fault(params, cfg, state, tokens, pos, opt):
        copy = {"runs": tuple({k: v.clone() for k, v in r.items()}
                              for r in state["runs"])}
        logits, _ = real(params, cfg, copy, tokens, pos, opt)
        return logits, state
    return "decode_step", fault


def _state_unchanged_store(sl):
    return "step_fetch_batch", lambda state, *a, **k: (state, None, None,
                                                       None)


def _half_batch_decode(sl):
    real = sl.decode_step

    def fault(params, cfg, state, tokens, pos, opt):
        logits, state = real(params, cfg, state, tokens, pos, opt)
        half = logits.shape[0] // 2
        return torch.cat([logits[:half], torch.zeros_like(logits[half:])]), \
            state
    return "decode_step", fault


def _half_batch_store(sl):
    from repro_torch.core.compute_plane import tree_map
    real = sl.step_fetch_batch

    def fault(state, cfg, rk, rv, need, offs, writes, policy=None):
        half = need.shape[0] // 2
        part = state._replace(seqs=tree_map(lambda t: t[:half], state.seqs))
        new, k, v, hit = real(part, cfg, rk, rv, need[:half], offs[:half],
                              writes[:half], policy=policy)
        seqs = tree_map(lambda a, b: torch.cat([a, b[half:]]), new.seqs,
                        state.seqs)
        return new._replace(seqs=seqs), k, v, hit
    return "step_fetch_batch", fault


def _token_altered(sl):
    real = sl.make_decode_fn

    def make(cfg, opt):
        step = real(cfg, opt)

        def altered(params, state, tokens, pos, gen, temperature):
            nxt, state = step(params, state, tokens, pos, gen, temperature)
            if pos == 7:
                nxt = nxt.clone()
                nxt[0] = (nxt[0] + 1) % cfg.vocab_size
            return nxt, state
        return altered
    return "make_decode_fn", make


def _answer_altered(sl):
    real = sl.store_ledger

    def ledger(kv):
        out = real(kv)
        out["local_hits"] += 1
        return out
    return "store_ledger", ledger


@pytest.mark.parametrize("fault", [_state_unchanged_decode,
                                   _state_unchanged_store,
                                   _half_batch_decode, _half_batch_store,
                                   _token_altered, _answer_altered])
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    from repro_torch.runtime import serve_loop
    name, fn = fault(serve_loop)
    monkeypatch.setattr(serve_loop, name, fn)
    assert _run(smoke.spec())["correct"] is False
