"""The benchmark's data: `BENCHMARK.json` against its contract, and every
configuration, traffic mix, limit file and metric reader it names."""
from __future__ import annotations

import ast
import json
import re

import pytest

from portbench import cell
from portbench.cell import HERE, ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_file_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names), names
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and m["layer"]


def test_every_cell_resolves_and_reports():
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = set()
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        spec = cell.load(w["name"])
        assert spec["config"]["name"] == w["config"]
        assert spec["traffic"]["name"] == w["traffic"]
        assert configs[w["config"]]["file"] == \
            f"portbench/configs/{w['config']}.json"
        assert set(configs[w["config"]]["reduced"]) == \
            set(spec["config"]["reduced"])
        cell.port_arch(spec["config"])
        names = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert spec["per_layer"]
        limits = spec["limits"]
        assert limits.keys() & {"logit_gap", "logit_gap_mean"}
        assert all(v is not None for v in limits.values())
        if spec["traffic"]["entry"] == "serve_batch_paged":
            assert limits["ledger_mismatch"] == 0
        used.add(w["config"])
    assert used == set(configs)


@pytest.mark.parametrize("sub", ["configs", "traffic", "limits"])
def test_data_files_parse(sub):
    files = sorted((HERE / sub).glob("*.json"))
    assert files
    for f in files:
        data = json.loads(f.read_text())
        assert isinstance(data, dict)
        if sub != "limits":
            assert data["name"] == f.stem


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_exists(metric):
    tree = ast.parse((HERE / "metrics" / f"{metric}.py").read_text())
    assert any(isinstance(n, ast.FunctionDef) and n.name == "read"
               for n in tree.body)


def test_each_cell_reports_what_its_layer_metrics_move():
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= set(cells), m["name"]
    for name in cells:
        spec = cell.load(name)
        e2e = {m["name"] for m in spec["end_to_end"]}
        for m in spec["per_layer"]:
            assert m["moves"] in e2e, (name, m["name"])


LOCAL_KV = [m["name"] for m in BENCH["per_layer"]
            if m["name"].endswith(".local_kv")
            and m["name"] != "tokens_per_s.local_kv"]


@pytest.mark.parametrize("metric", LOCAL_KV)
def test_local_kv_twin_reads_as_its_base(metric):
    from portbench.harness import load_metric
    ctx = {"model_s": [0.08, 0.09], "step_ms": [80.0, 90.0, 100.0],
           "call_flops": [1e12, 2e12], "traced_flops": 1e11,
           "call_s": [10.0, 5.0], "traced_s": 1.0,
           "trace": {"busy_s": 0.2, "window_s": 1.0},
           "span_events": None, "span_devices": None,
           "trace_steps": [24, 32]}
    base = metric[:-len(".local_kv")]
    assert load_metric(metric)(ctx) == load_metric(base)(ctx)


def test_local_kv_rate_leaves_out_the_profiled_call():
    from portbench.harness import load_metric
    read = load_metric("tokens_per_s.local_kv")
    tr = {"batch": 16, "calls": [[15, 196], [10, 55], [8, 20]]}
    ctx = {"traffic": tr, "trace_steps": [24, 32],
           "call_s": [30.0, 5.0, 2.0, 4.0]}
    # call 0 holds steps 24-31; call 3 runs the mix's first lengths again
    assert read(ctx) == pytest.approx(16 * (65 + 28 + 211) / 11.0)
    assert read({**ctx, "trace_steps": [211, 212]}) == \
        pytest.approx(16 * (211 + 28 + 211) / 36.0)
    assert read({**ctx, "call_s": [30.0]}) is None


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            for m in mods:
                assert m.split(".")[0] not in ("repro_torch", "repro", "jax",
                                               "jaxlib", "flax"), (path, m)


def test_check_budget_fits_a_full_benchmark():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("path", sorted((HERE / "traffic").glob("*.json")),
                         ids=lambda p: p.stem)
def test_traffic_lengths_follow_their_source(path):
    tr = json.loads(path.read_text())
    prompts = [p for p, _ in tr["calls"]]
    outputs = [n for _, n in tr["calls"]]
    assert min(prompts) >= 1 and min(outputs) >= 1
    assert sum(prompts) / len(prompts) == pytest.approx(tr["prompt_mean"],
                                                        rel=0.02)
    assert sum(outputs) / len(outputs) == pytest.approx(tr["output_mean"],
                                                        rel=0.02)
    # the longest call runs first, so every window holds it
    assert sum(tr["calls"][0]) == max(p + n for p, n in tr["calls"])
    assert tr["lengths_source"]
    if "paged" in tr:
        for w in BENCH["workloads"]:
            if w["traffic"] == tr["name"]:
                page = cell.load(w["name"])["config"]["store"]["page_tokens"]
                assert max(p + n for p, n in tr["calls"]) <= \
                    tr["paged"]["pages_per_seq"] * page


def test_every_seed_runs_the_same_lengths():
    tr = cell.load("qwen3-1.7b.decode-b16")["traffic"]
    k = len(tr["calls"])
    assert [cell.call_lengths(tr, c) for c in range(2 * k)] == \
        [tuple(x) for x in tr["calls"]] * 2
    assert sum(cell.warm_lengths(tr)) == min(p + n for p, n in tr["calls"])


def test_sample_holds_the_longest_call():
    sizes = [(16, 9), (16, 196), (16, 20)]
    for seed in (1, 2, 2 ** 31 + 5):
        picks = cell.sample(seed, sizes, 16)
        assert len(set(picks)) == 16
        assert any(c == 1 for c, _ in picks)
        assert picks == cell.sample(seed, sizes, 16)
