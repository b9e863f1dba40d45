"""One run of one cell: set-up, the measured window, the comparison that
decides `correct`, and the metrics of the result line.

Set-up builds everything from the seed (weights on the device, the
port's entry with its configuration) and makes one warm call at the
cell's own batch and the mix's shortest lengths, which builds the port's
kernels on a checkout's first run and loads them on every later one.
The window then calls the entry back to back (a closed loop) on fresh
prompts, through the mix's lengths in order, until `seconds` have
passed; the call running then completes, and each call's tokens and
store ledger are kept for the comparison.

A traced run (`trace=True`) wraps, for the window only, `decode_step`
and `step_fetch_batch` as `runtime.serve_loop` looks them up (each wrap
synchronises the device before and after, so its span covers the work
it queued), labels the store's parts for the device trace, keeps the
serve loop's own `decode_step` spans, records the device trace of the
traffic's `trace_steps` (decode steps counted from the window's start),
and makes one `SpanRecorder` of the port active over the window's
calls: the metric readers get its layer spans (`span_events`) and the
device launches and seconds that `spans.attribute` gives each span in
the profiled steps (`span_devices`). An untraced run makes none of
these.
"""
from __future__ import annotations

import contextlib
import importlib.util
import subprocess
import time

import torch

from portbench import cell as cellmod
from portbench import counts, devtrace, judge, spans
from portbench.cell import HERE

STORE_PARTS = ("_residency", "_remote_fetch", "_writebacks", "_schedule")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Tracer:
    """The traced run's wraps, its profiler and its recorder of the
    port's layer spans (`recorder`); `install` patches the serve loop's
    and the store's module globals, `restore` puts them back."""

    def __init__(self, device, trace_steps):
        from repro_torch.runtime.obs import SpanRecorder
        self.device = device
        self.recorder = SpanRecorder()
        self.first, self.last = trace_steps
        self.model_s, self.store_s = [], []
        self.steps = 0
        self.t_start = 0.0
        self.window = None
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.running = False
        self._saved = []

    def _timed(self, fn, label, out):
        """`fn` in a synchronised span; its seconds go to `out` unless
        the step is one the profiler records (its cost is not the
        step's)."""
        def wrapped(*args, **kwargs):
            _sync(self.device)
            t = time.perf_counter()
            with torch.profiler.record_function(label):
                result = fn(*args, **kwargs)
            _sync(self.device)
            if not self.traced(self.steps - 1):
                out.append(time.perf_counter() - t)
            return result
        return wrapped

    def traced(self, step: int) -> bool:
        """Whether global decode step `step` is one the profiler
        records."""
        return self.first <= step < self.last

    def _labelled(self, fn, label):
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return wrapped

    def _at_step(self, fn):
        def wrapped(*args, **kwargs):
            if self.steps == self.first:
                _sync(self.device)
                self.prof.start()
                self.running = True
                self.t_start = time.perf_counter()
            if self.steps == self.last:
                self.stop()
            self.steps += 1
            return fn(*args, **kwargs)
        return wrapped

    def stop(self):
        if self.running:
            _sync(self.device)
            self.window = time.perf_counter() - self.t_start
            self.prof.stop()
            self.running = False

    def _patch(self, module, name, fn):
        self._saved.append((module, name, getattr(module, name)))
        setattr(module, name, fn)

    def install(self, serve_loop, daemon_store):
        model = self._timed(serve_loop.decode_step, "portbench.model_decode",
                            self.model_s)
        self._patch(serve_loop, "decode_step", self._at_step(model))
        self._patch(serve_loop, "step_fetch_batch",
                    self._timed(serve_loop.step_fetch_batch,
                                "portbench.store_step", self.store_s))
        for part in STORE_PARTS:
            self._patch(daemon_store, part,
                        self._labelled(getattr(daemon_store, part),
                                       f"daemon_store.{part}"))

    def restore(self):
        self.stop()
        for module, name, fn in reversed(self._saved):
            setattr(module, name, fn)
        self._saved.clear()

    def span_devices(self):
        """`spans.attribute` over the profiled window: per span name the
        device launches and seconds; None without a profiled window."""
        if self.window is None:
            return None
        names = {e["name"] for e in self.recorder.events}
        return spans.attribute(*spans.profile_events(self.prof, names)[:3])


def make_entry(spec: dict, arch, params, device):
    """call(prompts (B, P), N, recorder) -> (tokens (B, P + N), ledger or
    None)."""
    from repro_torch.runtime import serve_loop as sl
    tr = spec["traffic"]

    def scfg(new_tokens):                 # greedy: the comparison needs it
        return sl.ServeConfig(max_new_tokens=new_tokens, temperature=0.0,
                              seed=0)
    if tr["entry"] == "serve_batch":
        def call(prompts, new_tokens, recorder=None):
            return sl.serve_batch(params, arch, prompts, scfg(new_tokens),
                                  recorder=recorder, device=device), None
        return call
    if tr["entry"] != "serve_batch_paged":
        raise ValueError(f"unknown entry {tr['entry']!r}")
    from repro_torch.core.daemon_store import KVStoreConfig
    from repro_torch.core.fabric import FabricConfig
    from repro_torch.core.params import DaemonParams
    g = cellmod.store_geometry(spec)
    if g.get("telemetry", "off") != "off":
        raise ValueError("the store runs with telemetry off")
    if (g["kv_heads"], g["head_dim"]) != (arch.num_kv_heads,
                                          arch.resolved_head_dim):
        raise ValueError("the store's KV shape is not the model's")
    store = KVStoreConfig(
        num_local_pages=g["num_local_pages"], page_tokens=g["page_tokens"],
        kv_heads=g["kv_heads"], head_dim=g["head_dim"],
        daemon=DaemonParams(bw_ratio=g["bw_ratio"]),
        compress_pages=g["compress_pages"],
        page_budget_per_step=g["page_budget_per_step"],
        fabric=FabricConfig(num_modules=g["num_modules"]),
        policy=g["policy"], pool_ways=g["pool_ways"])
    pcfg = sl.PagedServeConfig(**tr["paged"])

    def call(prompts, new_tokens, recorder=None):
        return sl.serve_batch_paged(params, arch, prompts, scfg(new_tokens),
                                    store, pcfg, recorder=recorder,
                                    device=device)
    return call


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def load_metric(name: str):
    """The reader `metrics/<name>.py` (its `read(ctx)`)."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def store_refs(spec: dict, lengths) -> dict:
    """The NumPy store's (ledger, landings per step, misses per step)
    for each distinct (prompt, new tokens) of `lengths`."""
    from portbench.reference import store
    tr, g = spec["traffic"], cellmod.store_geometry(spec)
    return {(p, n): store.simulate(g, tr["batch"], p, n,
                                   tr["paged"]["window_pages"],
                                   tr["paged"]["pages_per_seq"])
            for p, n in sorted(set(lengths))}


def compare(spec: dict, weights: dict, calls: list, seed: int,
            refs) -> tuple:
    """(values, failed): the numbers `judge` holds to the limits, and how
    many sampled sequences and ledger calls failed them. `calls`: each
    completed call's (tokens, ledger, prompt tokens); `refs`: the store
    reference's by lengths, or None."""
    cfg, tr = spec["config"], spec["traffic"]
    limits = spec["limits"]
    values, failed = {}, 0
    sizes = [(t.shape[0], t.shape[1] - p) for t, _, p in calls]
    picks = cellmod.sample(seed, sizes, tr["sample_sequences"])
    ref = cellmod.reference(cfg)
    device = weights["embed"].device
    gaps = []
    for c in sorted({c for c, _ in picks}):
        tokens, _, p = calls[c]
        rows = [r for cc, r in picks if cc == c]
        for i in range(0, len(rows), 4):
            block = tokens[rows[i:i + 4]].to(device)
            logits = ref.logits(weights, cfg, block[:, :-1])
            gaps.append(judge.served_gaps(logits, block, p).cpu())
            del logits
    values["logit_gap"] = max(float(g.max()) for g in gaps)
    values["logit_gap_mean"] = float(torch.cat([g.flatten() for g in gaps])
                                     .mean())
    for name, per_seq in (("logit_gap", lambda g: g.amax(dim=1)),
                          ("logit_gap_mean", lambda g: g.mean(dim=1))):
        if limits.get(name) is not None:
            failed += sum(int((per_seq(g) > limits[name]).sum())
                          for g in gaps)
    if refs is not None:
        want = [refs[(p, t.shape[1] - p)][0] for t, _, p in calls]
        bad = [judge.ledger_mismatch(led, w)
               for (_, led, _), w in zip(calls, want)]
        values["ledger_mismatch"] = float(max(len(x) for x in bad))
        values["stall_rel_gap"] = max(judge.stall_rel_gap(led, w)
                                      for (_, led, _), w in zip(calls, want))
        failed += sum(t.shape[0] for (t, _, _), x in zip(calls, bad) if x)
    return values, failed


def step_of(traffic: dict, step: int) -> tuple:
    """(call, position) of window decode step `step`, counted from 0
    over the window's calls in order."""
    call = 0
    while True:
        p, n = cellmod.call_lengths(traffic, call)
        if step < p + n:
            return call, step
        step -= p + n
        call += 1


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             t0: float) -> dict:
    """One run; returns the result line's object."""
    from repro_torch.core import daemon_store
    from repro_torch.runtime import serve_loop
    from repro_torch.runtime.obs import SpanRecorder
    cfg, tr = spec["config"], spec["traffic"]
    b = tr["batch"]
    paged = tr["entry"] == "serve_batch_paged"
    cuda = torch.device(device).type == "cuda"
    arch = cellmod.port_arch(cfg)
    weights = cellmod.make_weights(cfg, seed, device)
    params = cellmod.port_params(weights, cfg)
    call = make_entry(spec, arch, params, device)

    def prompts(c, p):
        return torch.as_tensor(cellmod.prompts(seed, c, b, p,
                                               cfg["vocab_size"]),
                               device=device)

    p, n = cellmod.warm_lengths(tr)
    call(prompts(cellmod.WARM_CALL, p), n)             # the warm call
    _sync(device)
    setup_s = time.perf_counter() - t0
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    tracer = Tracer(device, tr["trace_steps"]) if trace else None
    if tracer:
        tracer.install(serve_loop, daemon_store)
    calls, step_spans, call_s = [], [], []
    steps = 0
    try:
        start = time.perf_counter()
        end = start
        while end - start < seconds:
            c = len(calls)
            p, n = cellmod.call_lengths(tr, c)
            rec = SpanRecorder() if tracer and paged else None
            layer_spans = tracer.recorder.active() if tracer \
                else contextlib.nullcontext()
            began = time.perf_counter()
            with layer_spans:
                tokens, led = call(prompts(c, p), n, rec)
            _sync(device)
            end = time.perf_counter()
            calls.append((tokens, led, p))
            call_s.append(end - began)
            if rec is not None:
                step_spans += [e["dur"] / 1e3 for e in rec.events
                               if e["name"] == "decode_step" and not
                               tracer.traced(steps + p + e["args"]["step"])]
            steps += p + n
    finally:
        if tracer:
            tracer.restore()
    window_s = end - start
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    lengths = [(p, t.shape[1] - p) for t, _, p in calls]
    refs = store_refs(spec, lengths) if paged else None
    del params
    if cuda:
        torch.cuda.empty_cache()
    values, failed = compare(spec, weights, calls, seed, refs)
    correct, checks = judge.verdict(values, spec["limits"])

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(max(peak,
                                                            peak_setup)),
                   "power_limit": _power_limit() if cuda else "none"}
    result = {"correct": correct, "attempted": len(calls) * b,
              "failed": failed, "metrics": {}, "device": device_info}
    if not trace:
        values_e2e = {"tokens_per_s": b * steps / window_s,
                      "peak_gib": peak / 2 ** 30, "setup_s": setup_s}
        for m in spec["end_to_end"]:
            result["metrics"][m["name"]] = {"value": values_e2e[m["name"]],
                                            "unit": m["unit"]}
    else:
        summary = None
        if tracer.window is not None:
            summary = devtrace.summarize(tracer.prof, tracer.window)
            device_info["busy_s"] = summary["busy_s"]
            device_info["window_s"] = summary["window_s"]
            result["breakdown"] = {"device_ops": summary["device_ops"],
                                   "idle_gaps": summary["idle_gaps"]}
        traced = [step_of(tr, s) for s in range(*tr["trace_steps"])]
        per_step = None
        if paged:
            per_step = {"landings": [], "misses": []}
            for c, pos in traced:
                _, landings, misses = refs[cellmod.call_lengths(tr, c)]
                per_step["landings"].append(landings[pos])
                per_step["misses"].append(misses[pos])
        ctx = {"spec": spec, "config": cfg, "traffic": tr,
               "geometry": cellmod.store_geometry(spec) if paged else None,
               "calls": len(calls), "steps": steps,
               "window_s": window_s, "call_s": call_s,
               "call_flops": [counts.call_flops(cfg, b, p + n)
                              for p, n in lengths],
               "traced_s": tracer.window or 0.0,
               "traced_flops": b * sum(counts.token_flops(cfg, pos)
                                       for _, pos in traced),
               "model_s": tracer.model_s,
               "store_s": tracer.store_s,
               "step_ms": (step_spans if paged
                           else [s * 1e3 for s in tracer.model_s]),
               "trace": summary, "trace_steps": tr["trace_steps"],
               "store_per_step": per_step,
               "span_events": tracer.recorder.events,
               "span_devices": tracer.span_devices()}
        for m in spec["per_layer"]:
            value = load_metric(m["name"])(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
    result["call_s"] = call_s
    result["checks"] = checks
    return result


def forbidden_modules(names=("jax", "jaxlib", "flax", "repro")) -> list:
    """Loaded modules whose top-level name is one of `names`, whole."""
    import sys
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in names)
