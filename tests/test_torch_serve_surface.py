"""The rest of the port's serving surface against the reference's, on
reduced qwen3-1.7b in f32: `serve_batch`, `serve_replicated`, `prefill`,
`serve_batch_paged` with a link-health monitor and a span recorder, and
the serve launcher.

Parameters come from the reference's `init_model` through
`convert.params_from_numpy`. Greedy tokens must be equal and ledgers
within rtol 1e-5, atol 1e-6; `prefill` against the token-by-token decode
at the tolerance of tests/test_equivalence.py:116 (atol 3e-2, rtol 1e-2
on logits, atol 3e-2 on caches), and against the reference's `prefill`
at rtol = atol = 1e-4 (f32 sums taken in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fabric as JF
from repro.core.daemon_store import KVStoreConfig as JKVStoreConfig
from repro.core.daemon_store import link_bytes_per_step
from repro.core.telemetry import TelemetryConfig as JTelemetryConfig
from repro.models.model import ModelOptions as JModelOptions
from repro.models.model import prefill as j_prefill
from repro.runtime import serve_loop as JL
from repro.runtime.fault import LinkHealthMonitor as JMonitor
from repro_torch.configs import get_config
from repro_torch.core import fabric as TF
from repro_torch.core.daemon_store import KVStoreConfig
from repro_torch.core.telemetry import TelemetryConfig
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import (ModelOptions, decode_step,
                                      init_decode_state, prefill)
from repro_torch.runtime import serve_loop as TL
from repro_torch.runtime.mesh_plane import serve_replicated_sharded
from repro_torch.runtime.fault import LinkHealthMonitor as TMonitor
from repro_torch.runtime.obs import SpanRecorder
from test_torch_serve import STORE, _setup

torch.set_num_threads(1)


def _assert_ledgers(j_led, led):
    assert set(led) == set(j_led)
    for k, v in j_led.items():
        if k in ("trace_spans", "_tel"):
            continue
        if k == "link_reshard_modules":
            assert led[k] == v
            continue
        np.testing.assert_allclose(led[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_serve_batch_matches_reference():
    jcfg, cfg, j_params, params, prompts = _setup()
    j_tokens = JL.serve_batch(j_params, jcfg, jnp.asarray(prompts),
                              JL.ServeConfig(max_new_tokens=8))
    rec = SpanRecorder()
    tokens = TL.serve_batch(params, cfg, torch.from_numpy(prompts),
                            TL.ServeConfig(max_new_tokens=8),
                            recorder=rec, device="cpu")
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(j_tokens))
    assert [e["name"] for e in rec.events] == ["prefill", "decode"]


@pytest.mark.parametrize("c", [1, 2])
def test_serve_replicated_matches_reference(c):
    """C replicas x 2 tenants: tokens and the whole ledger, NIC bytes
    included (`unit_bytes`), through the reference's vmap path."""
    jcfg, cfg, j_params, params, prompts = _setup()
    pcfg = dict(window_pages=2, pages_per_seq=8)
    j_tokens, j_led = JL.serve_replicated(
        j_params, jcfg, jnp.asarray(prompts), JL.ServeConfig(
            max_new_tokens=6), JKVStoreConfig(**STORE), c,
        JL.PagedServeConfig(**pcfg))
    tokens, led = TL.serve_replicated(
        params, cfg, torch.from_numpy(prompts),
        TL.ServeConfig(max_new_tokens=6), KVStoreConfig(**STORE), c,
        TL.PagedServeConfig(**pcfg), device="cpu")
    assert tokens.shape == (c, 2, 12)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(j_tokens))
    _assert_ledgers(j_led, led)
    assert led["requests"] == c * 2 * 2 * 12
    if c > 1:
        np.testing.assert_allclose(sum(led["unit_bytes"]),
                                   led["wire_bytes"], rtol=1e-6)
    # the mesh placement needs a process group (tests/test_torch_mesh_plane
    # runs it on spawned gloo ranks)
    with pytest.raises(RuntimeError, match="process group"):
        serve_replicated_sharded(params, cfg, torch.from_numpy(prompts),
                                 TL.ServeConfig(max_new_tokens=1),
                                 KVStoreConfig(**STORE), 2, device="cpu")


def test_serve_batch_paged_monitor_and_recorder_match_reference():
    """A degraded module on a scheduled link with a LinkHealthMonitor,
    and telemetry at "trace" (a recorder made by the loop): the ledger,
    reshard advisories, stall percentiles and span names agree."""
    jcfg, cfg, j_params, params, prompts = _setup()
    tel = dict(level="trace", lat_lo=0.01, lat_hi=1e4)
    j_store = JKVStoreConfig(**STORE, fabric=JF.FabricConfig(num_modules=3),
                             telemetry=JTelemetryConfig(**tel))
    t_store = KVStoreConfig(**STORE, fabric=TF.FabricConfig(num_modules=3),
                            telemetry=TelemetryConfig(**tel))
    sched = (np.array([0.0, 4.0, 9.0], np.float32),
             np.ones((3, 3), np.float32),
             np.array([[1.0, 1.0, 1.0], [1.0, 0.05, 1.0],
                       [1.0, 0.05, 1.0]], np.float32))
    bw = link_bytes_per_step(j_store)
    pcfg = dict(window_pages=2, pages_per_seq=8)
    j_tokens, j_led = JL.serve_batch_paged(
        j_params, jcfg, jnp.asarray(prompts), JL.ServeConfig(
            max_new_tokens=8), j_store, JL.PagedServeConfig(**pcfg),
        link=JF.scheduled_link(bw, sched, 3),
        health_monitor=JMonitor(floor=0.5, patience=2))
    tokens, led = TL.serve_batch_paged(
        params, cfg, torch.from_numpy(prompts),
        TL.ServeConfig(max_new_tokens=8), t_store,
        TL.PagedServeConfig(**pcfg), link=TF.scheduled_link(bw, sched, 3),
        health_monitor=TMonitor(floor=0.5, patience=2), device="cpu")
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(j_tokens))
    _assert_ledgers(j_led, led)
    assert led["link_reshard_modules"] == [1]
    assert led["stall_p99_steps"] > 0
    assert [e["name"] for e in led["trace_spans"]] == \
        [e["name"] for e in j_led["trace_spans"]]
    np.testing.assert_array_equal(led["_tel"].hist.numpy(),
                                  np.asarray(j_led["_tel"].hist))


def test_prefill_matches_decode_and_reference():
    """One-pass prefill: last-position logits and caches against the
    port's token-by-token decode, and all logits and caches against the
    reference's `prefill`."""
    jcfg, cfg, j_params, params, prompts = _setup()
    toks = prompts[:, :6]
    j_opt = JModelOptions(remat="none", flash_threshold=10_000)
    opt = ModelOptions(remat="none", flash_threshold=10_000)
    j_logits, j_state = j_prefill(j_params, jcfg,
                                  {"tokens": jnp.asarray(toks)}, 12, j_opt)
    logits, state = prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                            12, opt)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               rtol=1e-4, atol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(state["runs"][0][key].numpy(),
                                   np.asarray(j_state["runs"][0][key]),
                                   rtol=1e-4, atol=1e-4)
    dec = init_decode_state(cfg, 2, 12, opt, device="cpu")
    for i in range(toks.shape[1]):
        last, dec = decode_step(params, cfg, dec,
                                torch.from_numpy(toks[:, i:i + 1]), i, opt)
    np.testing.assert_allclose(state["runs"][0]["k"][:, :, :6].numpy(),
                               dec["runs"][0]["k"][:, :, :6].numpy(),
                               atol=3e-2)
    np.testing.assert_allclose(logits[:, -1].numpy(), last.numpy(),
                               atol=3e-2, rtol=1e-2)
    assert not state["runs"][0]["k"][:, :, 6:].any()


def test_launch_serve_runs_on_cpu(capsys):
    out = launch_serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                             "--prompt-len", "3", "--new-tokens", "2"])
    assert out.shape == (2, 5)
    assert "[serve]" in capsys.readouterr().out


def test_new_entry_points_default_to_the_card():
    """Without a card, every entry point this surface adds raises rather
    than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.core import daemon_store as TS
    cfg = get_config("qwen3-1.7b").reduced()
    store = KVStoreConfig(**STORE)
    prompts = torch.zeros((1, 2), dtype=torch.int32)
    calls = [
        lambda: TS.init_kv_store(store),
        lambda: TS.init_kv_store_replicated(store, 2, 1),
        lambda: TL.serve_batch({}, cfg, prompts, TL.ServeConfig()),
        lambda: TL.serve_replicated({}, cfg, prompts, TL.ServeConfig(),
                                    store, 2),
        lambda: launch_serve.main(["--reduced"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
