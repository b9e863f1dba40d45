"""The port's model families against the reference, on reduced configs
in f32: dense (qwen3-8b, yi-9b, minitron-4b), MoE (olmoe-1b-7b,
qwen3-moe-30b-a3b), the Mamba2 hybrid (zamba2-2.7b), xLSTM (xlstm-125m),
audio encoder-decoder (whisper-base) and vision-language
(internvl2-26b).

Parameters come from the reference's `init_model` through
`convert.params_from_numpy`, tokens and the frontend stubs' embeddings
from a numpy seed, so both packages compute the same function.
Tolerances: forward logits, loss, xent and aux, decode and prefill
logits and states within rtol = atol = 1e-4 (f32 sums taken in another
order); `serve_batch_paged` gives equal greedy tokens and a ledger
within rtol 1e-5, atol 1e-6 (tests/test_torch_serve.py's bar)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.core.daemon_store import KVStoreConfig as JKVStoreConfig
from repro.models import model as JMod
from repro.runtime.serve_loop import PagedServeConfig as JPaged
from repro.runtime.serve_loop import ServeConfig as JServe
from repro.runtime.serve_loop import serve_batch_paged as j_serve
from repro_torch import convert
from repro_torch.configs import get_config, get_shape, list_archs
from repro_torch.configs.base import ATTN, PORT_OPTIONS, ArchConfig
from repro_torch.core.compute_plane import tree_map
from repro_torch.core.daemon_store import KVStoreConfig
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as TMod
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime.serve_loop import (PagedServeConfig, ServeConfig,
                                            serve_batch_paged)
from repro_torch.runtime.train_loop import TrainConfig, make_train_step

torch.set_num_threads(1)

ARCHS = ("qwen3-8b", "yi-9b", "minitron-4b", "olmoe-1b-7b",
         "qwen3-moe-30b-a3b", "zamba2-2.7b", "xlstm-125m", "whisper-base",
         "internvl2-26b")
NOT_PORTED = ()
TOL = dict(rtol=1e-4, atol=1e-4)
STORE = dict(num_local_pages=4, page_tokens=2, kv_heads=2, head_dim=16,
             page_budget_per_step=2)


def _opts(**kw):
    """The same options for both packages: direct attention, no remat,
    SSD chunks of 4 (several chunks per sequence)."""
    common = dict(remat="none", flash_threshold=10_000, ssd_chunk=4, **kw)
    return JMod.ModelOptions(**common), TMod.ModelOptions(**common)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg = j_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    j_params, _ = JMod.init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jax.device_get(j_params)


def _params(cfg, np_params):
    return convert.params_from_numpy(np_params, cfg, "cpu")


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab_size, shape).astype(np.int32)


def _frontend(cfg, b, seed=3):
    """The stub's `frontend` input for a batch of `b` (empty without a
    frontend): patch embeddings (b, F, D) or audio frames (b, T_enc,
    D)."""
    if not cfg.frontend:
        return {}
    rows = cfg.frontend_tokens if cfg.frontend == "vision_stub" \
        else cfg.encoder_seq
    return {"frontend": (np.random.default_rng(seed).standard_normal(
        (b, rows, cfg.d_model)) * 0.5).astype(np.float32)}


def _pairs(a, b, path=""):
    """(path, reference leaf, port leaf) over the reference tree's keys."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _pairs(x, y, f"{path}[{i}]")
    else:
        yield path, np.asarray(a), b


def _assert_trees(a, b, **tol):
    n = 0
    for path, x, y in _pairs(a, b):
        if isinstance(y, torch.Tensor):
            y = convert.to_numpy(y)
        np.testing.assert_allclose(y, x, err_msg=path, **tol)
        n += 1
    assert n >= 2


# --------------------------------------------------------------------------
# configs and layout
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch):
    for j, t in ((j_get_config(arch), get_config(arch)),
                 (j_get_config(arch).reduced(), get_config(arch).reduced())):
        # the port's own options, at the values that keep the reference's
        # block, and every field of the reference's, equal
        mine = dataclasses.asdict(t)
        assert {k: mine.pop(k) for k in PORT_OPTIONS} == PORT_OPTIONS
        assert mine == dataclasses.asdict(j)
        for active in (False, True):
            assert t.param_count(active) == j.param_count(active)


def test_registry_and_what_stays_unported():
    """Every arch of the reference is registered and none is left
    unported: each one's reduced config builds its parameters and decode
    state in the port."""
    assert list_archs() == sorted(ARCHS + ("qwen3-1.7b",))
    assert set(j_list_archs()) == set(list_archs()) | set(NOT_PORTED)
    assert not hasattr(TMod, "_check_ported")
    for name in j_list_archs():
        cfg = ArchConfig(**dataclasses.asdict(j_get_config(name))).reduced()
        TMod.init_model(cfg, torch.Generator().manual_seed(0))
        TMod.init_decode_state(cfg, 1, 4, TMod.ModelOptions(), device="cpu")
    assert get_config("olmoe-1b-7b").param_count() == 6_919_100_416
    assert get_config("zamba2-2.7b").param_count() == 2_422_382_528


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_state_layout_match_reference(arch):
    """The port's own init_model and init_decode_state give the
    reference's trees (keys, shapes, dtypes), ring cache included; the
    reference's trees cross into the port and back unchanged."""
    jcfg, cfg, np_params = _setup(arch)
    mine = TMod.init_model(cfg, torch.Generator().manual_seed(0))
    for path, a, b in _pairs(np_params, mine):
        assert tuple(b.shape) == a.shape, path
        assert b.dtype == torch.float32, path
    ported = _params(cfg, np_params)
    _assert_trees(np_params, convert.tree_to_numpy(ported), rtol=0, atol=0)
    for ring in (False, True):
        jopt, opt = _opts(window_ring=ring, window_override=(
            8 if ring else None))
        j_state, _ = JMod.init_decode_state(jcfg, 2, 12, jopt)
        j_state = jax.device_get(j_state)
        state = TMod.init_decode_state(cfg, 2, 12, opt, device="cpu")
        for path, a, b in _pairs(j_state, state):
            assert tuple(b.shape) == a.shape, path
            assert str(b.dtype).split(".")[-1] == str(a.dtype), path
        back = convert.state_to_numpy(convert.state_from_numpy(j_state,
                                                               "cpu"))
        _assert_trees(j_state, back, rtol=0, atol=0)


# --------------------------------------------------------------------------
# forward, loss, decode, prefill
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    jcfg, cfg, np_params = _setup(arch)
    jopt, opt = _opts()
    toks = _tokens(cfg, (2, 16))
    mask = np.ones((2, 16), np.float32)
    mask[1, 10:] = 0.0
    batch = {"tokens": toks, "labels": toks, "mask": mask,
             **_frontend(cfg, 2)}
    j_logits, j_aux = jax.jit(lambda p, b: JMod.forward(p, jcfg, b, jopt))(
        np_params, batch)
    (j_loss, j_m) = jax.jit(lambda p, b: JMod.loss_fn(p, jcfg, b, jopt))(
        np_params, batch)
    params = _params(cfg, np_params)
    tb = convert.batch_from_numpy(batch, "cpu")
    with torch.no_grad():
        logits, aux = TMod.forward(params, cfg, tb, opt)
        loss, m = TMod.loss_fn(params, cfg, tb, opt)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)
    np.testing.assert_allclose(float(aux), float(j_aux), **TOL)
    np.testing.assert_allclose(float(loss), float(j_loss), **TOL)
    for k in ("xent", "aux"):
        np.testing.assert_allclose(float(m[k]), float(j_m[k]), **TOL,
                                   err_msg=k)
    if cfg.is_moe:
        assert float(aux) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference_over_8_steps(arch):
    jcfg, cfg, np_params = _setup(arch)
    jopt, opt = _opts()
    params = _params(cfg, np_params)
    toks = _tokens(cfg, (2, 8))
    j_state, _ = JMod.init_decode_state(jcfg, 2, 8, jopt)
    state = TMod.init_decode_state(cfg, 2, 8, opt, device="cpu")
    j_step = jax.jit(lambda p, s, t, pos: JMod.decode_step(
        p, jcfg, s, t, pos, jopt))
    for pos in range(8):
        j_logits, j_state = j_step(np_params, j_state,
                                   jnp.asarray(toks[:, pos:pos + 1]),
                                   jnp.int32(pos))
        logits, state = TMod.decode_step(
            params, cfg, state, torch.from_numpy(toks[:, pos:pos + 1]), pos,
            opt)
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                                   **TOL, err_msg=f"pos {pos}")
    _assert_trees(jax.device_get(j_state), state, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    """Logits and state (12 cache rows past the frontend's tokens); the
    recurrent states (hybrid, xLSTM) stay zero in both, and only the
    attention stacks' caches are written."""
    jcfg, cfg, np_params = _setup(arch)
    jopt, opt = _opts()
    batch = {"tokens": _tokens(cfg, (2, 8)), **_frontend(cfg, 2)}
    max_len = 12 + cfg.frontend_tokens
    j_logits, j_state = jax.jit(lambda p, b: JMod.prefill(
        p, jcfg, b, max_len, jopt))(np_params, batch)
    with torch.no_grad():
        logits, state = TMod.prefill(_params(cfg, np_params), cfg,
                                     convert.batch_from_numpy(batch, "cpu"),
                                     max_len, opt)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)
    _assert_trees(jax.device_get(j_state), state, **TOL)
    leaves = [convert.to_numpy(t) for _, _, t in _pairs(
        jax.device_get(j_state), state)]
    writes_kv = ATTN in cfg.blocks() and not cfg.shared_attn_every
    assert any(np.abs(x).max() > 0 for x in leaves) == writes_kv


# --------------------------------------------------------------------------
# serving, training, the ring cache, the launcher
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_batch_paged_matches_reference(arch):
    jcfg, cfg, np_params = _setup(arch)
    prompts = _tokens(cfg, (2, 5), seed=2)
    j_tokens, j_led = j_serve(np_params, jcfg, jnp.asarray(prompts),
                              JServe(max_new_tokens=6),
                              JKVStoreConfig(**STORE),
                              JPaged(window_pages=2, pages_per_seq=8))
    tokens, led = serve_batch_paged(_params(cfg, np_params), cfg,
                                    torch.from_numpy(prompts),
                                    ServeConfig(max_new_tokens=6),
                                    KVStoreConfig(**STORE),
                                    PagedServeConfig(window_pages=2,
                                                     pages_per_seq=8),
                                    device="cpu")
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(j_tokens))
    assert set(led) == set(j_led)
    for k, v in j_led.items():
        np.testing.assert_allclose(led[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert led["requests"] == 2 * 2 * 11


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_no_nan(arch):
    """One step at lr = peak/2 (tests/test_configs_smoke.py's train
    case), through remat "full": finite loss and gradient norm, and
    every parameter leaf that the loss reaches moved."""
    _, cfg, np_params = _setup(arch)
    params = _params(cfg, np_params)
    # the step updates the parameters in place: keep a copy
    before = convert.tree_to_numpy(tree_map(torch.clone, params))
    batch = synthetic_batch(cfg, get_shape("smoke_train"), DataConfig(), 0,
                            device="cpu")
    step = make_train_step(cfg, TMod.ModelOptions(remat="full"),
                           TrainConfig(warmup_steps=2))
    params, _, m = step(params, adamw_init(params), batch, 1)
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    moved = [float(np.abs(a - convert.to_numpy(b)).max())
             for _, a, b in _pairs(before, params)]
    assert max(moved) > 0
    for path, a, b in _pairs(before, params):
        assert np.isfinite(convert.to_numpy(b)).all(), path


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-2.7b"])
def test_window_ring_cache_equals_full(arch):
    """Ring-buffer windowed KV decode (8 rows) == full-cache windowed
    decode over 20 steps (tests/test_equivalence.py's case), and both
    equal the reference's."""
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), window=8)
    cfg = dataclasses.replace(get_config(arch).reduced(), window=8)
    np_params = _setup(arch)[2]
    params = _params(cfg, np_params)
    toks = _tokens(cfg, (2, 20))
    outs = {}
    for ring in (False, True):
        jopt, opt = _opts(window_ring=ring)
        j_state, _ = JMod.init_decode_state(jcfg, 2, 20, jopt)
        state = TMod.init_decode_state(cfg, 2, 20, opt, device="cpu")
        rows = state["runs"][-1]["k"].shape[-3]
        assert rows == (8 if ring else 20)
        j_step = jax.jit(lambda p, s, t, pos, o=jopt: JMod.decode_step(
            p, jcfg, s, t, pos, o))
        ls = []
        for pos in range(20):
            t = toks[:, pos:pos + 1]
            j_logits, j_state = j_step(np_params, j_state, jnp.asarray(t),
                                       jnp.int32(pos))
            logits, state = TMod.decode_step(params, cfg, state,
                                             torch.from_numpy(t), pos, opt)
            np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                                       **TOL, err_msg=f"ring={ring} {pos}")
            ls.append(logits)
        outs[ring] = torch.stack(ls)
    np.testing.assert_allclose(outs[True].numpy(), outs[False].numpy(),
                               atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_each_arch_on_cpu(arch, capsys):
    out = launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "3",
                             "--new-tokens", "2"])
    assert tuple(out.shape) == (2, 5)
    assert f"{arch}-reduced on cpu" in capsys.readouterr().out
