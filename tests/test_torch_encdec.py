"""The port's cross attention, whisper encoder and the two frontend stubs
against the reference, on reduced whisper-base and internvl2-26b in f32.

Parameters come from the reference's `init_model` / `init_attention`
through numpy, inputs (tokens, frontend embeddings, encoder states) from
a numpy seed. Logits, losses, attention outputs and states agree within
rtol = atol = 1e-4; layouts and the zero cross cache exactly."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data.pipeline import make_batch_specs
from repro.models import attention as JA
from repro.models import model as JMod
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import PORT_OPTIONS, ShapeConfig
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.models import attention as TA
from repro_torch.models import model as TMod

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
FRONTEND_ARCHS = ("whisper-base", "internvl2-26b")


def _opts(**kw):
    common = dict(remat="none", flash_threshold=10_000, **kw)
    return JMod.ModelOptions(**common), TMod.ModelOptions(**common)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg = j_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    j_params, _ = JMod.init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jax.device_get(j_params)


def _frontend_rows(cfg):
    return cfg.frontend_tokens if cfg.frontend == "vision_stub" \
        else cfg.encoder_seq


def _batch(cfg, b=2, s=10, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, cfg.vocab_size, (b, s)).astype(np.int32)
    front = (rng.standard_normal((b, _frontend_rows(cfg), cfg.d_model))
             * 0.5).astype(np.float32)
    return {"tokens": toks, "labels": toks,
            "mask": np.ones((b, s), np.float32), "frontend": front}


def _assert_state(j_state, state, **tol):
    flat = jax.tree_util.tree_flatten_with_path(j_state)[0]
    mine = _leaves_like(j_state, state)
    assert len(flat) == len(mine) >= 2
    for (path, a), b in zip(flat, mine):
        np.testing.assert_allclose(b, np.asarray(a), err_msg=str(path),
                                   **tol)


def _leaves_like(j_state, state):
    """The port's state leaves in the reference tree's order."""
    def walk(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in sorted(a):
                yield from walk(a[k], b[k])
        elif isinstance(a, (tuple, list)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                yield from walk(x, y)
        else:
            yield convert.to_numpy(b)
    return list(walk(j_state, state))


# --------------------------------------------------------------------------
# cross attention
# --------------------------------------------------------------------------
def test_cross_init_has_no_qk_norm():
    """A cross-attention block has no q/k norms even where the config
    normalises q and k (qwen3's qk_norm), as in the reference."""
    jcfg = j_get_config("qwen3-8b").reduced()
    cfg = get_config("qwen3-8b").reduced()
    assert cfg.qk_norm
    gen = torch.Generator().manual_seed(0)
    for cross in (False, True):
        jp, _ = JA.init_attention(jax.random.PRNGKey(0), jcfg, cross=cross)
        tp = TA.init_attention(gen, cfg, cross=cross, layers=2)
        assert set(tp) == set(jp)
        assert ("q_norm" in tp) == (not cross)
        for k, a in jp.items():
            assert tuple(tp[k].shape) == (2,) + a.shape, k
    _, cfg_w, np_params = _setup("whisper-base")
    mine = TMod.init_model(cfg_w, gen)
    assert set(mine["runs"][0]) == set(np_params["runs"][0]) == {
        "norm1", "attn", "norm_x", "xattn", "norm2", "ffn"}
    assert "q_norm" not in mine["runs"][0]["xattn"]


@pytest.mark.parametrize("flash_threshold", [10_000, 8])
def test_attention_kv_x_matches_reference(flash_threshold):
    """attention(kv_x=...): no RoPE, no mask, over 16 encoder rows; the
    direct path and (threshold 8) the blockwise path."""
    jcfg, cfg, np_params = _setup("whisper-base")
    p = jax.tree.map(lambda t: t[0], np_params["runs"][0]["xattn"])
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    jy = JA.attention(p, jcfg, jnp.asarray(x), kv_x=jnp.asarray(enc),
                      causal=False, flash_threshold=flash_threshold)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    y = TA.attention(tp, cfg, torch.from_numpy(x),
                     kv_x=torch.from_numpy(enc), causal=False,
                     flash_threshold=flash_threshold)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)


def test_decode_cross_attention_matches_reference():
    jcfg, cfg, np_params = _setup("whisper-base")
    p = jax.tree.map(lambda t: t[0], np_params["runs"][0]["xattn"])
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    kv = {k: rng.standard_normal((2, cfg.encoder_seq, cfg.num_kv_heads,
                                  cfg.resolved_head_dim)).astype(np.float32)
          for k in ("k", "v")}
    jy = JA.decode_cross_attention(p, jcfg, jnp.asarray(x),
                                   {k: jnp.asarray(v) for k, v in kv.items()},
                                   jcfg.encoder_seq)
    y = TA.decode_cross_attention(
        {k: torch.from_numpy(np.array(v)) for k, v in p.items()}, cfg,
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in kv.items()})
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)


# --------------------------------------------------------------------------
# the encoder and the frontends
# --------------------------------------------------------------------------
def test_encode_matches_reference():
    jcfg, cfg, np_params = _setup("whisper-base")
    jopt, opt = _opts()
    front = _batch(cfg)["frontend"]
    jy = JMod._encode(np_params, jcfg, jnp.asarray(front), jopt)
    with torch.no_grad():
        y = TMod._encode(convert.params_from_numpy(np_params, cfg, "cpu"),
                         cfg, torch.from_numpy(front), opt)
    assert tuple(y.shape) == (2, cfg.encoder_seq, cfg.d_model)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_frontend_forward_and_loss_match_reference(arch):
    """Logits over F + S positions with `vision_stub` (S with
    `audio_stub`), the loss over the text positions only; the frontend
    input reaches the text logits."""
    jcfg, cfg, np_params = _setup(arch)
    jopt, opt = _opts()
    batch = _batch(cfg)
    batch["mask"][1, 6:] = 0.0
    j_logits, _ = JMod.forward(np_params, jcfg, batch, jopt)
    j_loss, j_m = JMod.loss_fn(np_params, jcfg, batch, jopt)
    params = convert.params_from_numpy(np_params, cfg, "cpu")
    tb = convert.batch_from_numpy(batch, "cpu")
    with torch.no_grad():
        logits, _ = TMod.forward(params, cfg, tb, opt)
        loss, m = TMod.loss_fn(params, cfg, tb, opt)
        other = dict(tb, frontend=tb["frontend"] * -1.0)
        moved, _ = TMod.forward(params, cfg, other, opt)
    extra = cfg.frontend_tokens if cfg.frontend == "vision_stub" else 0
    assert tuple(logits.shape)[:2] == (2, 10 + extra)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)
    np.testing.assert_allclose(float(loss), float(j_loss), **TOL)
    np.testing.assert_allclose(float(m["xent"]), float(j_m["xent"]), **TOL)
    assert float((moved[:, extra:] - logits[:, extra:]).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_prefill_with_frontend_matches_reference(arch):
    """Logits and state; internvl2's caches hold F + S rows of K/V,
    whisper's cross cache stays zero; a max_len that cannot hold the
    F + S positions raises."""
    jcfg, cfg, np_params = _setup(arch)
    jopt, opt = _opts()
    batch = _batch(cfg, s=6)
    extra = cfg.frontend_tokens if cfg.frontend == "vision_stub" else 0
    max_len = 6 + extra + 4
    pb = {"tokens": batch["tokens"], "frontend": batch["frontend"]}
    j_logits, j_state = JMod.prefill(np_params, jcfg, pb, max_len, jopt)
    params = convert.params_from_numpy(np_params, cfg, "cpu")
    tb = convert.batch_from_numpy(pb, "cpu")
    with torch.no_grad():
        logits, state = TMod.prefill(params, cfg, tb, max_len, opt)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)
    _assert_state(jax.device_get(j_state), state, **TOL)
    run = state["runs"][0]
    assert bool(run["k"][:, :, 6 + extra - 1].abs().max() > 0)
    assert not bool(run["k"][:, :, 6 + extra:].any())
    if cfg.cross_attention:
        assert not run["xk"].any() and not run["xv"].any()
    if extra:
        with pytest.raises(ValueError, match="max_len"):
            TMod.prefill(params, cfg, tb, 6 + extra - 1, opt)


def test_decode_cross_cache_stays_zero_as_in_reference():
    """whisper: a prefill with the audio frames, then 4 decode steps. The
    cross cache is zeros throughout, in both packages, so every decoded
    token attends uniformly over zero values; logits and states agree."""
    jcfg, cfg, np_params = _setup("whisper-base")
    jopt, opt = _opts()
    batch = _batch(cfg, s=6)
    pb = {"tokens": batch["tokens"], "frontend": batch["frontend"]}
    _, j_state = JMod.prefill(np_params, jcfg, pb, 10, jopt)
    params = convert.params_from_numpy(np_params, cfg, "cpu")
    with torch.no_grad():
        _, state = TMod.prefill(params, cfg, convert.batch_from_numpy(
            pb, "cpu"), 10, opt)
    toks = np.random.default_rng(7).integers(
        2, cfg.vocab_size, (2, 4)).astype(np.int32)
    for i in range(4):
        j_logits, j_state = JMod.decode_step(
            np_params, jcfg, j_state, jnp.asarray(toks[:, i:i + 1]),
            jnp.int32(6 + i), jopt)
        logits, state = TMod.decode_step(params, cfg, state,
                                         torch.from_numpy(toks[:, i:i + 1]),
                                         6 + i, opt)
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                                   **TOL, err_msg=f"step {i}")
    j_state = jax.device_get(j_state)
    _assert_state(j_state, state, **TOL)
    for run, j_run in zip(state["runs"], j_state["runs"]):
        for k in ("xk", "xv"):
            assert not np.asarray(j_run[k]).any()
            assert not run[k].any()


# --------------------------------------------------------------------------
# the data pipeline's frontend input
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FRONTEND_ARCHS + ("xlstm-125m",))
def test_pipeline_frontend_shapes(arch):
    """The stubs' `frontend` input at full width, as the reference's
    batch specs give it: f32 N(0, 0.02^2), reproducible from the step."""
    cfg = get_config(arch)
    shape = ShapeConfig("t", 8, 2, "train")
    specs, _ = make_batch_specs(j_get_config(arch), shape)
    batch = synthetic_batch(cfg, shape, DataConfig(), 3, device="cpu")
    assert set(batch) == set(specs)
    for k, spec in specs.items():
        assert tuple(batch[k].shape) == spec.shape, k
    if "frontend" not in batch:
        return
    f = batch["frontend"]
    assert f.dtype == torch.float32
    np.testing.assert_allclose(float(f.std()), 0.02, rtol=0.05)
    again = synthetic_batch(cfg, shape, DataConfig(), 3, device="cpu")
    assert torch.equal(again["frontend"], f)
    assert not torch.equal(synthetic_batch(
        cfg, shape, DataConfig(), 4, device="cpu")["frontend"], f)


def test_reduced_configs_keep_their_frontends():
    for arch in FRONTEND_ARCHS:
        a, b = j_get_config(arch).reduced(), get_config(arch).reduced()
        mine = dataclasses.asdict(b)
        assert {k: mine.pop(k) for k in PORT_OPTIONS} == PORT_OPTIONS
        assert dataclasses.asdict(a) == mine
        assert b.frontend and _frontend_rows(b) > 0
