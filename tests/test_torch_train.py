"""The port's training path against the reference's, on reduced
qwen3-1.7b in f32.

Parameters come from the reference's `init_model` through
`convert.params_from_numpy` and batches from its `synthetic_batch`
through numpy, so both packages compute the same function. Tolerances:
loss and xent rtol 1e-5, gradients and multi-step state rtol 1e-4 /
atol 1e-6 (f32 sums taken in another order); the int8 pod sync is exact
on the same gradients; the int8 train step's parameters are held as
`test_int8_pod_step_matches_reference` states.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeConfig as JShape
from repro.data.pipeline import DataConfig as JData
from repro.data.pipeline import synthetic_batch as j_batch
from repro.models import attention as JA
from repro.models.model import ModelOptions as JOpt
from repro.models.model import init_model as j_init_model
from repro.models.model import loss_fn as j_loss_fn
from repro.optim import adamw as JW
from repro.optim.schedule import cosine_schedule as j_cosine
from repro.runtime import train_loop as JT
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.compute_plane import tree_map
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as TA
from repro_torch.models.model import ModelOptions
from repro_torch.optim import adamw as TW
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.runtime import train_loop as TT

torch.set_num_threads(1)

SHAPE = (4, 64)                     # global batch, seq


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = j_get_config("qwen3-1.7b").reduced()
    cfg = get_config("qwen3-1.7b").reduced()
    j_params, _ = j_init_model(jax.random.PRNGKey(0), jcfg)
    np_params = jax.device_get(j_params)
    shape = JShape("t", SHAPE[1], SHAPE[0], "train")
    batches = [jax.device_get(j_batch(jcfg, shape, JData(seed=0), s))
               for s in range(3)]
    return jcfg, cfg, np_params, batches


def _params(cfg, np_params):
    return convert.params_from_numpy(np_params, cfg, "cpu")


def _pairs(a, b, path=""):
    """(path, reference leaf, port leaf) over the reference tree's keys."""
    if isinstance(a, dict):
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _pairs(x, y, f"{path}[{i}]")
    else:
        yield path, np.asarray(a), convert.to_numpy(b)


def _assert_trees(a, b, rtol, atol):
    n = 0
    for path, x, y in _pairs(a, b):
        np.testing.assert_allclose(y, x, rtol=rtol, atol=atol, err_msg=path)
        n += 1
    assert n >= 2


@pytest.mark.parametrize("threshold,triangular,remat", [
    (10_000, True, "none"),          # direct attention
    (16, True, "full"),              # flash, triangular pair list
    (16, False, "dots"),             # flash, every KV block
])
def test_loss_and_grads_match_reference(threshold, triangular, remat):
    jcfg, cfg, np_params, batches = _setup()
    jopt = JOpt(flash_threshold=threshold, triangular_flash=triangular,
                remat="none")
    opt = ModelOptions(flash_threshold=threshold,
                       triangular_flash=triangular, remat=remat)
    batch = batches[0]
    (j_loss, j_m), j_grads = jax.jit(jax.value_and_grad(
        lambda p: j_loss_fn(p, jcfg, batch, jopt), has_aux=True))(np_params)
    lag = TT._loss_and_grad_fn(cfg, opt)
    (loss, m), grads = lag(_params(cfg, np_params),
                           convert.batch_from_numpy(batch, "cpu"))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(float(m["xent"]), float(j_m["xent"]),
                               rtol=1e-5)
    _assert_trees(jax.device_get(j_grads), grads, rtol=1e-4, atol=1e-6)
    ev = TT.make_eval_step(cfg, opt)(_params(cfg, np_params),
                                     convert.batch_from_numpy(batch, "cpu"))
    np.testing.assert_allclose(float(ev["loss"]), float(j_loss), rtol=1e-5)


@pytest.mark.parametrize("triangular,window", [(True, 0), (True, 24),
                                               (False, 0)])
def test_flash_attention_blocks_match_reference(triangular, window):
    """Several q and kv blocks (kv_block=16 over 48 positions): values
    and input gradients of the blockwise path."""
    rng = np.random.default_rng(3)
    q, k, v, ct = (rng.standard_normal((2, 48, 4, 16)).astype(np.float32)
                   for _ in range(4))
    pos = np.arange(48)

    def jf(q, k, v):
        return JA._flash_attention(q, k, v, jnp.asarray(pos),
                                   jnp.asarray(pos), True, window,
                                   kv_block=16, triangular=triangular)

    j_out, vjp = jax.vjp(jf, q, k, v)
    j_g = vjp(jnp.asarray(ct))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = TA._flash_attention(tq, tk, tv, torch.from_numpy(pos),
                              torch.from_numpy(pos), True, window,
                              kv_block=16, triangular=triangular)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               rtol=1e-5, atol=1e-6)
    g = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(ct))
    for a, b in zip(g, j_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    direct = TA._direct_attention(tq, tk, tv, torch.from_numpy(pos),
                                  torch.from_numpy(pos), True, window)
    np.testing.assert_allclose(out.detach().numpy(),
                               direct.detach().numpy(), rtol=1e-5,
                               atol=1e-6)


def test_compressed_pod_sync_matches_reference_exactly():
    jcfg, cfg, np_params, _ = _setup()
    rng = np.random.default_rng(5)
    stack = jax.tree.map(
        lambda p: (rng.standard_normal((2,) + p.shape).astype(np.float32)
                   * np.float32(10.0 ** rng.integers(-5, 1))), np_params)
    want = JT._compressed_pod_sync(stack, 2, 256)     # op by op, not jit
    got = TT._compressed_pod_sync(
        tree_map(torch.from_numpy, stack), 2, 256)
    for path, a, b in _pairs(jax.device_get(want), got):
        np.testing.assert_array_equal(b, a, err_msg=path)


def _tcfg(J, **kw):
    return J.TrainConfig(adamw=(JW if J is JT else TW).AdamWConfig(lr=3e-3),
                         total_steps=8, **kw)


def _run_both(steps, **kw):
    """`steps` train steps through both packages from the same params,
    optimizer state and batches."""
    jcfg, cfg, np_params, batches = _setup()
    j_step = jax.jit(JT.make_train_step(jcfg, JOpt(remat="none"),
                                        _tcfg(JT, **kw)))
    jp, jo = np_params, JW.adamw_init(np_params)
    t_step = TT.make_train_step(cfg, ModelOptions(remat="none"),
                                _tcfg(TT, **kw))
    tp = _params(cfg, np_params)
    to = convert.opt_state_from_numpy(jax.device_get(jo), "cpu")
    for s in range(steps):
        jp, jo, jm = j_step(jp, jo, batches[s], jnp.int32(s))
        tp, to, tm = t_step(tp, to, convert.batch_from_numpy(batches[s],
                                                             "cpu"), s)
    return (jax.device_get(jp), jax.device_get(jo), jax.device_get(jm),
            tp, to, tm)


def test_train_step_none_matches_reference():
    jp, jo, jm, tp, to, tm = _run_both(3, warmup_steps=1)
    for k in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    _assert_trees(jp, tp, rtol=1e-4, atol=1e-6)
    _assert_trees(jo["mu"], to["mu"], rtol=1e-4, atol=1e-6)
    _assert_trees(jo["nu"], to["nu"], rtol=1e-4, atol=1e-6)
    o = convert.opt_state_to_numpy(to)
    assert o["count"].dtype == np.int32
    assert int(o["count"]) == int(jo["count"]) == 3


def test_int8_pod_step_matches_reference():
    """One step of dp_compress="int8" over 2 pods. Loss rtol 1e-5,
    grad_norm rtol 1e-4. Parameters: within atol 1e-5 on >= 99.9 % of
    elements and none further than 2*lr. The reason: per-pod gradients
    that differ only by f32 summation order (and the reference's jitted
    amax/127, a reciprocal multiply) can put an element on the other
    side of a rounding boundary, so its q differs by one step; Adam's
    first step moves a parameter by about +-lr per element, so such an
    element can land up to lr away."""
    jp, jo, jm, tp, to, tm = _run_both(1, warmup_steps=0,
                                       dp_compress="int8", num_pods=2)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    lr = 3e-3
    close = total = 0
    for path, a, b in _pairs(jp, tp):
        d = np.abs(a - b)
        assert d.max() <= 2 * lr, path
        close += int((d <= 1e-5).sum())
        total += d.size
    assert close >= 0.999 * total, (close, total)


def test_adamw_clip_and_schedule_match_reference():
    rng = np.random.default_rng(9)
    params = {"a": rng.standard_normal((3, 5)).astype(np.float32),
              "b": {"c": rng.standard_normal((7,)).astype(np.float32)}}
    grads = jax.tree.map(lambda p: 3 * rng.standard_normal(p.shape).astype(
        np.float32), params)
    cfg_j, cfg_t = JW.AdamWConfig(), TW.AdamWConfig()
    jc, jn = JW.clip_by_global_norm(grads, 1.0)
    tc, tn = TW.clip_by_global_norm(tree_map(torch.from_numpy, grads), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _assert_trees(jc, tc, rtol=1e-6, atol=0)
    jp, jo = params, JW.adamw_init(params)
    tp = tree_map(lambda a: torch.from_numpy(a.copy()), params)
    to = TW.adamw_init(tp)
    for i in range(3):
        lr = j_cosine(jnp.int32(i), peak_lr=1e-2, warmup_steps=1,
                      total_steps=4)
        tlr = cosine_schedule(i, peak_lr=1e-2, warmup_steps=1,
                              total_steps=4)
        np.testing.assert_allclose(float(tlr), float(lr), rtol=1e-6)
        jp, jo, jm = JW.adamw_update(grads, jo, jp, cfg_j, lr=lr)
        tp, to, tm = TW.adamw_update(tree_map(torch.from_numpy, grads), to,
                                     tp, cfg_t, lr=tlr)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    _assert_trees(jp, tp, rtol=1e-5, atol=1e-7)
    _assert_trees(jo["mu"], to["mu"], rtol=1e-5, atol=1e-7)
    _assert_trees(jo["nu"], to["nu"], rtol=1e-5, atol=1e-7)
    for s in (0, 1, 5, 50, 99, 100, 150):
        np.testing.assert_allclose(
            float(cosine_schedule(s, peak_lr=3e-4, warmup_steps=10,
                                  total_steps=100)),
            float(j_cosine(jnp.int32(s), peak_lr=3e-4, warmup_steps=10,
                           total_steps=100)), rtol=1e-6)


def test_synthetic_batch_deterministic_in_range_with_bos():
    cfg = get_config("qwen3-1.7b").reduced()
    shape = ShapeConfig("t", 64, 6, "train")
    dcfg = DataConfig(seed=3, doc_len=16)
    a = synthetic_batch(cfg, shape, dcfg, 7, device="cpu")
    b = synthetic_batch(cfg, shape, dcfg, 7, device="cpu")
    c = synthetic_batch(cfg, shape, dcfg, 8, device="cpu")
    for k in ("tokens", "labels", "mask"):
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["tokens"], c["tokens"])
    tok = a["tokens"]
    assert tok.dtype == torch.int32 and tok.shape == (6, 64)
    assert int(tok.min()) >= 0 and int(tok.max()) < cfg.vocab_size
    assert torch.equal(a["labels"], tok) and bool((a["mask"] == 1).all())
    for row in tok:                       # BOS every doc_len positions
        assert any(bool((row[r::16] == 1).all()) for r in range(16))
    counts = torch.bincount(tok.reshape(-1).long(), minlength=256)
    assert counts[0] > counts[100]        # Zipf: rank 1 beats rank 101


def test_launcher_runs_on_cpu(capsys, tmp_path):
    m = launch_train.main(["--reduced", "--device", "cpu", "--steps", "3"])
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))
    assert "[train] done" in capsys.readouterr().out
    launch_train.main(["--reduced", "--device", "cpu", "--steps", "3",
                       "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2",
                                                          "step_3"]
