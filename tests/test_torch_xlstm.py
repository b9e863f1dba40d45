"""The port's xLSTM blocks against the reference's, on reduced
xlstm-125m in f32, and the per-layer parameter draw.

Parameters come from the reference's `init_mlstm` / `init_slstm` as
numpy, inputs from a numpy seed. The cell, the chunkwise and sequential
forwards, the decodes and the gradients agree with the reference within
rtol = atol = 1e-4 (f32 sums taken in another order); the port's own
chunked output equals its recurrent output within the reference's atol
2e-4 (tests/test_equivalence.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import xlstm as JX
from repro_torch.configs import get_config
from repro_torch.models import layers as TL
from repro_torch.models import xlstm as TX

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
BLOCKS = {"mlstm": (JX.init_mlstm, JX.mlstm, JX.mlstm_decode,
                    JX.init_mlstm_state, TX.mlstm, TX.mlstm_decode,
                    TX.init_mlstm_state),
          "slstm": (JX.init_slstm, JX.slstm, JX.slstm_decode,
                    JX.init_slstm_state, TX.slstm, TX.slstm_decode,
                    TX.init_slstm_state)}


def _setup(block, seed=0, seq=48):
    jcfg = j_get_config("xlstm-125m").reduced()
    cfg = get_config("xlstm-125m").reduced()
    jp, _ = BLOCKS[block][0](jax.random.PRNGKey(seed), jcfg)
    jp = jax.device_get(jp)
    rng = np.random.default_rng(seed + 1)
    # the reference draws the gate biases as constants: give them values
    # so the heads' gates differ
    for k in ("bi", "bf", "b_i", "b_f"):
        if k in jp:
            jp[k] = jp[k] + rng.standard_normal(jp[k].shape).astype(
                np.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = (rng.standard_normal((2, seq, cfg.d_model)) * 0.5).astype(
        np.float32)
    return jcfg, cfg, jp, tp, x


def _port_recurrent(decode, init_state, tp, cfg, x):
    st = init_state(cfg, x.shape[0])
    ys = []
    for t in range(x.shape[1]):
        y, st = decode(tp, cfg, x[:, t:t + 1], st)
        ys.append(y)
    return torch.cat(ys, dim=1), st


def test_log_sigmoid_matches_jax():
    x = np.concatenate([np.linspace(-120, 120, 2001),
                        [0.0, 1e-8, -1e-8, 30.0, -30.0]]).astype(np.float32)
    want = np.asarray(jax.nn.log_sigmoid(jnp.asarray(x)))
    got = TX.log_sigmoid(torch.from_numpy(x)).numpy()
    # XLA:CPU flushes subnormal results to zero; torch keeps them, so
    # the two may differ below the smallest normal f32
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=np.finfo(np.float32).tiny)


def test_mlstm_cell_matches_reference():
    """One step from a nonzero state, stabiliser both above and below
    the gates."""
    cfg = get_config("xlstm-125m").reduced()
    _, nh, hd = TX._mlstm_dims(cfg)
    rng = np.random.default_rng(3)

    def r(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    state = {"C": r(2, nh, hd, hd), "n": r(2, nh, hd),
             "m": r(2, nh, s=3.0)}
    args = (r(2, nh, hd), r(2, nh, hd), r(2, nh, hd), r(2, nh, s=3.0),
            r(2, nh, s=3.0))
    jst, jh = JX._mlstm_cell({k: jnp.asarray(v) for k, v in state.items()},
                             *map(jnp.asarray, args))
    tst, th = TX._mlstm_cell({k: torch.from_numpy(v)
                              for k, v in state.items()},
                             *map(torch.from_numpy, args))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    for k in state:
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                   **TOL, err_msg=k)


@pytest.mark.parametrize("chunk", [12, 256])
def test_mlstm_chunkwise_forward_matches_reference(chunk):
    """chunk 12: four chunks with the carried state; 256: one chunk."""
    jcfg, cfg, jp, tp, x = _setup("mlstm")
    jy = JX.mlstm(jp, jcfg, jnp.asarray(x), chunk=chunk)
    y = TX.mlstm(tp, cfg, torch.from_numpy(x), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)


def test_slstm_forward_matches_reference():
    jcfg, cfg, jp, tp, x = _setup("slstm")
    jy = JX.slstm(jp, jcfg, jnp.asarray(x), chunk=12)
    with torch.no_grad():
        y = TX.slstm(tp, cfg, torch.from_numpy(x), chunk=12)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_decode_matches_reference(block):
    """The recurrent decode over 48 tokens: outputs and final state."""
    _, _, jdec, jinit, _, tdec, tinit = BLOCKS[block]
    jcfg, cfg, jp, tp, x = _setup(block)
    jst, _ = jinit(jcfg, 2)
    step = jax.jit(lambda p, xx, s: jdec(p, jcfg, xx, s))
    jys = []
    for t in range(x.shape[1]):
        jy, jst = step(jp, jnp.asarray(x[:, t:t + 1]), jst)
        jys.append(np.asarray(jy))
    ys, st = _port_recurrent(tdec, tinit, tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(ys.numpy(), np.concatenate(jys, axis=1),
                               **TOL)
    assert set(st) == set(jst)
    for k in st:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                   **TOL, err_msg=k)


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_chunked_equals_recurrent(block):
    """The port's chunked forward equals its own per-token decode
    (tests/test_equivalence.py's cases, held on the port)."""
    _, _, _, _, tfwd, tdec, tinit = BLOCKS[block]
    _, cfg, _, tp, x = _setup(block, seed=2)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        y1 = tfwd(tp, cfg, xt, chunk=12)
        y2, _ = _port_recurrent(tdec, tinit, tp, cfg, xt)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=2e-4)


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_grads_match_reference_and_are_finite(block):
    """Input and parameter gradients: the chunkwise mLSTM (the -1e30 mask
    before exp keeps the dead triangle's gradient finite) and the
    sLSTM's chunk-checkpointed loop."""
    _, jfwd, _, _, tfwd, _, _ = BLOCKS[block]
    jcfg, cfg, jp, tp, x = _setup(block, seq=24)
    ct = np.random.default_rng(9).standard_normal(x.shape).astype(
        np.float32)

    def jf(p, xx):
        return jnp.sum(jfwd(p, jcfg, xx, chunk=8) * ct)

    jg_p, jg_x = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    (tfwd(tp, cfg, xt, chunk=8) * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg_x), **TOL)
    for k, v in tp.items():
        assert torch.isfinite(v.grad).all(), k
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(jg_p[k]),
                                   rtol=1e-4, atol=2e-4, err_msg=k)


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_init_layout_matches_reference(block):
    """The port's own init gives the reference's keys and shapes, the
    constant leaves (the forget biases of 1 included) equal, stacked
    (L,) with `layers`; matrices in the storage dtype, the recurrent
    weights, biases and norms in f32."""
    jinit = BLOCKS[block][0]
    tinit = {"mlstm": TX.init_mlstm, "slstm": TX.init_slstm}[block]
    jcfg = j_get_config("xlstm-125m").reduced()
    cfg = get_config("xlstm-125m").reduced()
    jp = jax.device_get(jinit(jax.random.PRNGKey(0), jcfg)[0])
    mine = tinit(torch.Generator().manual_seed(0), cfg, layers=3,
                 dtype=torch.bfloat16)
    assert set(mine) == set(jp)
    for k, a in jp.items():
        assert tuple(mine[k].shape) == (3,) + a.shape, k
        f32 = k.startswith(("b", "r_")) or k in ("norm", "ffn_norm")
        assert mine[k].dtype == (torch.float32 if f32 else torch.bfloat16), k
        if np.all(a == a.flat[0]) and a.flat[0] in (0.0, 1.0):
            assert (mine[k] == float(a.flat[0])).all(), k


def test_state_layout_matches_reference():
    jcfg = j_get_config("xlstm-125m").reduced()
    cfg = get_config("xlstm-125m").reduced()
    for jinit, tinit in ((JX.init_mlstm_state, TX.init_mlstm_state),
                         (JX.init_slstm_state, TX.init_slstm_state)):
        js, _ = jinit(jcfg, 3)
        ts = tinit(cfg, 3, layers=(2,))
        assert set(ts) == set(js)
        for k, a in js.items():
            assert tuple(ts[k].shape) == (2,) + a.shape, k
            assert ts[k].dtype == torch.float32 and not ts[k].any(), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_normal_draws_layer_by_layer(dtype):
    """`layers.normal`: the stacked leaf in the storage dtype, each layer
    its own draw at the per-layer scale (1/sqrt(shape[0]) or `scale`);
    an unstacked leaf the same without the (L,) axis."""
    gen = torch.Generator().manual_seed(0)
    w = TL.normal(gen, (512, 96), layers=4, dtype=dtype)
    assert tuple(w.shape) == (4, 512, 96) and w.dtype == dtype
    std = w.float().std(dim=(1, 2))
    np.testing.assert_allclose(std.numpy(), 1 / np.sqrt(512), rtol=0.03)
    assert all(not torch.equal(w[0], w[i]) for i in range(1, 4))
    w = TL.normal(gen, (256, 64), scale=0.02, dtype=dtype)
    assert tuple(w.shape) == (256, 64) and w.dtype == dtype
    np.testing.assert_allclose(float(w.float().std()), 0.02, rtol=0.03)
    o = TL.ones((5,), layers=2)
    assert tuple(o.shape) == (2, 5) and o.dtype == torch.float32
    assert (o == 1).all()
