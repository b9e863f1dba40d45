"""The port's Mamba2 block against the reference's, on reduced
zamba2-2.7b in f32.

Parameters come from the reference's `init_mamba2` as numpy, inputs from
a numpy seed. The chunked forward and the recurrent decode agree with the
reference within rtol = atol = 1e-4 (f32 sums taken in another order);
the port's own chunked output equals its recurrent output within the
reference's atol 2e-4 (tests/test_equivalence.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import ssm as JS
from repro_torch.configs import get_config
from repro_torch.models import ssm as TS
from repro_torch.models.layers import dot, silu

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def _setup(seed=0, seq=48):
    jcfg = j_get_config("zamba2-2.7b").reduced()
    cfg = get_config("zamba2-2.7b").reduced()
    jp, _ = JS.init_mamba2(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed + 1)
    # the reference draws A_log and dt_bias as zeros: give them values so
    # the per-head decays differ
    jp = dict(jax.device_get(jp),
              A_log=rng.standard_normal(jp["A_log"].shape).astype(
                  np.float32) * 0.5,
              dt_bias=rng.standard_normal(jp["dt_bias"].shape).astype(
                  np.float32))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = (rng.standard_normal((2, seq, cfg.d_model)) * 0.5).astype(
        np.float32)
    return jcfg, cfg, jp, tp, x


def _port_recurrent(tp, cfg, x):
    st = TS.init_mamba2_state(cfg, x.shape[0])
    ys = []
    for t in range(x.shape[1]):
        y, st = TS.mamba2_decode(tp, cfg, x[:, t:t + 1], st)
        ys.append(y)
    return torch.cat(ys, dim=1), st


@pytest.mark.parametrize("chunk", [12, 256])
def test_mamba2_forward_matches_reference(chunk):
    jcfg, cfg, jp, tp, x = _setup()
    jy = JS.mamba2(jp, jcfg, jnp.asarray(x), chunk=chunk)
    y = TS.mamba2(tp, cfg, torch.from_numpy(x), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)


def test_mamba2_grads_match_reference_and_are_finite():
    """Input and parameter gradients of the chunked form: the -1e30 mask
    before exp keeps the dead triangle's gradient finite."""
    jcfg, cfg, jp, tp, x = _setup(seq=24)
    ct = np.random.default_rng(9).standard_normal(x.shape).astype(
        np.float32)

    def jf(p, xx):
        return jnp.sum(JS.mamba2(p, jcfg, xx, chunk=8) * ct)

    jg_p, jg_x = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    (TS.mamba2(tp, cfg, xt, chunk=8) * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg_x), **TOL)
    for k, v in tp.items():
        assert torch.isfinite(v.grad).all(), k
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(jg_p[k]),
                                   rtol=1e-4, atol=2e-4, err_msg=k)


def test_mamba2_decode_matches_reference_over_8_steps():
    jcfg, cfg, jp, tp, x = _setup(seq=8)
    jst, _ = JS.init_mamba2_state(jcfg, 2)
    st = TS.init_mamba2_state(cfg, 2)
    step = jax.jit(lambda p, xx, s: JS.mamba2_decode(p, jcfg, xx, s))
    for t in range(8):
        jy, jst = step(jp, jnp.asarray(x[:, t:t + 1]), jst)
        y, st = TS.mamba2_decode(tp, cfg, torch.from_numpy(x[:, t:t + 1]),
                                 st)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL,
                                   err_msg=f"step {t}")
        for k in ("ssm", "conv"):
            np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                       **TOL, err_msg=f"{k} step {t}")


def test_mamba2_chunked_equals_recurrent():
    _, cfg, _, tp, x = _setup()
    y1 = TS.mamba2(tp, cfg, torch.from_numpy(x), chunk=12)
    y2, _ = _port_recurrent(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=2e-4)


def test_ssd_final_state_equals_recurrent_state():
    """The chunked scan's carried state after the last chunk is the
    recurrent decode's ssm state after the last token."""
    _, cfg, _, tp, x = _setup(seq=24)
    xt = torch.from_numpy(x)
    d_in, h, p, n = TS._dims(cfg)
    dt = TS.softplus(dot(xt, tp["wdt"], "bsd,dh->bsh") + tp["dt_bias"])
    xr = silu(TS._causal_depthwise_conv(
        dot(xt, tp["wx"], "bsd,de->bse"), tp["conv_x"]))
    br = silu(TS._causal_depthwise_conv(
        dot(xt, tp["wB"], "bsd,dn->bsn"), tp["conv_B"]))
    cr = silu(TS._causal_depthwise_conv(
        dot(xt, tp["wC"], "bsd,dn->bsn"), tp["conv_C"]))
    _, h_last = TS._ssd_chunked(xr.reshape(2, 24, h, p), dt,
                                -torch.exp(tp["A_log"]), br, cr, 8)
    _, st = _port_recurrent(tp, cfg, xt)
    np.testing.assert_allclose(h_last.numpy(), st["ssm"].numpy(),
                               atol=2e-4)


def test_causal_conv_softplus_and_chunk_match_reference():
    rng = np.random.default_rng(3)
    u = rng.standard_normal((2, 11, 6)).astype(np.float32)
    k = rng.standard_normal((4, 6)).astype(np.float32)
    np.testing.assert_allclose(
        TS._causal_depthwise_conv(torch.from_numpy(u),
                                  torch.from_numpy(k)).numpy(),
        np.asarray(JS._causal_depthwise_conv(jnp.asarray(u),
                                             jnp.asarray(k))),
        rtol=1e-6, atol=1e-6)
    z = np.array([-100.0, -30.0, -1.0, 0.0, 0.5, 19.0, 21.0, 40.0, 90.0],
                 np.float32)
    # XLA:CPU flushes subnormal results to zero; torch keeps them, so
    # the two may differ below the smallest normal f32
    np.testing.assert_allclose(TS.softplus(torch.from_numpy(z)).numpy(),
                               np.asarray(jax.nn.softplus(z)), rtol=1e-7,
                               atol=np.finfo(np.float32).tiny)
    for s in (1, 7, 48, 256, 300, 1024):
        for target in (12, 256):
            assert TS._pick_chunk(s, target) == JS._pick_chunk(s, target)


def test_state_shapes_match_reference():
    jcfg = j_get_config("zamba2-2.7b").reduced()
    cfg = get_config("zamba2-2.7b").reduced()
    jst, _ = JS.init_mamba2_state(jcfg, 3)
    st = TS.init_mamba2_state(cfg, 3)
    for k in ("ssm", "conv"):
        assert tuple(st[k].shape) == jst[k].shape
        assert str(st[k].dtype).split(".")[-1] == str(jst[k].dtype)
