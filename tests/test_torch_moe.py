"""The port's MoE (dense path) against the reference's, on reduced
olmoe-1b-7b and qwen3-moe-30b-a3b in f32.

Parameters come from the reference's `init_moe` as numpy, inputs from a
numpy seed. Routing weights, the aux loss and the combine agree within
rtol = atol = 1e-5 (f32 sums taken in another order); the chosen experts
are equal, ties included: both pick the lower index first."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import moe as JM
from repro_torch.configs import get_config
from repro_torch.models import moe as TM
from repro_torch.models.layers import silu

torch.set_num_threads(1)

ARCHS = ("olmoe-1b-7b", "qwen3-moe-30b-a3b")
TOL = dict(rtol=1e-5, atol=1e-5)


def _setup(arch, seed=0):
    jcfg = j_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jp, _ = JM.init_moe(jax.random.PRNGKey(seed), jcfg)
    jp = jax.device_get(jp)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = (np.random.default_rng(seed + 1).standard_normal(
        (2, 5, cfg.d_model)) * 0.3).astype(np.float32)
    return jcfg, cfg, jp, tp, x


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch):
    jcfg, cfg, jp, tp, x = _setup(arch)
    jw, ji, jaux = JM._route(jp, jcfg, jnp.asarray(x))
    w, i, aux = TM._route(tp, cfg, torch.from_numpy(x))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    assert w.shape == (2, 5, cfg.experts_per_token)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_ties_take_the_lower_index(arch):
    """A zero router makes every logit equal: the reference picks
    experts 0..k-1 for every token, and so must the port."""
    jcfg, cfg, jp, tp, x = _setup(arch)
    jp = dict(jp, router=np.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    _, ji, jaux = JM._route(jp, jcfg, jnp.asarray(x))
    w, i, aux = TM._route(tp, cfg, torch.from_numpy(x))
    k = cfg.experts_per_token
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(i.numpy()[0, 0], np.arange(k))
    np.testing.assert_allclose(w.numpy(), 1.0 / k, rtol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


def test_top_k_order_matches_lax_top_k():
    """Many-way ties at random places (small integers over 64 experts):
    the same k values and indices, in the same order, as lax.top_k."""
    x = np.random.default_rng(7).integers(0, 4, (50, 64)).astype(np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 8)
    v, i = TM.top_k_lowest_first(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_matches_reference(arch):
    jcfg, cfg, jp, tp, x = _setup(arch)
    jy, jaux = JM.moe_dense(jp, jcfg, jnp.asarray(x))
    y, aux = TM.moe(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


def test_moe_dense_combine_math():
    """The dense combine equals the per-token mixture of the chosen
    experts (tests/test_equivalence.py's MoE case, on the port)."""
    _, cfg, _, tp, x = _setup("olmoe-1b-7b")
    xt = torch.from_numpy(x[:1, :4])
    y, _ = TM.moe_dense(tp, cfg, xt)
    w, idx, _ = TM._route(tp, cfg, xt)
    for t in range(4):
        acc = torch.zeros(cfg.d_model)
        for j in range(cfg.experts_per_token):
            e = int(idx[0, t, j])
            h = silu(xt[0, t] @ tp["w_gate"][e]) * (xt[0, t] @ tp["w_up"][e])
            acc = acc + w[0, t, j] * (h @ tp["w_down"][e])
        np.testing.assert_allclose(y[0, t].numpy(), acc.numpy(), atol=2e-4)


def test_moe_ep_raises_and_names_the_queue():
    """Expert parallelism is ported (tests/test_torch_dist.py); without
    an active mesh with a `model` axis it raises, naming the axis."""
    _, cfg, _, tp, x = _setup("olmoe-1b-7b")
    with pytest.raises(ValueError, match="'model' axis"):
        TM.moe(tp, cfg, torch.from_numpy(x), impl="ep")
