"""The port's training across ranks on gloo: the int8 pod all-gather,
GPipe's `pipeline_forward` (forward and backward) and the
expert-parallel MoE, each in spawned
ranks on the CPU, against the one-process port and the reference.

Ranks rendezvous through a file in `tmp_path` and run one torch thread
each; every join has a timeout, so a hang fails the test. Inputs come
from numpy seeds (the reference's `init_model` / `init_moe` for the
parameters), so both packages compute the same function. Tolerances:
the pod sync is bit-equal (the same int8 payload on every rank, summed
in pod order); GPipe against sequential composition atol 1e-5 (the
reference's oracle, `tests/_distributed_checks.py:85-101`), against the
reference at S = 1 rtol = atol = 1e-6 (f32 products in another order),
outputs and gradients alike;
`moe_ep` against `moe_dense` within the reference's own tolerances
(`_distributed_checks.py:28-55`), and at m = 1 against the reference's
`moe_ep` within rtol = atol = 1e-5, as the port's dense MoE is held.
"""
import multiprocessing as mp
import pickle

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.launch.mesh import (build_mesh, init_distributed,
                                     shutdown_distributed)
from repro_torch.models import moe as TM
from repro_torch.models.model import ModelOptions, init_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime.mesh_rules import use_mesh
from repro_torch.runtime.pipeline import pipeline_forward
from repro_torch.runtime.train_loop import TrainConfig, make_train_step

torch.set_num_threads(1)

JOIN_S = 120


def _entry(fn, rank, world, init, out_dir, args):
    torch.set_num_threads(1)
    init_distributed("cpu", init, rank, world)
    try:
        out = fn(rank, world, *args)
    finally:
        shutdown_distributed()
    with open(f"{out_dir}/out{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def spawn(fn, world, tmp_path, *args):
    """fn(rank, world, *args) in `world` spawned gloo ranks -> the list
    of their results, in rank order."""
    ctx = mp.get_context("spawn")
    init = f"file://{tmp_path}/rendezvous"
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, world, init, str(tmp_path), args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(5)
    assert not hung, f"{len(hung)} rank(s) hung"
    assert [p.exitcode for p in procs] == [0] * world
    out = []
    for r in range(world):
        with open(tmp_path / f"out{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# ------------------------------------------------------------ pod sync
TRAIN_SHAPE = ShapeConfig("t", 32, 4, "train")


def _train_setup(pods):
    cfg = get_config("qwen3-1.7b").reduced()
    opt = ModelOptions(remat="none")
    tcfg = TrainConfig(adamw=AdamWConfig(lr=3e-3), warmup_steps=0,
                       total_steps=10, dp_compress="int8", num_pods=pods)
    params = init_model(cfg, torch.Generator().manual_seed(0))
    batch = synthetic_batch(cfg, TRAIN_SHAPE, DataConfig(seed=0), 0,
                            device="cpu")
    return cfg, opt, tcfg, params, batch


def _train_step(pods, mesh=None):
    """One int8 step; its params, moments and loss as numpy."""
    cfg, opt, tcfg, params, batch = _train_setup(pods)
    step = make_train_step(cfg, opt, tcfg)
    if mesh is None:
        params, st, m = step(params, adamw_init(params), batch, 0)
    else:
        with use_mesh(mesh):
            params, st, m = step(params, adamw_init(params), batch, 0)
    return {"params": convert.tree_to_numpy(params),
            "mu": convert.tree_to_numpy(st["mu"]),
            "nu": convert.tree_to_numpy(st["nu"]),
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}


def _pod_rank(rank, world, pods):
    return _train_step(pods, build_mesh((world,), ("pod",)))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("world,pods", [(1, 2), (2, 2), (2, 4)])
def test_pod_sync_over_ranks_is_bit_equal_to_one_process(tmp_path, world,
                                                         pods):
    """G ranks of a `pod` axis, each computing its pods, gathering int8
    payloads and scales: every rank's update is bit-equal to the one
    process computing every pod."""
    want = _train_step(pods)
    got = spawn(_pod_rank, world, tmp_path, pods)
    for out in got:
        assert out["loss"] == want["loss"]
        assert out["grad_norm"] == want["grad_norm"]
        for part in ("params", "mu", "nu"):
            a, b = _leaves(out[part]), _leaves(want[part])
            assert len(a) == len(b) > 10
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------ pipeline
S, M, MB, D = 4, 6, 2, 16


def _pipe_inputs():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((M, MB, D)).astype(np.float32)
    return w, x


def _stage_fn(wi, xi):
    return torch.tanh(xi @ wi)


def _pipe_rank(rank, world, w, x):
    mesh = build_mesh((world,), ("stage",))
    out = pipeline_forward(mesh, _stage_fn, torch.from_numpy(w[rank]),
                           torch.from_numpy(x))
    return out.numpy()


def test_pipeline_forward_four_stages_matches_sequential(tmp_path):
    w, x = _pipe_inputs()
    ref = torch.from_numpy(x)
    for i in range(S):
        ref = torch.tanh(ref @ torch.from_numpy(w[i]))
    for out in spawn(_pipe_rank, S, tmp_path, w, x):
        np.testing.assert_allclose(out, ref.numpy(), atol=1e-5)


def test_pipeline_forward_one_stage_matches_reference(tmp_path):
    import jax
    import jax.numpy as jnp
    from repro.runtime.pipeline import pipeline_forward as j_pipeline
    w, x = _pipe_inputs()
    mesh = jax.make_mesh((1,), ("stage",), devices=jax.devices()[:1])
    want = np.asarray(j_pipeline(mesh, lambda wi, xi: jnp.tanh(xi @ wi),
                                 jnp.asarray(w[:1]), jnp.asarray(x)))
    (got,) = spawn(_pipe_rank, 1, tmp_path, w[:1], x)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _pipe_cotangent():
    return np.random.default_rng(1).standard_normal((M, MB, D)).astype(
        np.float32)


def _pipe_loss(out, ct):
    """The loss every rank computes from the replicated outputs."""
    return (out * torch.from_numpy(ct)).sum()


def _pipe_grad_rank(rank, world, w, x, ct):
    """pipeline_forward + backward: this stage's weight gradient and the
    input's gradient (None where the input got none)."""
    mesh = build_mesh((world,), ("stage",))
    wi = torch.from_numpy(w[rank]).requires_grad_(True)
    xm = torch.from_numpy(x).requires_grad_(True)
    out = pipeline_forward(mesh, _stage_fn, wi, xm)
    _pipe_loss(out, ct).backward()
    return (out.detach().numpy(), wi.grad.numpy(),
            None if xm.grad is None else xm.grad.numpy())


def test_pipeline_backward_four_stages_matches_sequential(tmp_path):
    """Each stage's weight gradient and stage 0's input gradient equal
    the sequential composition's: the loss is computed identically on
    every rank, and the gradients are those of one loss, not S times it.
    The other stages' input gets no gradient."""
    w, x = _pipe_inputs()
    ct = _pipe_cotangent()
    ws = [torch.from_numpy(w[i]).requires_grad_(True) for i in range(S)]
    xs = torch.from_numpy(x).requires_grad_(True)
    ref = xs
    for wi in ws:
        ref = _stage_fn(wi, ref)
    _pipe_loss(ref, ct).backward()
    got = spawn(_pipe_grad_rank, S, tmp_path, w, x, ct)
    for rank, (out, gw, gx) in enumerate(got):
        np.testing.assert_allclose(out, ref.detach().numpy(), atol=1e-5)
        np.testing.assert_allclose(gw, ws[rank].grad.numpy(), atol=1e-5)
        if rank == 0:
            np.testing.assert_allclose(gx, xs.grad.numpy(), atol=1e-5)
        else:
            assert gx is None or not gx.any()


def test_pipeline_backward_one_stage_matches_reference(tmp_path):
    import jax
    import jax.numpy as jnp
    from repro.runtime.pipeline import pipeline_forward as j_pipeline
    w, x = _pipe_inputs()
    ct = _pipe_cotangent()
    mesh = jax.make_mesh((1,), ("stage",), devices=jax.devices()[:1])

    def loss(wj, xj):
        out = j_pipeline(mesh, lambda wi, xi: jnp.tanh(xi @ wi), wj, xj)
        return (out * jnp.asarray(ct)).sum()

    gw, gx = jax.grad(loss, argnums=(0, 1))(jnp.asarray(w[:1]),
                                             jnp.asarray(x))
    ((_, got_w, got_x),) = spawn(_pipe_grad_rank, 1, tmp_path, w[:1], x, ct)
    np.testing.assert_allclose(got_w, np.asarray(gw)[0], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got_x, np.asarray(gx), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- moe_ep
MOE_KEYS = ("w_gate", "w_up", "w_down", "router")


def _moe_inputs(tokens=(2, 16), skew=0.0):
    """The reference's reduced olmoe MoE weights and x ~ 0.3 N(0, 1),
    plus `skew` times one direction shared by every token (which crowds
    the router's choices onto a few experts)."""
    import jax
    from repro.configs import get_config as j_get_config
    from repro.models import moe as JM
    jcfg = j_get_config("olmoe-1b-7b").reduced()          # 8 experts top-2
    jp = jax.device_get(JM.init_moe(jax.random.PRNGKey(0), jcfg)[0])
    rng = np.random.default_rng(1)
    x = rng.standard_normal(tokens + (jcfg.d_model,)) * 0.3
    x = (x + skew * rng.standard_normal(jcfg.d_model)).astype(np.float32)
    return {k: np.array(v) for k, v in jp.items()}, x


def _moe_fwd_bwd(fn, params, x):
    p = {k: torch.from_numpy(v).requires_grad_(True)
         for k, v in params.items()}
    y, aux = fn(p, torch.from_numpy(x))
    (y ** 2).mean().backward()
    return {"y": y.detach().numpy(), "aux": float(aux.detach()),
            **{k: p[k].grad.numpy() for k in MOE_KEYS}}


def _moe_rank(rank, world, shape, shards, params, x):
    cfg = get_config("olmoe-1b-7b").reduced()
    mesh = build_mesh(shape, ("data", "model"))
    m = shape[1]
    if shards:                       # this rank's E / m experts only
        i = mesh.get_local_rank("model")
        e = cfg.num_experts // m
        params = {k: (v[i * e:(i + 1) * e] if k != "router" else v)
                  for k, v in params.items()}
    with use_mesh(mesh):
        return _moe_fwd_bwd(lambda p, xx: TM.moe(p, cfg, xx, impl="ep"),
                            params, x)


@pytest.mark.parametrize("shape,shards", [((1, 2), True), ((2, 2), False)])
def test_moe_ep_over_ranks_matches_dense(tmp_path, shape, shards):
    """m = 2 experts ranks (and 2 data ranks): outputs, the aux loss and
    every gradient as the dense oracle's. With shards each rank holds
    only its E / m experts and gets their gradients."""
    cfg = get_config("olmoe-1b-7b").reduced()
    params, x = _moe_inputs()
    want = _moe_fwd_bwd(lambda p, xx: TM.moe_dense(p, cfg, xx), params, x)
    world = shape[0] * shape[1]
    e = cfg.num_experts // shape[1]
    for rank, got in enumerate(spawn(_moe_rank, world, tmp_path, shape,
                                     shards, params, x)):
        np.testing.assert_allclose(got["y"], want["y"], atol=3e-4,
                                   rtol=1e-3)
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-4)
        i = rank % shape[1]
        for k in MOE_KEYS:
            ref = want[k]
            if shards and k != "router":
                ref = ref[i * e:(i + 1) * e]
            np.testing.assert_allclose(got[k], ref, atol=5e-4, rtol=5e-3,
                                       err_msg=k)


def test_moe_ep_one_rank_matches_reference_moe_ep(tmp_path):
    """At m = 1 the per-expert capacity drops slots that the dense path
    keeps, in both packages: the port's `moe_ep` is held to the
    reference's, forward and gradients, and is not the dense one."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.models import moe as JM
    from repro.runtime.mesh_rules import use_mesh as j_use_mesh
    jcfg = j_get_config("olmoe-1b-7b").reduced()
    params, x = _moe_inputs(tokens=(2, 32), skew=1.0)
    mesh = jax.make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])

    def loss(p):
        return (JM.moe_ep(p, jcfg, jnp.asarray(x))[0] ** 2).mean()

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    with j_use_mesh(mesh):
        jy, jaux = JM.moe_ep(jp, jcfg, jnp.asarray(x))
        jg = jax.grad(loss)(jp)
    (got,) = spawn(_moe_rank, 1, tmp_path, (1, 1), False, params, x)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["y"], np.asarray(jy), **tol)
    np.testing.assert_allclose(got["aux"], float(jaux), **tol)
    for k in MOE_KEYS:
        np.testing.assert_allclose(got[k], np.asarray(jg[k]), err_msg=k,
                                   **tol)
    cfg = get_config("olmoe-1b-7b").reduced()
    dense = TM.moe_dense({k: torch.from_numpy(v) for k, v in params.items()},
                         cfg, torch.from_numpy(x))[0].numpy()
    assert np.abs(dense - got["y"]).max() > 1e-3     # slots were dropped


def test_moe_ep_needs_a_mesh_with_a_model_axis():
    cfg = get_config("olmoe-1b-7b").reduced()
    params, x = _moe_inputs()
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    with pytest.raises(ValueError, match="model"):
        TM.moe(p, cfg, torch.from_numpy(x), impl="ep")

    class FakeMesh:
        shape = {"data": 2}

    with use_mesh(FakeMesh()), pytest.raises(ValueError, match="model"):
        TM.moe_ep(p, cfg, torch.from_numpy(x))
