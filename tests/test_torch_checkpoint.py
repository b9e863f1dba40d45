"""The port's checkpoint manager, restart loop and resuming launcher,
against `repro.checkpoint` and `repro.runtime.fault`.

The format on disk is the reference's, so a checkpoint crosses between
the packages through files only: the JAX package writes a reduced
qwen3-1.7b {"params", "opt"} train state and the port restores it, and
the other way round, bit for bit. A bf16 leaf is written by both as the
same bytes (2-byte void, as numpy stores an ``ml_dtypes`` array); the
reference's own `restore` refuses that dtype (`jnp.asarray` of a void
array), so the port's bf16 file is read back on the reference side with
the ``ml_dtypes`` view its writer used.
"""
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointConfig as JConfig
from repro.checkpoint import CheckpointManager as JManager
from repro.configs import get_config as j_get_config
from repro.models.model import init_model as j_init_model
from repro_torch import convert
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.checkpoint import manager as TCK
from repro_torch.configs import get_config
from repro_torch.core.compute_plane import tree_map
from repro_torch.launch import train as launch_train
from repro_torch.runtime.fault import run_with_restarts

torch.set_num_threads(1)


def _mgr(path, **kw):
    return CheckpointManager(CheckpointConfig(str(path), **kw))


# ---------------------------------------------- test_substrates.py:82-118
def test_checkpoint_roundtrip_and_retention(tmp_path):
    mgr = _mgr(tmp_path, keep=2, async_save=False)
    state = {"w": torch.arange(6.0).reshape(2, 3),
             "opt": {"mu": torch.ones((4,)),
                     "count": torch.tensor(7, dtype=torch.int32)}}
    for step in (10, 20, 30):
        mgr.save(step, {"w": state["w"] + step,
                        "opt": {"mu": state["opt"]["mu"] + step,
                                "count": state["opt"]["count"] + step}},
                 extra={"data_step": step * 2})
    assert mgr.all_steps() == [20, 30]  # retention
    restored, step, extra = mgr.restore(state)
    assert step == 30 and extra["data_step"] == 60
    assert torch.equal(restored["w"], state["w"] + 30)
    assert int(restored["opt"]["count"]) == 37
    assert restored["opt"]["count"].dtype == torch.int32
    restored, step, _ = mgr.restore(state, step=20)
    assert step == 20 and torch.equal(restored["opt"]["mu"],
                                      torch.full((4,), 21.0))


def test_checkpoint_atomicity_ignores_tmp(tmp_path):
    mgr = _mgr(tmp_path, async_save=False)
    state = {"w": torch.ones((2,))}
    mgr.save(5, state)
    (tmp_path / "step_9.tmp").mkdir()          # simulated crash debris
    assert mgr.latest_step() == 5
    restored, step, _ = mgr.restore(state)
    assert step == 5
    assert _mgr(tmp_path / "empty").restore(state) == (None, None, None)


def test_checkpoint_async(tmp_path):
    mgr = _mgr(tmp_path, async_save=True)
    mgr.save(1, {"w": torch.zeros((8,))})
    mgr.wait()
    assert mgr.latest_step() == 1


def test_state_is_safe_once_save_returns(tmp_path, monkeypatch):
    """The optimizer updates params and moments in place right after an
    async save returns; the writer, held back until then, still writes
    the state from before."""
    release = threading.Event()
    write = TCK.CheckpointManager._write

    def held_write(self, *args):
        assert release.wait(30)
        return write(self, *args)

    monkeypatch.setattr(TCK.CheckpointManager, "_write", held_write)
    mgr = _mgr(tmp_path, async_save=True)
    state = {"params": {"w": torch.randn(64, 8)},
             "opt": {"mu": torch.randn(64, 8),
                     "count": torch.tensor(3, dtype=torch.int32)}}
    before = {"params": {"w": state["params"]["w"].clone()},
              "opt": {"mu": state["opt"]["mu"].clone(),
                      "count": state["opt"]["count"].clone()}}
    mgr.save(3, state)
    state["params"]["w"].mul_(-2.0).add_(1.0)       # as adamw_update does
    state["opt"]["mu"].zero_()
    state["opt"]["count"].add_(1)
    release.set()
    mgr.wait()
    restored, _, _ = mgr.restore(state)
    for got, want in ((restored["params"]["w"], before["params"]["w"]),
                      (restored["opt"]["mu"], before["opt"]["mu"]),
                      (restored["opt"]["count"], before["opt"]["count"])):
        assert torch.equal(got, want)


# --------------------------------------------- test_substrates.py:180-207
def test_run_with_restarts_resumes_from_checkpoint(tmp_path):
    mgr = _mgr(tmp_path, async_save=False)
    progress = []

    def make_state():
        return {"x": torch.zeros(())}, 0

    def run_from(state, step):
        x = float(state["x"])
        for s in range(step, 10):
            x += 1.0
            if s == 4 and not progress:
                # checkpoint labels the NEXT step to run (s+1 done-through)
                mgr.save(s + 1, {"x": torch.tensor(x)})
                progress.append("crashed")
                raise RuntimeError("injected node failure")
        progress.append(("done", x))

    failures = run_with_restarts(make_state, run_from, mgr, max_failures=2)
    assert failures == 1
    done = [p for p in progress if isinstance(p, tuple)][0]
    assert done[1] == 10.0  # resumed from step 4 with x=5, +5 more


def test_run_with_restarts_gives_up_after_max_failures(tmp_path):
    mgr = _mgr(tmp_path, async_save=False)
    attempts = []

    def hook(attempt):
        attempts.append(attempt)
        raise RuntimeError("injected")

    with pytest.raises(RuntimeError, match="injected"):
        run_with_restarts(lambda: ({"x": torch.zeros(())}, 0),
                          lambda state, step: None, mgr, max_failures=2,
                          fault_hook=hook)
    assert attempts == [0, 1, 2]


# ------------------------------------------------- across the two packages
def _np_state():
    """A reduced qwen3-1.7b train state as numpy: the reference's
    parameters, moments drawn from a seed, count 3."""
    jcfg = j_get_config("qwen3-1.7b").reduced()
    params = jax.device_get(j_init_model(jax.random.PRNGKey(0), jcfg)[0])
    rng = np.random.default_rng(0)
    moment = lambda p: rng.standard_normal(p.shape).astype(np.float32)  # noqa
    opt = {"mu": jax.tree.map(moment, params),
           "nu": jax.tree.map(lambda p: np.abs(moment(p)), params),
           "count": np.asarray(3, np.int32)}
    return {"params": params, "opt": opt}


def _port_state(np_state, cfg):
    return {"params": convert.params_from_numpy(np_state["params"], cfg,
                                                "cpu"),
            "opt": convert.opt_state_from_numpy(np_state["opt"], "cpu")}


def _assert_equal_trees(a, b):
    la, lb = TCK._leaf_paths(a), TCK._leaf_paths(b)
    assert [n for n, _ in la] == [n for n, _ in lb] and len(la) > 30
    for (name, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), name


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    cfg = get_config("qwen3-1.7b").reduced()
    np_state = _np_state()
    np_state["params"]["embed"]["table"] = np_state["params"]["embed"][
        "table"].astype(ml_dtypes.bfloat16)
    JManager(JConfig(str(tmp_path), async_save=False)).save(
        7, np_state, extra={"data_step": 7})
    want = _port_state(np_state, cfg)
    assert want["params"]["embed"]["table"].dtype == torch.bfloat16
    template = {"params": tree_map(torch.zeros_like,
                                           want["params"]),
                "opt": tree_map(torch.zeros_like, want["opt"])}
    got, step, extra = _mgr(tmp_path).restore(template)
    assert step == 7 and extra == {"data_step": 7}
    _assert_equal_trees(got, want)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    cfg = get_config("qwen3-1.7b").reduced()
    np_state = _np_state()
    _mgr(tmp_path / "port", async_save=False).save(
        7, _port_state(np_state, cfg), extra={"data_step": 7})
    j_template = jax.tree.map(jnp.zeros_like, np_state)
    got, step, extra = JManager(JConfig(str(tmp_path / "port"))).restore(
        j_template)
    assert step == 7 and extra == {"data_step": 7}
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(np_state)[0]
    assert len(flat_got) == len(flat_want) > 30
    for (path, x), (_, y) in zip(flat_got, flat_want):
        np.testing.assert_array_equal(np.asarray(x), y, err_msg=str(path))
        assert np.asarray(x).dtype == y.dtype


def test_both_packages_write_the_same_files_bf16_leaf_included(tmp_path):
    """Every .npy file and the manifest are byte for byte the same, a
    bf16 leaf included; that leaf reads back in the reference's dtype."""
    cfg = get_config("qwen3-1.7b").reduced()
    np_state = _np_state()
    np_state["params"]["final_norm"]["scale"] = (
        np_state["opt"]["mu"]["final_norm"]["scale"].astype(
            ml_dtypes.bfloat16))
    JManager(JConfig(str(tmp_path / "ref"), async_save=False)).save(
        4, np_state)
    _mgr(tmp_path / "port", async_save=False).save(
        4, _port_state(np_state, cfg))
    ref, port = tmp_path / "ref" / "step_4", tmp_path / "port" / "step_4"
    names = sorted(p.name for p in ref.iterdir())
    assert names == sorted(p.name for p in port.iterdir())
    assert "manifest.json" in names and len(names) > 30
    for name in names:
        assert (ref / name).read_bytes() == (port / name).read_bytes(), name
    leaf = np.load(port / "params_final_norm_scale.npy").view(
        ml_dtypes.bfloat16)
    np.testing.assert_array_equal(
        leaf.view(np.uint16),
        np_state["params"]["final_norm"]["scale"].view(np.uint16))


# ------------------------------------------------------------ the launcher
ARGS = ["--reduced", "--device", "cpu", "--steps", "4", "--ckpt-every", "2"]


def _files(step_dir):
    return {p.name: p.read_bytes() for p in step_dir.iterdir()}


def test_launcher_resumes_to_the_state_of_an_uninterrupted_run(
        tmp_path, monkeypatch, capsys):
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    launch_train.main(ARGS + ["--ckpt-dir", str(whole)])
    assert CheckpointManager(CheckpointConfig(str(whole))).all_steps() == \
        [2, 4]

    batch = launch_train.synthetic_batch

    def stop_at_2(cfg, shape, dcfg, step, device):
        if step == 2:
            raise RuntimeError("injected stop after step 2")
        return batch(cfg, shape, dcfg, step, device)

    monkeypatch.setattr(launch_train, "synthetic_batch", stop_at_2)
    with pytest.raises(RuntimeError, match="injected"):
        launch_train.main(ARGS + ["--ckpt-dir", str(cut)])
    assert CheckpointManager(CheckpointConfig(str(cut))).all_steps() == [2]
    monkeypatch.setattr(launch_train, "synthetic_batch", batch)
    capsys.readouterr()
    m = launch_train.main(ARGS + ["--ckpt-dir", str(cut)])
    assert "resumed from step 2" in capsys.readouterr().out
    assert np.isfinite(float(m["loss"]))
    assert _files(cut / "step_4") == _files(whole / "step_4")
    assert launch_train.main(ARGS + ["--ckpt-dir", str(cut)]) is None
    assert "resumed from step 4" in capsys.readouterr().out
