"""The port's dry run: cells traced on a fake 2x2 (and 2x2x2) world,
the op-level cost analysis on a real program, and the sharded train step
executed for real on four gloo ranks.

Each `run_cell` starts its fake process group and ends it before it
returns; the gloo ranks are spawned processes (file rendezvous in
`tmp_path`, joins timed out). The cells run with remat="none" to keep
the trace short; the rest of the reference's dry-run options are kept.
Tolerance of the sharded train step against the unsharded one on the
same parameters: loss rtol 1e-5, as tests/test_torch_train.py holds the
loss (f32 sums taken in another order), and every updated parameter
within 1e-6."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.launch import dryrun, op_analysis
from repro_torch.launch.mesh import build_mesh
from repro_torch.launch.specs import (input_specs, model_options_for,
                                      shardings_for)
from repro_torch.models.model import ModelOptions, init_model, loss_fn
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime.mesh_rules import use_mesh
from repro_torch.runtime.train_loop import TrainConfig, make_train_step
from test_torch_dist import spawn

torch.set_num_threads(1)

FAST = {"remat": "none"}
CELLS = [(a, s) for a in ("qwen3-1.7b-reduced", "olmoe-1b-7b-reduced")
         for s in ("smoke_train", "smoke_prefill", "smoke_decode")]


def _check_flops(rec):
    cfg = get_config(rec["arch"])
    counts = dryrun.model_param_counts(cfg)
    shape = {"smoke_train": (6.0, 2 * 64), "smoke_prefill": (2.0, 2 * 64),
             "smoke_decode": (2.0, 2)}[rec["shape"]]
    assert rec["model_flops"] == shape[0] * counts["active_nonembed"] * \
        shape[1]
    assert rec["flops"] >= rec["model_flops"] / rec["chips"]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_traces_on_a_fake_2x2_world(arch, shape):
    rec = dryrun.run_cell(arch, shape, mesh_shape=(2, 2), opt_overrides=FAST)
    assert rec["status"] == "ok", rec
    assert rec["chips"] == 4 and rec["mesh"] == "mesh_2x2"
    oa = rec["op_analysis"]
    assert sum(c["count"] for c in oa["collectives"].values()) > 0
    assert oa["wire_bytes_per_chip"] > 0
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0
    assert mem["temp_size_in_bytes"] >= 0
    assert rec["fits"] is True
    assert rec["reshards"] == sum(r["count"] for r in oa["reshards"])
    assert rec["bound_bytes"] >= mem["argument_size_in_bytes"]
    _check_flops(rec)


def test_unsharded_cell_has_no_collectives_and_more_flops():
    sharded = dryrun.run_cell("qwen3-1.7b-reduced", "smoke_decode",
                              mesh_shape=(2, 2), opt_overrides=FAST)
    plain = dryrun.run_cell("qwen3-1.7b-reduced", "smoke_decode",
                            mesh_shape=(), opt_overrides=FAST)
    assert plain["status"] == "ok" and plain["mesh"] == "none"
    assert plain["op_analysis"]["collectives"] == {}
    assert plain["op_analysis"]["wire_bytes_per_chip"] == 0
    assert plain["flops"] >= sharded["flops"]
    _check_flops(plain)
    # the decode state is updated in place: donated
    assert plain["memory_analysis"]["alias_size_in_bytes"] > 0


def test_cell_counts_do_not_depend_on_earlier_traces():
    """The first trace of a mesh in a process makes DTensor learn each
    op's result shape (a global-shape op on a fake mode of its own) and
    compute shard sizes on real host tensors; none of that is the step's
    work, so a second trace of the same cell counts the same. The 1x4
    mesh is traced nowhere else in this module."""
    recs = [dryrun.run_cell("qwen3-1.7b-reduced", "smoke_decode",
                            mesh_shape=(1, 4), opt_overrides=FAST)
            for _ in range(2)]
    keys = ("flops_per_chip", "eager_op_bytes_per_chip", "bound_bytes",
            "wire_bytes_per_chip", "num_ops", "peak_bytes")
    first, second = ({k: r["op_analysis"][k] for k in keys} for r in recs)
    assert first == second


def test_int8_pod_sync_cell_traces_its_kernels_as_custom_ops(tmp_path):
    rec = dryrun.run_cell("qwen3-1.7b-reduced", "smoke_train", multi_pod=True,
                          mesh_shape=(2, 2, 2), opt_overrides=FAST,
                          dp_compress="int8", dump_ops=True, out_dir=tmp_path)
    assert rec["status"] == "ok", rec
    assert rec["chips"] == 8
    _check_flops(rec)
    import json
    ops = {o["op"]: o for o in json.loads(
        (tmp_path / "qwen3-1.7b-reduced__smoke_train__mesh_2x2x2.ops.json")
        .read_text())}
    leaves = 14                        # qwen3's parameter leaves
    assert ops["repro_torch.quantize_block_int8"]["count"] == leaves
    assert ops["repro_torch.dequantize_block_int8"]["count"] == 2 * leaves
    assert ops["repro_torch.quantize_block_int8"]["bytes"] > 0
    assert rec["op_analysis"]["collectives"]["all-gather"]["count"] > 0


def test_failed_cell_is_an_error_record(tmp_path):
    rc = dryrun.main(["--arch", "qwen3-1.7b-reduced", "--shape",
                      "smoke_train", "--opt", "no_such_option=True",
                      "--out-dir", str(tmp_path)])
    assert rc == 1
    import json
    rec = json.loads((tmp_path / "qwen3-1.7b-reduced__smoke_train__"
                      "pod_16x16.json").read_text())
    assert rec["status"] == "error" and "no_such_option" in rec["error"]
    assert "Traceback" in rec["traceback"]


OPTIONS = {"off": {}, "tp_reduce_bf16": {"tp_reduce_bf16": True},
           "seq_shard_residual": {"seq_shard_residual": True}}


@pytest.fixture(scope="module")
def option_cells():
    return {name: dryrun.run_cell("qwen3-1.7b-reduced", "smoke_train",
                                  mesh_shape=(2, 2),
                                  opt_overrides={**FAST, **ov})
            for name, ov in OPTIONS.items()}


@pytest.mark.parametrize("name", ["tp_reduce_bf16", "seq_shard_residual"])
def test_option_cell_traces_on_a_fake_2x2_world(option_cells, name):
    rec = option_cells[name]
    assert rec["status"] == "ok", rec
    assert rec["opt_overrides"][name] is True
    assert rec["op_analysis"]["wire_bytes_per_chip"] > 0
    _check_flops(rec)


def test_tp_reduce_bf16_halves_the_row_parallel_all_reduces(option_cells):
    """With tp_reduce_bf16 the row-parallel products (attention's wo and
    the MLP's w_down, two per layer) are all-reduced over `model` in
    bf16: the all-reduce wire bytes drop by exactly half of theirs, and
    no other collective changes."""
    off = option_cells["off"]["op_analysis"]["collectives"]
    on = option_cells["tp_reduce_bf16"]["op_analysis"]["collectives"]
    assert sorted(on) == sorted(off)
    for kind in off:
        assert on[kind]["count"] == off[kind]["count"], kind
        if kind != "all-reduce":
            assert on[kind]["wire_bytes"] == off[kind]["wire_bytes"], kind
    cfg = get_config("qwen3-1.7b-reduced")
    b, s = 2 // 2, 64                  # smoke_train's rows on one data rank
    products = 2 * cfg.num_layers
    f32_wire = products * 2 * b * s * cfg.d_model * 4   # 2x operand bytes
    saved = off["all-reduce"]["wire_bytes"] - on["all-reduce"]["wire_bytes"]
    assert saved == f32_wire // 2


def test_list_prints_the_80_cells(capsys):
    assert dryrun.main(["--list"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 80


def test_op_analysis_on_a_real_program():
    """The reference's bar for its HLO analyzer (tests/test_system.py),
    on whisper-base-reduced's loss."""
    cfg = get_config("whisper-base").reduced()
    params = init_model(cfg, torch.Generator().manual_seed(0))
    batch = synthetic_batch(cfg, ShapeConfig("s", 64, 2, "train"),
                            DataConfig(), 0, device="cpu")
    opt = ModelOptions(remat="none")
    res = op_analysis.analyze(lambda p, b: loss_fn(p, cfg, b, opt)[0],
                              params, batch)
    assert res["flops_per_chip"] > 1e6
    assert res["eager_op_bytes_per_chip"] > 0
    assert res["bound_bytes"] >= res["argument_bytes"]
    assert res["collectives"] == {} and res["num_ops"] > 100
    assert res["peak_bytes"] >= res["argument_bytes"] > 0
    assert res["top_flop_computations"][0]["flops"] > 0


# ------------------------------------------------- sharded train step
SHAPE = ShapeConfig("tiny_train", 32, 4, "train")


def _sharded_train_rank(rank, world):
    """`input_specs` + `shardings_for` on a 2x2 mesh, and the DTensor
    train step executed for real; then the unsharded step on the same
    parameters. Once with one microbatch (the reduced config's) and once
    with two, where the sharded step must split the batch into the same
    rows as the unsharded one (row 1 is mostly masked, so other rows
    would give another loss)."""
    from torch.distributed.tensor.experimental import implicit_replication
    mesh = build_mesh((2, 2), ("data", "model"))
    out = {}
    for n_micro in (1, 2):
        cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                                  grad_accum_microbatches=n_micro)
        opt = model_options_for(cfg, SHAPE, remat="none")
        fake, axes = input_specs(cfg, SHAPE, opt, device="cpu")

        def fresh():
            params = init_model(cfg, torch.Generator().manual_seed(0))
            batch = synthetic_batch(cfg, SHAPE, DataConfig(seed=0), 0,
                                    device="cpu")
            # rows of unequal weight: a microbatch's masked mean then
            # depends on which rows it holds
            batch["mask"][1, SHAPE.seq_len // 4:] = 0
            return params, adamw_init(params), batch

        params, opt_state, batch = fresh()
        real_leaves = dryrun.path_leaves((params, opt_state, batch))
        fake_leaves = dryrun.path_leaves(fake[:3])
        shapes_match = [(k, tuple(t.shape)) for k, t in real_leaves] == \
            [(k, tuple(t.shape)) for k, t in fake_leaves]
        args = shardings_for((params, opt_state, batch, 0), axes, mesh)
        step = make_train_step(cfg, opt, TrainConfig())
        with use_mesh(mesh), implicit_replication():
            new, _, m = step(*args)
        loss = m["loss"]
        loss = loss.full_tensor() if hasattr(loss, "full_tensor") else loss
        got = {k: t.full_tensor() for k, t in dryrun.path_leaves(new)}
        params, opt_state, batch = fresh()
        ref_params, _, ref = step(params, opt_state, batch, 0)
        err = max(float((got[k] - t).abs().max())
                  for k, t in dryrun.path_leaves(ref_params))
        out[n_micro] = (shapes_match, float(loss), float(ref["loss"]), err)
    return out


@pytest.fixture(scope="module")
def sharded_train(tmp_path_factory):
    return spawn(_sharded_train_rank, 4,
                 tmp_path_factory.mktemp("sharded_train"))


def _check_sharded(results):
    for shapes_match, loss, ref, param_err in results:
        assert shapes_match
        assert np.isfinite(loss)
        np.testing.assert_allclose(loss, ref, rtol=1e-5)
        # the updated parameters (lr 3e-4 steps) agree with the unsharded
        # step's to f32 rounding of the gradient sums
        assert param_err < 1e-6


def test_sharded_train_step_executes_on_4_gloo_ranks(sharded_train):
    _check_sharded([r[1] for r in sharded_train])


def test_sharded_train_step_splits_microbatches_as_unsharded(sharded_train):
    _check_sharded([r[2] for r in sharded_train])


# ------------------------------------------- sharded int8 pod sync
POD_MESH = ((2, 1, 2), ("pod", "data", "model"))


def _odd_stack(rank_mesh=None):
    """Per-pod gradients (2, ...) of three leaves of another layout than
    qwen3's: one split on dim 0 into shards of a multiple of the block,
    one split on dim 0 into 30-value shards (the second starts inside
    the leaf's only block), one split on its last dim; numpy seeds."""
    from torch.distributed.tensor import Replicate, Shard
    rng = np.random.default_rng(7)
    shapes = [((2, 512, 4), Shard(1)), ((2, 6, 10), Shard(1)),
              ((2, 8, 6), Shard(2))]
    plain = [torch.from_numpy((rng.standard_normal(s) * 10.0 ** -k)
                              .astype(np.float32))
             for k, (s, _) in enumerate(shapes)]
    if rank_mesh is None:
        return plain
    from torch.distributed.tensor import distribute_tensor
    return [distribute_tensor(t, rank_mesh, (Shard(0), Replicate(), p))
            for t, (_, p) in zip(plain, shapes)]


def _int8_pod_rank(rank, world):
    """The int8 train step on a (pod 2, data 1, model 2) mesh, its pod
    sync's input and output recorded; the unsharded sync on the same
    per-pod gradients; the sync alone on `_odd_stack`; and the unsharded
    int8 step on the same parameters and batch."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.core.compute_plane import tree_leaves
    from repro_torch.runtime import train_loop as TL
    mesh = build_mesh(*POD_MESH)
    cfg = get_config("qwen3-1.7b").reduced()
    opt = model_options_for(cfg, SHAPE, remat="none")
    _, axes = input_specs(cfg, SHAPE, opt, device="cpu")
    tcfg = TrainConfig(dp_compress="int8", num_pods=2)

    def fresh():
        params = init_model(cfg, torch.Generator().manual_seed(0))
        batch = synthetic_batch(cfg, SHAPE, DataConfig(seed=0), 0,
                                device="cpu")
        return params, adamw_init(params), batch

    seen = {}
    sync = TL._pod_sync_local_map

    def spy(stack, block):
        out = sync(stack, block)
        seen["in"] = [t.full_tensor() for t in tree_leaves(stack)]
        seen["out"] = [t.full_tensor() for t in tree_leaves(out)]
        return out

    step = make_train_step(cfg, opt, tcfg)
    args = shardings_for((*fresh(), 0), axes, mesh)
    TL._pod_sync_local_map = spy
    try:
        with use_mesh(mesh), implicit_replication():
            new, _, m = step(*args)
    finally:
        TL._pod_sync_local_map = sync
    want = TL._compressed_pod_sync(seen["in"], 2, tcfg.quant_block)
    step_equal = [torch.equal(a, b) for a, b in zip(seen["out"], want)]
    odd = sync(_odd_stack(mesh), tcfg.quant_block)
    odd_want = TL._compressed_pod_sync(_odd_stack(), 2, tcfg.quant_block)
    odd_equal = [torch.equal(a.full_tensor(), b)
                 for a, b in zip(odd, odd_want)]
    loss = m["loss"]
    loss = loss.full_tensor() if hasattr(loss, "full_tensor") else loss
    got = {k: t.full_tensor() for k, t in dryrun.path_leaves(new)}
    ref_params, _, ref = step(*fresh(), 0)
    err = max(float((got[k] - t).abs().max())
              for k, t in dryrun.path_leaves(ref_params))
    return step_equal, odd_equal, float(loss), float(ref["loss"]), err


def test_block_aligned_shards():
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.runtime.train_loop import _block_aligned
    sizes = (2, 1, 2)
    r = Replicate()
    assert _block_aligned((r, r, r), (6, 10), sizes, 256)
    assert _block_aligned((r, r, Shard(0)), (512, 4), sizes, 256)
    assert _block_aligned((r, Shard(1), r), (6, 10), sizes, 256)  # size 1
    assert not _block_aligned((r, r, Shard(0)), (6, 10), sizes, 256)
    assert not _block_aligned((r, r, Shard(1)), (512, 4), sizes, 256)
    assert not _block_aligned((r, r, Shard(0)), (3, 512), sizes, 256)


def test_sharded_int8_pod_sync_is_bit_equal_to_unsharded(tmp_path):
    """On a (pod 2, data 1, model 2) mesh the sharded pod sync quantizes
    in the whole leaf's blocks: its result is bit-equal to the unsharded
    sync's on the same per-pod gradients, for qwen3's leaves (split on
    dim 0, on inner dims, or whole) inside the train step and for
    `_odd_stack`'s. The step's loss and parameters agree with the
    unsharded int8 step's as the (data, model) step's do (the
    tensor-parallel products sum in another order)."""
    for step_equal, odd_equal, loss, ref, err in spawn(_int8_pod_rank, 4,
                                                       tmp_path):
        assert len(step_equal) == 14 and all(step_equal)
        assert odd_equal == [True] * 3
        np.testing.assert_allclose(loss, ref, rtol=1e-5)
        assert err < 1e-6
