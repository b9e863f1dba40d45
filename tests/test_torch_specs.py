"""The port's dry-run specs against the reference's, for all ten archs:
exact parameter counts, the logical axes of every parameter and decode
state leaf (at the same shape), the batch specs, the dry run's 40 cells,
and the partition specs the mesh rules give each parameter on the two
production meshes. The reference's shapes come from `jax.eval_shape`;
both sides read a mesh only by its axis sizes, so a `.shape`-dict
stand-in serves for both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dryrun_cells as j_dryrun_cells
from repro.configs import get_config as j_get_config
from repro.data.pipeline import make_batch_specs as j_batch_specs
from repro.models import model as JM
from repro.runtime import mesh_rules as JR
from repro_torch.configs import (dryrun_cells, get_config, get_shape,
                                 list_archs)
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.launch import dryrun, specs
from repro_torch.models import model as TM
from repro_torch.models.layers import (ParamBuilder, is_axes_leaf,
                                       stack_layers)
from repro_torch.runtime import mesh_rules as TR

ARCHS = list_archs()


class _Mesh:
    def __init__(self, **sizes):
        self.shape = dict(sizes)


MESHES = [_Mesh(data=16, model=16), _Mesh(pod=2, data=16, model=16)]


def _key(k):
    if hasattr(k, "key"):
        return str(k.key)
    return f"[{k.idx}]"


def _ref_flat(tree, is_leaf=None):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {"/".join(_key(k) for k in path): leaf for path, leaf in flat}


def _port_flat(tree, is_leaf=None):
    return dict(dryrun.path_leaves(tree, is_leaf=is_leaf))


def _is_spec(x):
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) or is_axes_leaf(e) for e in x)


def _ref_params(cfg):
    box = {}

    def init(key):
        p, a = JM.init_model(key, cfg)
        box["axes"] = a
        return p

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return shapes, box["axes"]


def _ref_counts(cfg):
    """The reference dry run's `model_param_counts` rule on its shapes."""
    shapes, _ = _ref_params(cfg)
    total = active = nonembed = 0
    scale = cfg.experts_per_token / cfg.num_experts if cfg.is_moe else 1.0
    for keys, leaf in _ref_flat(shapes).items():
        n = leaf.size
        total += n
        if "embed/" in keys and "unembed" not in keys:
            continue
        nonembed += n
        if cfg.is_moe and "/ffn/" in keys and "router" not in keys:
            active += int(n * scale)
        else:
            active += n
    return {"total": total, "nonembed": nonembed, "active_nonembed": active}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_reference(arch):
    assert dryrun.model_param_counts(get_config(arch)) == \
        _ref_counts(j_get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_and_pspecs_equal_reference(arch):
    shapes, axes = _ref_params(j_get_config(arch))
    ref_axes = _ref_flat(axes, is_leaf=is_axes_leaf)
    ref_shapes = _ref_flat(shapes)
    p, pa = specs.abstract_params(get_config(arch))
    port_axes = _port_flat(TM.param_axes(get_config(arch)), is_axes_leaf)
    port_shapes = {k: tuple(t.shape) for k, t in _port_flat(p).items()}
    assert port_axes == ref_axes
    assert port_shapes == {k: tuple(v.shape) for k, v in ref_shapes.items()}
    for mesh in MESHES:
        ref_specs = _ref_flat(JR.tree_pspecs(axes, shapes, mesh),
                              is_leaf=lambda x: isinstance(
                                  x, jax.sharding.PartitionSpec))
        port_specs = _port_flat(TR.tree_pspecs(pa, p, mesh), _is_spec)
        assert port_specs == {k: tuple(v) for k, v in ref_specs.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_axes_equal_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for axis in ("kv_seq", "long_seq"):
        box = {}

        def init():
            s, a = JM.init_decode_state(jcfg, 4, 16,
                                        JM.ModelOptions(kv_seq_axis=axis))
            box["axes"] = a
            return s

        shapes = jax.eval_shape(init)
        opt = TM.ModelOptions(kv_seq_axis=axis)
        state, sa = specs.abstract_decode_state(cfg, 4, 16, opt)
        assert _port_flat(sa, is_axes_leaf) == \
            _ref_flat(box["axes"], is_leaf=is_axes_leaf)
        assert {k: tuple(t.shape) for k, t in _port_flat(state).items()} == \
            {k: tuple(v.shape) for k, v in _ref_flat(shapes).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal_reference(arch):
    for shape in ("train_4k", "prefill_32k"):
        ref, ref_axes = j_batch_specs(j_get_config(arch), get_shape(shape),
                                      dtype=jnp.bfloat16)
        got, axes = make_batch_specs(get_config(arch), get_shape(shape),
                                     dtype=torch.bfloat16)
        assert axes == ref_axes
        assert sorted(got) == sorted(ref)
        for k, t in got.items():
            assert tuple(t.shape) == ref[k].shape
            assert str(t.dtype).split(".")[-1] == str(ref[k].dtype)


def test_dryrun_cells_equal_reference():
    assert dryrun_cells() == j_dryrun_cells()
    assert len(dryrun_cells()) == 40
    assert sum(not c["run"] for c in dryrun_cells()) == 8
    assert len(dryrun.cell_list()) == 80


def test_model_options_for_keeps_the_reference_choices():
    moe, dense = get_config("olmoe-1b-7b"), get_config("qwen3-1.7b")
    o = specs.model_options_for(moe, get_shape("train_4k"))
    assert (o.moe_impl, o.remat, o.kv_seq_axis) == ("ep", "full", "kv_seq")
    o = specs.model_options_for(dense, get_shape("long_500k"))
    assert (o.moe_impl, o.kv_seq_axis) == ("dense", "long_seq")
    o = specs.model_options_for(dense, get_shape("train_4k"),
                                tp_reduce_bf16=True, seq_shard_residual=True)
    assert (o.tp_reduce_bf16, o.seq_shard_residual, o.remat) == \
        (True, True, "full")
    with pytest.raises(TypeError, match="no_such_option"):
        specs.model_options_for(dense, get_shape("train_4k"),
                                no_such_option=True)
    assert dryrun.parse_opt("remat=none,ssd_chunk=64,window_ring=True") == \
        {"remat": "none", "ssd_chunk": 64, "window_ring": True}


def test_stack_layers_and_param_draws():
    def block(gen, d):
        pb = ParamBuilder(gen)
        pb.add("w", (d, 2 * d), ("fsdp", "tensor"))
        pb.add("b", (d,), (None,), init="ones")
        pb.add("u", (d, d), (None, None), init="uniform", scale=0.5)
        return pb.build()

    gen = torch.Generator().manual_seed(3)
    p, a = stack_layers(gen, block, 3, 4)
    assert a == {"w": ("layers", "fsdp", "tensor"), "b": ("layers", None),
                 "u": ("layers", None, None)}
    assert p["w"].shape == (3, 4, 8) and torch.all(p["b"] == 1)
    assert float(p["u"].abs().max()) <= 0.5
    # layer i is the i-th draw of the same generator, in order
    gen = torch.Generator().manual_seed(3)
    for i in range(3):
        q, _ = block(gen, 4)
        for k in q:
            assert torch.equal(p[k][i], q[k])
    with pytest.raises(ValueError, match="disagree"):
        ParamBuilder(gen).add("x", (2, 2), ("fsdp",))
    assert is_axes_leaf(()) and is_axes_leaf(("a", None))
    assert not is_axes_leaf(({"a": 1},))


def test_init_model_draws_unchanged():
    """Stating the axes did not change the draws: the same generator gives
    the same tensors as a layer-by-layer draw in the documented order
    (the embedding table first)."""
    cfg = get_config("qwen3-1.7b").reduced()
    p = TM.init_model(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models.layers import padded_vocab
    table = torch.randn((padded_vocab(cfg.vocab_size), cfg.d_model),
                        generator=gen)
    assert torch.equal(p["embed"]["table"], table)
    assert np.isfinite(p["runs"][0]["attn"]["wq"].numpy()).all()


def test_named_sharding_placements():
    from torch.distributed.tensor import Replicate, Shard
    m = _Mesh(pod=2, data=16, model=16)
    sh = TR.named_sharding(("batch", "kv_seq", "tensor_kv", None),
                           (128, 32768, 8, 128), m)
    assert sh.spec == (("pod", "data"), "model")
    assert sh.placements == (Shard(0), Shard(0), Shard(1))
    sh = TR.named_sharding(("long_seq", None), (524288, 8), m)
    assert sh.placements == (Replicate(), Shard(0), Shard(0))
    tree = TR.tree_shardings({"a": ("vocab", "fsdp")},
                             {"a": torch.empty(512, 64)}, m)
    assert tree["a"].placements == (Replicate(), Shard(1), Shard(0))
