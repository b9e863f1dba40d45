"""The port's mesh rules and process-group meshes against the
reference's `repro.runtime.mesh_rules` and `repro.launch.mesh`.

The rules are pure functions of axis names and sizes, so they are held
to the reference exactly: a spec is the tuple of the reference's
`PartitionSpec` entries. The mesh builders run on a gloo group of
spawned ranks (see `test_torch_dist.spawn`).
"""
import itertools
import math

import jax.sharding
import numpy as np
import pytest
import torch
from _hyp import given, settings, st  # optional-hypothesis shim

from repro.launch import mesh as JMESH
from repro.runtime import mesh_rules as JR
from repro_torch.launch import mesh as TMESH
from repro_torch.runtime import mesh_rules as TR
from test_torch_dist import spawn

torch.set_num_threads(1)


class FakeMesh:
    shape = {"pod": 2, "data": 16, "model": 16}


def test_logical_to_pspec_divisibility_fallback():
    mesh = FakeMesh()
    # batch 256 shards over pod x data
    assert TR.logical_to_pspec(("batch", None), (256, 128), mesh) == \
        (("pod", "data"),)
    # batch 1 -> fully replicated
    assert TR.logical_to_pspec(("batch", None), (1, 128), mesh) == ()
    # batch 32: divisible by pod*data=32
    assert TR.logical_to_pspec(("batch",), (32,), mesh) == (("pod", "data"),)
    # kv heads 4 cannot shard over model=16 -> replicated dim
    assert TR.logical_to_pspec(("fsdp", "tensor_kv", None), (4096, 4, 128),
                               mesh) == ("data",)
    # same mesh axis never used twice
    assert TR.logical_to_pspec(("tensor", "vocab"), (64, 6400), mesh) == \
        ("model",)
    with pytest.raises(ValueError):
        TR.logical_to_pspec(("batch",), (4, 4), mesh)


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 512), st.integers(1, 512))
def test_pspec_always_divides(a, b):
    """Property: whatever sizes arrive, the spec evenly divides them."""
    ps = TR.logical_to_pspec(("batch", "tensor"), (a, b), FakeMesh())
    sizes = FakeMesh.shape
    dims = list(ps) + [None] * (2 - len(ps))
    for dim_size, spec in zip((a, b), dims):
        if spec is None:
            continue
        axes = spec if isinstance(spec, tuple) else (spec,)
        assert dim_size % math.prod(sizes[x] for x in axes) == 0


MESHES = [{"pod": 2, "data": 16, "model": 16}, {"data": 4, "model": 2},
          {"data": 3}, {"stage": 4, "model": 2}, {"model": 8}]
SIZES = (1, 2, 3, 4, 6, 8, 12, 16, 32, 48, 256, 4096)


def test_logical_to_pspec_equals_reference_on_every_case():
    """Every pair of logical axes (every rule and None) over sizes
    sharing and not sharing the mesh's factors, on five meshes, with the
    default rules and an override: the reference's PartitionSpec
    entries."""
    logical = list(TR.DEFAULT_RULES)
    assert set(logical) == set(JR.DEFAULT_RULES)
    assert all(TR.DEFAULT_RULES[k] == JR.DEFAULT_RULES[k] for k in logical)
    n = 0
    for shape in MESHES:
        mesh = type("M", (), {"shape": shape})()
        for rules in (None, {**JR.DEFAULT_RULES, "batch": ("data",)}):
            for axes in itertools.product(logical, repeat=2):
                for dims in itertools.product(SIZES[::3], SIZES[1::3]):
                    want = JR.logical_to_pspec(axes, dims, mesh, rules)
                    got = TR.logical_to_pspec(axes, dims, mesh, rules)
                    assert isinstance(want, jax.sharding.PartitionSpec)
                    assert got == tuple(want), (shape, axes, dims)
                    n += 1
    assert n > 5000


def test_rules_stack_mesh_stack_and_helpers():
    mesh = FakeMesh()
    assert TR.active_mesh() is None
    assert TR.current_rules() is TR.DEFAULT_RULES
    x = torch.ones(3)
    assert TR.constrain(x, ("batch",)) is x
    with TR.use_mesh(mesh) as m:
        assert m is mesh and TR.active_mesh() is mesh
        assert TR.constrain(x, ("batch",)) is x         # the identity
        with TR.rule_override({"batch": ("data",)}) as rules:
            assert TR.current_rules() is rules
            assert TR.logical_to_pspec(("batch",), (32,), mesh, rules) == \
                ("data",)
            with TR.rule_override({"vocab": ()}):
                assert TR.current_rules()["batch"] == ("data",)
                assert TR.current_rules()["vocab"] == ()
        assert TR.current_rules() is TR.DEFAULT_RULES
    assert TR.active_mesh() is None
    for shape in MESHES:
        fake = type("M", (), {"shape": shape})()
        assert TR.dp_axis_names(fake) == JR.dp_axis_names(fake)
        assert TR.num_chips(fake) == JR.num_chips(fake)
        assert TR.axis_size(fake, "model") == JR.axis_size(fake, "model")


def test_factor_2d_equals_reference():
    for n in range(1, 513):
        assert TMESH._factor_2d(n) == JMESH._factor_2d(n), n


def test_build_mesh_needs_a_process_group():
    with pytest.raises(ValueError, match="disagree"):
        TMESH.build_mesh((2, 2), ("data",))
    with pytest.raises(RuntimeError, match="init_distributed"):
        TMESH.make_test_mesh()
    with pytest.raises(ValueError, match="init_method"):
        TMESH.init_distributed("cpu", world_size=2)


def _meshes_rank(rank, world):
    out = {}
    for name, mesh in (
            ("test", TMESH.make_test_mesh((2, 2), ("data", "model"))),
            ("production", TMESH.make_production_mesh(num_devices=world)),
            ("multi_pod", TMESH.make_production_mesh(multi_pod=True,
                                                     num_devices=world)),
            ("data", TMESH.make_data_mesh()),
            ("stage", TMESH.build_mesh((world,), ("stage",)))):
        out[name] = {"shape": TR.mesh_shape(mesh),
                     "coord": [TR.axis_index(mesh, a)
                               for a in mesh.mesh_dim_names],
                     "chips": TR.num_chips(mesh),
                     "dp": TR.dp_axis_names(mesh)}
    mesh = TMESH.make_test_mesh()
    # one collective on each axis's group: the ranks sharing the others
    for a in ("data", "model"):
        t = torch.tensor([float(rank)])
        torch.distributed.all_reduce(t, group=TR.axis_group(mesh, a))
        out[f"sum_{a}"] = float(t)
    try:
        TMESH.build_mesh((world * 2,), ("data",))
    except RuntimeError as e:
        out["too_big"] = str(e)
    return out


def test_mesh_builders_on_a_gloo_group(tmp_path):
    got = spawn(_meshes_rank, 4, tmp_path)
    for rank, out in enumerate(got):
        assert out["test"]["shape"] == {"data": 2, "model": 2}
        assert out["test"]["coord"] == [rank // 2, rank % 2]
        assert out["production"]["shape"] == {"data": 2, "model": 2}
        assert out["multi_pod"]["shape"] == {"pod": 2, "data": 2,
                                             "model": 1}
        assert out["multi_pod"]["dp"] == ("pod", "data")
        assert out["data"]["shape"] == {"data": 4}
        assert out["data"]["coord"] == [rank]
        assert out["stage"]["dp"] == () and out["stage"]["chips"] == 4
        # data groups join ranks {r, r+2}; model groups {2i, 2i+1}
        assert out["sum_data"] == float(2 * (rank % 2) + 2)
        assert out["sum_model"] == float(4 * (rank // 2) + 1)
        assert "need 8 ranks" in out["too_big"]
    assert np.all([o["test"]["chips"] == 4 for o in got])
