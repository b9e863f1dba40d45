"""Abstract specs for every dry-run cell: params, optimizer, caches, inputs.

PyTorch counterpart of ``repro.launch.specs``. Everything is a fake
tensor (``device.fake_mode``): it has a shape, a type and a device but
no memory, the counterpart of the reference's ``jax.eval_shape`` +
``ShapeDtypeStruct``, which lets one CPU process stand for a 512-chip
program. The parameters are made by running the port's own `init_model`
under the fake mode (with a CPU generator) and re-making each leaf on
the target device; the optimizer state and decode state by their own
init functions. `shardings_for` then places each fake tensor on a
``DeviceMesh`` by the mesh rules, as a ``DTensor``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.compute_plane import tree_map
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.device import fake_device, fake_mode
from repro_torch.models.model import (ModelOptions, decode_state_axes,
                                      init_decode_state, init_model,
                                      param_axes)
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime import mesh_rules


def model_options_for(cfg: ArchConfig, shape: ShapeConfig,
                      **overrides) -> ModelOptions:
    """The reference's dry-run options: expert parallelism for MoE,
    remat="full", and the "long_seq" cache axis for `long_*` shapes;
    `overrides` set any other field (an unknown name raises)."""
    kw = dict(moe_impl="ep" if cfg.is_moe else "dense",
              triangular_flash=True, remat="full")
    if shape.name.startswith("long"):
        kw["kv_seq_axis"] = "long_seq"
    kw.update(overrides)
    return ModelOptions(**kw)


def _remake(tree, device, dtype=None):
    """Each fake leaf re-made on `device` (floating leaves as `dtype`)."""
    def one(t):
        dt = dtype if dtype is not None and t.is_floating_point() \
            else t.dtype
        return torch.empty(t.shape, dtype=dt, device=device)
    return tree_map(one, tree)


def abstract_params(cfg: ArchConfig, dtype=None, device=None):
    """(fake parameters, axes); dtype=bf16 for serving parameters."""
    device = device or fake_device()
    with fake_mode():
        p = init_model(cfg, torch.Generator().manual_seed(0))
        p = _remake(p, device, dtype)
    return p, param_axes(cfg)


def abstract_train_state(cfg: ArchConfig, device=None):
    """(params, opt_state) fake tensors + their axes trees."""
    p, pa = abstract_params(cfg, device=device)
    with fake_mode():
        o = adamw_init(p)
    return (p, o), (pa, {"mu": pa, "nu": pa, "count": ()})


def abstract_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                          opt: ModelOptions, device=None):
    device = device or fake_device()
    with fake_mode():
        s = init_decode_state(cfg, batch, max_len, opt, device=device)
    return s, decode_state_axes(cfg, batch, max_len, opt)


def input_specs(cfg: ArchConfig, shape: ShapeConfig, opt: ModelOptions,
                device=None):
    """Fake stand-ins for every input of the step function + their axes.

    train  : (params, opt_state, batch, step)
    prefill: (params_bf16, batch)
    decode : (params_bf16, state, tokens, pos)
    `step` is 0 and `pos` the cache's last row: Python ints, as the
    port's steps take them (axes ())."""
    device = device or fake_device()
    if shape.kind == "train":
        (p, o), (pa, oa) = abstract_train_state(cfg, device)
        batch, baxes = make_batch_specs(cfg, shape, device=device)
        return (p, o, batch, 0), (pa, oa, baxes, ())
    p, pa = abstract_params(cfg, dtype=torch.bfloat16, device=device)
    if shape.kind == "prefill":
        batch, baxes = make_batch_specs(cfg, shape, dtype=torch.bfloat16,
                                        device=device)
        return (p, batch), (pa, baxes)
    state, sa = abstract_decode_state(cfg, shape.global_batch,
                                      shape.seq_len, opt, device)
    with fake_mode():
        tokens = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                             device=device)
    return (p, state, tokens, shape.seq_len - 1), (pa, sa, ("batch", None),
                                                   ())


def shardings_for(args, axes, mesh):
    """Place each tensor of `args` on `mesh` by its logical axes: a tree of
    DTensors (Python ints stay as they are). With `mesh` None the args
    come back unchanged: the unsharded step."""
    if mesh is None:
        return args
    return mesh_rules.place(args, axes, mesh)
