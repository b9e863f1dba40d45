"""Logical-axis -> mesh-axis sharding rules with divisibility fallback.

PyTorch counterpart of ``repro.runtime.mesh_rules``. Params and
activations are annotated with *logical* axis names; `logical_to_pspec`
maps them to a partition spec for a concrete mesh. A mesh axis is
dropped for a dimension whenever (a) it is absent from the mesh, (b) the
dim size is not divisible by the (remaining) mesh-axis product, or (c)
the axis was already consumed by an earlier dimension of the same
tensor; e.g. ``batch=1`` over ``data=16`` falls back to replication
instead of failing.

A spec is a tuple with one entry per leading dimension, trailing `None`s
trimmed: `None` (replicated), a mesh-axis name, or a tuple of names —
the entries of the reference's ``PartitionSpec``. A mesh is a
``torch.distributed`` ``DeviceMesh`` (read by its `mesh_dim_names` and
sizes, see ``launch.mesh``) or any object whose `.shape` is a
name -> size dict.

A sharding (`named_sharding`) is the mesh and one DTensor placement
per mesh axis: ``Shard(d)`` on each mesh axis that the spec names for
tensor dimension d, ``Replicate()`` on the others. A dimension named by
two mesh axes, e.g. ``("pod", "data")``, is ``Shard(d)`` on both, split
in mesh-axis order as the reference's spec splits it. The dry run
places its fake parameters, states and batches by these shardings and
lets DTensor's sharding propagation stand where the reference's GSPMD
partitioner stands.

`constrain` redistributes a DTensor activation as the reference's
constraint places it, and is the identity on a plain tensor.

Everywhere else placement in the port is done by explicit collectives
over the mesh's process groups (`axis_group`): the int8 pod all-gather
of the train step, GPipe's stage shift, expert parallelism's
all-to-all.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

# logical axis -> preferred mesh axes (in priority order; prefix-droppable)
DEFAULT_RULES = {
    # activations
    "batch": ("pod", "data"),
    "seq": (),                       # training activations: seq replicated
    "seq_sp": ("model",),            # Megatron-SP residuals
    "kv_seq": ("model",),            # decode KV cache: sequence-parallel
    "long_seq": ("data", "model"),   # long-context decode: shard seq harder
    # weights
    "fsdp": ("data",),               # ZeRO-3 style weight sharding over data
    "tensor": ("model",),            # tensor parallel dim
    "tensor_kv": ("model",),
    "experts": ("model",),           # expert parallel
    "vocab": ("model",),
    "layers": (),                    # stacked layer dim: never sharded
    None: (),
}


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or of a `.shape`-dict mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return dict(mesh.shape)


def axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


def axis_group(mesh, name: str):
    """The process group of this rank along mesh axis `name`."""
    return mesh.get_group(name)


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along mesh axis `name`."""
    return mesh.get_local_rank(name)


def logical_to_pspec(axes: Sequence[Optional[str]],
                     shape: Sequence[int],
                     mesh,
                     rules=None) -> tuple:
    """Map logical axes for a tensor of `shape` to a spec on `mesh`."""
    rules = rules or DEFAULT_RULES
    if len(axes) != len(shape):
        raise ValueError(f"axes {tuple(axes)} and shape {tuple(shape)} "
                         "disagree")
    sizes = mesh_shape(mesh)
    used: set = set()
    spec = []
    for dim, logical in zip(shape, axes):
        mesh_axes = rules.get(logical, ())
        # keep only axes present in this mesh and not already used
        cand = [a for a in mesh_axes if a in sizes and a not in used]
        # drop axes (from the right: least-preferred first) until divisible
        while cand and dim % math.prod(sizes[a] for a in cand) != 0:
            cand.pop()
        if not cand:
            spec.append(None)
        else:
            used.update(cand)
            spec.append(tuple(cand) if len(cand) > 1 else cand[0])
    # trim trailing Nones (canonical form)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


class NamedSharding(NamedTuple):
    """A tensor's sharding: the mesh, the spec (`logical_to_pspec`) and
    one DTensor placement per mesh axis, in the mesh's axis order."""
    mesh: object
    spec: tuple
    placements: tuple


def spec_placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of `spec` on `mesh`, one per mesh axis."""
    from torch.distributed.tensor import Replicate, Shard
    owner = {}
    for dim, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            owner[a] = dim
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in mesh_shape(mesh))


def named_sharding(axes, shape, mesh, rules=None) -> NamedSharding:
    spec = logical_to_pspec(axes, shape, mesh, rules)
    return NamedSharding(mesh, spec, spec_placements(spec, mesh))


def is_axes_leaf(x) -> bool:
    """A logical-axes leaf: a tuple of axis names or None (`()` for a
    scalar)."""
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def zip_axes(fn, axes_tree, tree):
    """fn(axes, leaf) over an axes tree and a tree of its structure."""
    if is_axes_leaf(axes_tree):
        return fn(axes_tree, tree)
    if isinstance(axes_tree, dict):
        return {k: zip_axes(fn, v, tree[k]) for k, v in axes_tree.items()}
    return type(axes_tree)(zip_axes(fn, a, t)
                           for a, t in zip(axes_tree, tree))


def tree_pspecs(axes_tree, shape_tree, mesh, rules=None):
    """Map a tree of logical-axes tuples + the matching tree of tensors
    (or anything with `.shape`) to a tree of specs."""
    return zip_axes(lambda ax, t: logical_to_pspec(ax, t.shape, mesh, rules),
                    axes_tree, shape_tree)


def tree_shardings(axes_tree, shape_tree, mesh, rules=None):
    """As `tree_pspecs`, to a tree of `NamedSharding`s."""
    return zip_axes(lambda ax, t: named_sharding(ax, t.shape, mesh, rules),
                    axes_tree, shape_tree)


def place(tree, axes_tree, mesh, rules=None):
    """Each tensor of `tree` (every rank holding the whole, fake or real)
    as a DTensor placed on `mesh` by its logical axes; each rank keeps
    its own shard and nothing is sent. Other leaves (Python ints) stay
    as they are."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    def one(ax, t):
        if not isinstance(t, torch.Tensor):
            return t
        sh = named_sharding(ax, t.shape, mesh, rules)
        return distribute_tensor(t, mesh, sh.placements, src_data_rank=None)

    return zip_axes(one, axes_tree, tree)


def is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor"


def outside_fake_mode():
    """A context that sets any active fake mode aside, for a DTensor API
    called directly (``local_map``, ``redistribute``): DTensor computes
    shard sizes and offsets on small host tensors, which must be real.
    Fake shards keep their own mode, so their ops stay fake."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    return unset_fake_temporarily()


def run_local(fn, tensors, rest):
    """`fn(*tensors, *rest)`. On DTensors `fn` runs on each rank's local
    shards under ``local_map``, the counterpart of the reference's
    ``shard_map``: the tensors are redistributed to the first one's
    placements and the result is a DTensor of those placements. Fake
    shards keep computing under their own fake mode, so the tensors `fn`
    makes are fake too."""
    if not is_dtensor(tensors[0]):
        return fn(*tensors, *rest)
    import contextlib

    from torch.distributed.tensor.experimental import local_map

    def body(*shards):
        mode = getattr(shards[0], "fake_mode", None)
        with mode if mode is not None else contextlib.nullcontext():
            return fn(*shards, *rest)

    placements = tuple(tensors[0].placements)
    with outside_fake_mode():
        return local_map(body, out_placements=(placements,),
                         in_placements=(placements,) * len(tensors),
                         device_mesh=tensors[0].device_mesh,
                         redistribute_inputs=True)(*tensors)


_ACTIVE_MESH: list = []  # stack managed by use_mesh()


class use_mesh:
    """Context manager: make `mesh` the framework's active mesh, which
    the train step's pod sync and ``models.moe.moe_ep`` read."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        _ACTIVE_MESH.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        _ACTIVE_MESH.pop()
        return False


def active_mesh():
    return _ACTIVE_MESH[-1] if _ACTIVE_MESH else None


_RULE_OVERRIDES: list = []


class rule_override:
    """Temporarily override logical->mesh rules (e.g. the compressed-DP
    path maps "batch" to data only: the pod axis is handled explicitly
    there)."""

    def __init__(self, updates: dict):
        self.updates = updates

    def __enter__(self):
        merged = dict(_RULE_OVERRIDES[-1] if _RULE_OVERRIDES
                      else DEFAULT_RULES)
        merged.update(self.updates)
        _RULE_OVERRIDES.append(merged)
        return merged

    def __exit__(self, *exc):
        _RULE_OVERRIDES.pop()
        return False


def current_rules():
    return _RULE_OVERRIDES[-1] if _RULE_OVERRIDES else DEFAULT_RULES


def constrain(x, axes, rules=None):
    """The reference's sharding constraint. On a DTensor (the dry run,
    or a step run on DTensors) `x` is redistributed to the placements
    its logical axes give on its own mesh — DTensor's counterpart of
    ``with_sharding_constraint``; on a plain tensor it is the identity,
    so model code runs unchanged with or without a mesh."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    want = named_sharding(axes, x.shape, mesh,
                          rules or current_rules()).placements
    if tuple(x.placements) == want:
        return x
    with outside_fake_mode():
        return x.redistribute(mesh, want)


def dp_axis_names(mesh) -> Tuple[str, ...]:
    """Mesh axes that carry data parallelism (gradient reduction axes)."""
    sizes = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def num_chips(mesh) -> int:
    return int(math.prod(mesh_shape(mesh).values()))
