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

Placement in the port is done by explicit collectives over the mesh's
process groups (`axis_group`): the int8 pod all-gather of the train
step, GPipe's stage shift, expert parallelism's all-to-all. There is no
partitioner to hand a constraint to, so `constrain` is the identity.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

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
    """The identity. The reference hands a sharding constraint to its
    partitioner here; the port has none, and moves data between ranks
    only by the explicit collectives named in the module docstring, so
    model code written with `constrain` runs unchanged with or without a
    mesh."""
    return x


def dp_axis_names(mesh) -> Tuple[str, ...]:
    """Mesh axes that carry data parallelism (gradient reduction axes)."""
    sizes = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def num_chips(mesh) -> int:
    return int(math.prod(mesh_shape(mesh).values()))
