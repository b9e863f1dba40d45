"""Process-group meshes — production, test, and data-parallel meshes.

PyTorch counterpart of ``repro.launch.mesh``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group: one rank per device, its axes named as the reference's (`pod`,
`data`, `model`, `stage`), each axis with its own process group for
the collectives that run over it. `init_distributed` starts the default
group (NCCL on the card, gloo on the CPU) from a ``file://`` rendezvous
— no network, no fixed port — and `shutdown_distributed` ends it.
`init_fake_distributed` starts a fake group of any world size in one
process, whose collectives move nothing: the dry run's counterpart of
the reference's 512 forced host devices.

Every mesh is built through `build_mesh` (one validation path). Nothing
here touches ``torch.distributed`` at import time.
"""
from __future__ import annotations

import math
import os
import tempfile

import torch

from repro_torch.device import fake_device, resolve_device


def init_distributed(device=None, init_method=None, rank: int = 0,
                     world_size: int = 1) -> torch.device:
    """Start the default process group for this rank and return the
    device it runs on: NCCL and the card (device `rank` modulo the
    cards there are) unless `device` is "cpu", then gloo. `init_method`
    is a ``file://`` path every rank names alike; a world of one may
    leave it out (a fresh file is made)."""
    import torch.distributed as dist
    device = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("the default process group is already started")
    if init_method is None:
        if world_size != 1:
            raise ValueError("a world of several ranks needs a shared "
                             "init_method (file://...)")
        init_method = "file://" + os.path.join(
            tempfile.mkdtemp(prefix="repro_torch_pg_"), "rendezvous")
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return device


def init_fake_distributed(world_size: int, rank: int = 0) -> None:
    """Start a fake default process group of `world_size` ranks, this
    process being `rank`: a mesh builds on it (its device type is
    ``device.fake_device()``) and every collective returns at once
    without moving data. End it with `shutdown_distributed`."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the default process group is already started")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def shutdown_distributed() -> None:
    """End the default process group (and every mesh built on it)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def build_mesh(shape, axes):
    """A DeviceMesh of `shape` named `axes` over the default group, whose
    world must hold exactly prod(shape) ranks — the ONE validation path
    every mesh constructor below routes through."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} disagree")
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "launch.mesh.init_distributed first")
    n = math.prod(shape)
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(f"need {n} ranks for mesh {shape}, have {world}; "
                           "start one process per device of the mesh")
    device_type = {"nccl": "cuda", "fake": fake_device()}.get(
        dist.get_backend(), "cpu")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def _factor_2d(n: int):
    """(data, model) factorization of an arbitrary device count: the
    model axis is the largest divisor of n that is <= sqrt(n) (capped at
    16, the historical pod column), data gets the rest. n=256 -> (16, 16),
    n=8 -> (4, 2), a prime n -> (n, 1)."""
    model = 1
    for d in range(1, min(int(math.isqrt(n)), 16) + 1):
        if n % d == 0:
            model = d
    return n // model, model


def make_production_mesh(*, multi_pod: bool = False, num_devices: int = None,
                         shape=None, axes=None):
    """Production training mesh.

    With no arguments: the historical fixed shapes — 16x16 (256
    chips/pod) single-pod or 2x16x16 (512 chips) multi-pod. An explicit
    `num_devices` builds a right-sized ("data", "model") mesh instead
    (factored via `_factor_2d`; `multi_pod` peels a leading pod=2 axis
    off an even count), and an explicit `shape`/`axes` pair overrides
    everything.
    """
    if shape is None:
        if num_devices is None:
            shape = (2, 16, 16) if multi_pod else (16, 16)
        elif multi_pod:
            if num_devices % 2:
                raise ValueError(
                    f"multi_pod needs an even device count, got "
                    f"{num_devices}")
            shape = (2,) + _factor_2d(num_devices // 2)
        else:
            shape = _factor_2d(num_devices)
    if axes is None:
        axes = (("pod", "data", "model") if len(shape) == 3
                else ("data", "model"))
    return build_mesh(shape, axes)


def make_test_mesh(shape=(2, 2), axes=("data", "model")):
    """Small mesh for unit tests — same validation path as production
    (`build_mesh`)."""
    return build_mesh(shape, axes)


def make_data_mesh(num_devices: int = None, axis: str = "data"):
    """1-axis data-parallel mesh over `num_devices` ranks (default: the
    whole world)."""
    import torch.distributed as dist
    if num_devices is None:
        num_devices = dist.get_world_size() if dist.is_initialized() else 1
    return build_mesh((num_devices,), (axis,))
