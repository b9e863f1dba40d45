"""Where the port runs: on the card unless the caller asks for the CPU;
and the fake tensors of the dry run, which run nowhere."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA device when None. Raises when None is given
    on a host without CUDA: an entry point never falls back to the CPU
    on its own; callers that want the CPU say device="cpu"."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: repro_torch runs on the card "
                           "by default; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def fake_device() -> str:
    """The device type of the dry run's fake tensors: "cuda" where torch
    is built with CUDA, else "cpu" (autograd over fake CUDA tensors needs
    CUDA's device guard, which a CPU-only build lacks). The port's ops
    take the same route on either: the int8 kernels are custom ops on
    every device."""
    return "cuda" if torch.cuda.is_available() else "cpu"


_FAKE_MODE = []


def fake_mode():
    """The active ``FakeTensorMode``, else this process's one: tensors
    made under it have shapes, types and devices but no memory (the dry
    run's counterpart of the reference's ``jax.eval_shape``); fake
    tensors of two modes cannot meet in one op, hence one mode."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    active = detect_fake_mode()
    if active is not None:
        return active
    if not _FAKE_MODE:
        _FAKE_MODE.append(FakeTensorMode(allow_non_fake_inputs=True))
    return _FAKE_MODE[0]
