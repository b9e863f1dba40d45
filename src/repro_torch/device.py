"""Where the port runs: on the card unless the caller asks for the CPU."""
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
