"""Architecture registry of the port: ``get_config(name)`` over the
configs ported so far (qwen3-1.7b)."""
from __future__ import annotations

from repro_torch.configs import qwen3_1p7b
from repro_torch.configs.base import ArchConfig

_REGISTRY = {m.CONFIG.name: m.CONFIG for m in (qwen3_1p7b,)}


def get_config(name: str) -> ArchConfig:
    if name.endswith("-reduced"):
        return get_config(name[: -len("-reduced")]).reduced()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs():
    return sorted(_REGISTRY)
