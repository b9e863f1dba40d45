"""Architecture registry of the port: ``get_config(name)`` over the
configs ported so far (qwen3-1.7b), and ``get_shape(name)``."""
from __future__ import annotations

from repro_torch.configs import qwen3_1p7b
from repro_torch.configs.base import (SHAPES, SMOKE_SHAPES, ArchConfig,
                                      ShapeConfig)

_REGISTRY = {m.CONFIG.name: m.CONFIG for m in (qwen3_1p7b,)}


def get_config(name: str) -> ArchConfig:
    if name.endswith("-reduced"):
        return get_config(name[: -len("-reduced")]).reduced()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs():
    return sorted(_REGISTRY)


def get_shape(name: str) -> ShapeConfig:
    if name in SHAPES:
        return SHAPES[name]
    if name in SMOKE_SHAPES:
        return SMOKE_SHAPES[name]
    raise KeyError(f"unknown shape {name!r}")
