"""Architecture registry of the port: ``get_config(name)`` over the
reference's ten configs — dense (qwen3-1.7b, qwen3-8b, yi-9b,
minitron-4b), MoE (olmoe-1b-7b, qwen3-moe-30b-a3b), the Mamba2 hybrid
(zamba2-2.7b), xLSTM (xlstm-125m), audio encoder-decoder (whisper-base)
and vision-language (internvl2-26b) — ``get_shape(name)``, and the
dry run's 40 (arch, shape) cells, ``dryrun_cells()``."""
from __future__ import annotations

from repro_torch.configs import (internvl2_26b, minitron_4b, olmoe_1b_7b,
                                 qwen3_1p7b, qwen3_8b, qwen3_moe_30b_a3b,
                                 whisper_base, xlstm_125m, yi_9b,
                                 zamba2_2p7b)
from repro_torch.configs.base import (SHAPES, SMOKE_SHAPES, ArchConfig,
                                      ShapeConfig)

_REGISTRY = {m.CONFIG.name: m.CONFIG for m in (
    yi_9b, qwen3_8b, minitron_4b, qwen3_1p7b, olmoe_1b_7b,
    qwen3_moe_30b_a3b, whisper_base, xlstm_125m, zamba2_2p7b, internvl2_26b,
)}


def get_config(name: str) -> ArchConfig:
    if name.endswith("-reduced"):
        return get_config(name[: -len("-reduced")]).reduced()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs():
    return sorted(_REGISTRY)


def get_shape(name: str) -> ShapeConfig:
    if name in SHAPES:
        return SHAPES[name]
    if name in SMOKE_SHAPES:
        return SMOKE_SHAPES[name]
    raise KeyError(f"unknown shape {name!r}")


def dryrun_cells():
    """All (arch, shape) cells with skip annotations -> list of dicts."""
    cells = []
    for arch_name in list_archs():
        cfg = get_config(arch_name)
        for shape_name, shape in SHAPES.items():
            ok, reason = cfg.shape_supported(shape)
            cells.append({"arch": arch_name, "shape": shape_name,
                          "run": ok, "skip_reason": reason})
    return cells
