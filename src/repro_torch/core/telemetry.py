"""Telemetry plane configuration.

PyTorch counterpart of ``repro.core.telemetry``. Only the off level is
ported: `init_state` returns None, so a store built with telemetry off
carries no instrument state and does no telemetry work. The histogram,
series ring and trace levels raise until they are ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# the level lattice, in order: each level includes everything below it
LEVELS = ("off", "counters", "histogram", "trace")


@dataclass(frozen=True)
class TelemetryConfig:
    """STATIC observability axis. `lat_lo`/`lat_hi` bound the histogram's
    log-spaced bin range in the caller's latency unit."""
    level: str = "off"
    bins: int = 64                # histogram bins (log-spaced)
    lat_lo: float = 1.0           # lower edge of bin 0 (> 0)
    lat_hi: float = 1e8           # upper edge of the last bin
    series_cap: int = 128         # ring capacity (rows kept)
    series_every: int = 1         # sample every k steps

    def __post_init__(self):
        if self.level not in LEVELS:
            raise ValueError(f"level must be one of {LEVELS}, "
                             f"got {self.level!r}")
        if self.bins < 2:
            raise ValueError(f"bins must be >= 2, got {self.bins}")
        if not (0.0 < self.lat_lo < self.lat_hi):
            raise ValueError(f"need 0 < lat_lo < lat_hi, got "
                             f"({self.lat_lo}, {self.lat_hi})")
        if self.series_cap < 1 or self.series_every < 1:
            raise ValueError("series_cap and series_every must be >= 1")

    @property
    def enabled(self) -> bool:
        return self.level != "off"


def init_state(cfg: Optional[TelemetryConfig], channels: int) -> None:
    """None when telemetry is off; the instrumented levels are not
    ported yet and raise."""
    if cfg is None or not cfg.enabled:
        return None
    raise NotImplementedError(
        f"telemetry level {cfg.level!r} is not ported to repro_torch yet "
        "(only 'off')")
