"""Step-time fault handling of the train loop (paper §4.6, framework
plane).

Copied from ``repro.runtime.fault`` (pure Python): `StepWatchdog` bounds
per-step wall time and `StragglerDetector` flags persistent outliers
against a robust step-time median. The restart loop and the fabric's
`LinkHealthMonitor` are not ported yet.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import List, Optional

log = logging.getLogger("repro_torch.fault")


class StepTimeout(RuntimeError):
    pass


@dataclass
class StepWatchdog:
    deadline_s: float = 600.0

    def check(self, step_seconds: float, step: int):
        if step_seconds > self.deadline_s:
            raise StepTimeout(
                f"step {step} took {step_seconds:.1f}s > "
                f"{self.deadline_s:.1f}s deadline")


@dataclass
class StragglerDetector:
    """Robust step-time tracker: flags persistent k x median outliers."""
    factor: float = 3.0
    patience: int = 3
    window: int = 50
    _times: List[float] = field(default_factory=list)
    _strikes: int = 0

    def observe(self, step_seconds: float) -> bool:
        """Returns True when a re-shard/restart is advised."""
        self._times.append(step_seconds)
        self._times = self._times[-self.window:]
        if len(self._times) < 10:
            return False
        med = sorted(self._times)[len(self._times) // 2]
        if step_seconds > self.factor * med:
            self._strikes += 1
        else:
            self._strikes = 0
        if self._strikes >= self.patience:
            log.warning("straggler: %d consecutive steps > %.1fx median",
                        self._strikes, self.factor)
            return True
        return False

    @property
    def median(self) -> Optional[float]:
        if not self._times:
            return None
        return sorted(self._times)[len(self._times) // 2]
