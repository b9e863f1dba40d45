"""Step-time fault handling of the train loop (paper §4.6, framework
plane).

Copied from ``repro.runtime.fault`` (pure Python): `StepWatchdog` bounds
per-step wall time, `StragglerDetector` flags persistent outliers
against a robust step-time median, `LinkHealthMonitor` watches the
fabric's per-module link health during paged serving, and
`run_with_restarts` rebuilds the state, restores the latest checkpoint
of a ``checkpoint.CheckpointManager`` and resumes after a failure. It
drops every reference to a failed attempt's state and empties the CUDA
cache before it rebuilds: at full width two attempts' states do not fit
on one card together.
"""
from __future__ import annotations

import gc
import logging
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch

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


@dataclass
class LinkHealthMonitor:
    """Per-module link watchdog over the fabric's health masks.

    `observe(health)` takes the (M,) health vector `fabric.module_health`
    samples at a decode step and returns the module ids for which a
    reshard/re-placement is advised (route their pages elsewhere, shrink
    the module set — the serving analogue of evicting a straggler host).

    Two triggers, per module:
      * relative — the module's inverse health rides its own
        `StragglerDetector`, so a link that collapses vs its own recent
        median is flagged by exactly the straggler machinery (factor x
        median over a rolling window, `patience` consecutive strikes);
      * absolute — health below `floor` for `patience` consecutive
        observations (hard failures flag without a 10-step history).

    Once flagged, a module stays flagged until its health recovers above
    `floor` (`flagged` property lists the currently-advised set).
    `observe` returns — and logs — only flag *transitions*, so a module
    that stays degraded for hundreds of decode steps is advised once,
    not once per step.
    """
    floor: float = 0.5
    factor: float = 3.0
    patience: int = 3
    window: int = 50
    _detectors: dict = field(default_factory=dict)
    _floor_strikes: dict = field(default_factory=dict)
    _flagged: set = field(default_factory=set)

    def observe(self, health) -> List[int]:
        advised = []
        for m, h in enumerate(health):
            h = float(h)
            det = self._detectors.setdefault(
                m, StragglerDetector(factor=self.factor,
                                     patience=self.patience,
                                     window=self.window))
            relative = det.observe(1.0 / max(h, 1e-6))
            if h < self.floor:
                self._floor_strikes[m] = self._floor_strikes.get(m, 0) + 1
            else:
                self._floor_strikes[m] = 0
            if relative or self._floor_strikes.get(m, 0) >= self.patience:
                if m not in self._flagged:
                    self._flagged.add(m)
                    advised.append(m)
                    log.warning("link health: module %d degraded "
                                "(health=%.3f) — reshard advised", m, h)
            elif h >= self.floor:
                # recovered above the floor with no active relative
                # strike: clear the advisory (flags latch while degraded)
                self._flagged.discard(m)
        return advised

    @property
    def flagged(self) -> List[int]:
        return sorted(self._flagged)


def run_with_restarts(make_state: Callable[[], tuple],
                      run_from: Callable[[object, int], None],
                      ckpt_mgr,
                      max_failures: int = 3,
                      fault_hook: Optional[Callable[[int], None]] = None):
    """Restart loop: (re)build state, restore latest checkpoint, run.

    `make_state()` -> (template_state, start_step);
    `run_from(state, step)` runs until completion or raises.
    `fault_hook(attempt)` lets tests inject failures deterministically.
    Returns the number of restarts consumed.
    """
    failures = 0
    while True:
        state, start = make_state()
        restored, step, _ = ckpt_mgr.restore(state)
        if restored is not None:
            state = restored            # the template's memory goes now
        del restored
        step = step if step is not None else start
        try:
            if fault_hook is not None:
                fault_hook(failures)
            run_from(state, step)
            return failures
        except Exception as e:  # noqa: BLE001 — restart-able by design
            failures += 1
            log.warning("failure %d/%d at step >=%s: %r", failures,
                        max_failures, step, e)
            if failures > max_failures:
                raise
        del state
        gc.collect()                    # the failed attempt's frames
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()
