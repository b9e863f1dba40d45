import os
import sys
from pathlib import Path

# NOTE: no XLA_FLAGS here on purpose — smoke tests must see 1 CPU device.
# Multi-device tests run via subprocess (tests/test_distributed.py).
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import jax  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def pytest_configure(config):
    # `heavycompile` marks tests whose XLA compiles are full model
    # programs (all of tests/test_system.py). After a long
    # single-process run, any such compile can crash XLA outright
    # (SIGSEGV in backend_compile) on memory-constrained hosts — the
    # tests themselves pass in a fresh interpreter. CI therefore runs
    # the suite as two invocations:
    #   pytest -m "not heavycompile"   # everything else
    #   pytest -m heavycompile         # fresh process for big compiles
    # A plain local `pytest` still collects everything (and can still
    # hit the crash on this kind of host — use the split form there).
    config.addinivalue_line(
        "markers",
        "heavycompile: whole-model-XLA-compile tests; CI runs these in "
        "their own pytest process (see comment above)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the repro_torch kernels); skips "
        "without one")
