"""Package rules of the port: it never imports JAX or the reference
package, its entry points run on the card unless told otherwise, and its
kernel wrappers never fall back to the plain versions."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, get_shape
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.launch import train as launch_train
from repro_torch.core import residency
from repro_torch.core.daemon_store import KVStoreConfig, init_kv_store_batch
from repro_torch.kernels import _build, ops
from repro_torch.kernels import paged_gather as pg_kernel
from repro_torch.kernels import residency_fused as rf_kernel
from repro_torch.runtime.serve_loop import ServeConfig, serve_batch_paged

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def test_sources_import_no_jax_and_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        assert not FORBIDDEN.search(path.read_text()), path


def test_import_without_jax():
    """Every module imports with `jax` made unimportable, and no module
    of the reference package gets loaded."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None\n"
        "       and (m in ('repro', 'jax') or m.startswith('repro.')\n"
        "            or m.startswith('jax.'))]\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 38
    for mod in ("optim.adamw", "optim.schedule", "data.pipeline",
                "launch.train", "runtime.train_loop", "runtime.fault",
                "core.compression", "kernels.qdq_int8", "kernels.bdi"):
        assert f"repro_torch.{mod}" in names, mod


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")


def test_entry_points_default_to_the_card():
    _no_cuda()
    cfg = KVStoreConfig(num_local_pages=4, page_tokens=2, kv_heads=1,
                        head_dim=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_kv_store_batch(cfg, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_batch_paged({}, get_config("qwen3-1.7b").reduced(),
                          torch.zeros((1, 2), dtype=torch.int32),
                          ServeConfig(max_new_tokens=1), cfg)
    reduced = get_config("qwen3-1.7b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic_batch(reduced, get_shape("smoke_train"), DataConfig(), 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--reduced", "--steps", "1"])


def test_kernel_wrappers_never_fall_back():
    pool = torch.zeros((4, 2, 1, 8))
    idx = torch.zeros((3,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pg_kernel.paged_gather(pool, idx)
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_gather(pool, idx, impl="cuda")
    res = residency.ResidencyState(*(t[None] for t in
                                     residency.init_residency(2, 2)))
    args = (res, torch.zeros((1, 4, 2, 1, 8)), torch.zeros((1, 4, 2, 1, 8)),
            pool, pool, torch.zeros((1, 3), dtype=torch.bool),
            torch.full((1, 3), -1, dtype=torch.int32),
            torch.zeros((1, 2), dtype=torch.int32),
            torch.zeros((1, 2), dtype=torch.bool), torch.tensor(1.0),
            residency.as_policy("lru"))
    with pytest.raises(ValueError, match="CUDA"):
        rf_kernel.fused_residency_step(*args)
    with pytest.raises(ValueError, match="CUDA"):
        ops.residency_fused(*args, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ops.paged_gather(pool, idx, impl="pallas")
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        _build.build_all([pg_kernel.KERNEL, rf_kernel.KERNEL])
    assert pg_kernel.KERNEL.launches == 0
    assert rf_kernel.KERNEL.launches == 0
