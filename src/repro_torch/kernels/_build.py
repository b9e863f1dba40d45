"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, and loaded with ``ctypes``.
Libraries go to ``build/repro_torch/`` at the repository root, named by a
hash of the source and the flags, so the first use after a change builds
and every later use loads. `build_all` starts one ``nvcc`` per source,
all at once. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the repro_torch CUDA kernels "
                           "are built on a machine with the CUDA toolkit")
    return path


def _lib_path(source: str) -> Path:
    text = (CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}_{digest}.so"


class CudaKernel:
    """One CUDA source, its C launch function, and a launch counter.

    `launches` counts the calls of `launch`, the only place the kernel is
    launched; a caller may reset it to 0."""

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_log = ""
        self._lib = None

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            build_all([self])
        return self._lib

    def _load(self, path: Path):
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._lib = lib

    def launch(self, *args):
        """Call the C launcher on the current stream; raise if CUDA
        reports an error."""
        fn = getattr(self.lib(), self.symbol)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
        self.launches += 1
        if err != 0:
            raise RuntimeError(f"{self.symbol} failed: CUDA error {err}")


def build_all(kernels) -> float:
    """Build every missing library of `kernels` in parallel, load them,
    and return the seconds spent building."""
    if not torch.cuda.is_available():
        raise RuntimeError("the repro_torch CUDA kernels need a CUDA device")
    t0 = time.perf_counter()
    pending = {}                       # one nvcc per source, not per symbol
    for k in kernels:
        path = _lib_path(k.source)
        if path.exists() or k.source in pending:
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / k.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending[k.source] = (path, tmp, proc)
    logs = {}
    for source, (path, tmp, proc) in pending.items():
        out, _ = proc.communicate()
        logs[source] = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{out}")
        os.replace(tmp, path)
    for k in kernels:
        k.build_log = logs.get(k.source, k.build_log)
    for k in kernels:
        if k._lib is None:
            k._load(_lib_path(k.source))
    return time.perf_counter() - t0


def check_cuda(name: str, t: torch.Tensor, dtype=None):
    """Raise unless `t` is a contiguous CUDA tensor (of `dtype`)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")


def row_bytes(t: torch.Tensor, lead: int) -> int:
    """Bytes of one row after the first `lead` axes; raise unless the
    kernels' 16-byte vector copies can move it."""
    nbytes = t.element_size()
    for d in t.shape[lead:]:
        nbytes *= d
    if nbytes % 16 or t.data_ptr() % 16:
        raise ValueError(f"rows of {tuple(t.shape)} {t.dtype} are not "
                         "16-byte multiples at a 16-byte-aligned address")
    return nbytes


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())
