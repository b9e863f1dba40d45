"""Checkpoint manager: atomic, manifest-driven, readable by both packages.

PyTorch counterpart of ``repro.checkpoint.manager``, with the same
format on disk, so either package restores what the other wrote:

  * atomicity — a step is written to `step_N.tmp/` and renamed to
    `step_N/` with `os.replace`; a crash mid-save leaves the latest
    complete checkpoint as it was, and `.tmp` debris is never listed;
  * manifest  — `manifest.json` holds `step`, `extra` and, per leaf, its
    `name`, `shape` and `dtype`; each leaf is one `.npy` file named by
    its path in the tree (dict keys and list indices joined by `_`),
    leaves listed in the reference's order (dict keys sorted);
  * bfloat16  — written byte for byte as numpy writes the reference's
    ``ml_dtypes`` arrays (a `<V2` descriptor), and read back through a
    16-bit integer view, keyed by the manifest's dtype (no ``ml_dtypes``
    needed);
  * async     — `save` copies every leaf to host memory before it
    returns (the optimizer then updates the device state in place
    without touching the checkpoint); a worker thread writes the files;
  * retention — the newest `keep` checkpoints stay.

`restore` matches leaves by name, never by position, and puts each on
its template leaf's device unless `device` says otherwise.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

BF16 = "bfloat16"
_BF16_DESCR = "<V2"       # numpy's .npy descriptor of an ml_dtypes bfloat16


@dataclass(frozen=True)
class CheckpointConfig:
    directory: str
    keep: int = 3
    async_save: bool = True


def _map_named(fn, tree, path=()):
    """`tree` with each leaf replaced by fn(name, leaf); dicts, lists and
    tuples are the nodes, None an empty node."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn("_".join(str(p) for p in path), tree)


def _leaf_paths(tree, path=()):
    """[(name, leaf)] in the reference's flattening order: dict keys
    sorted, sequence entries by index."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaf_paths(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaf_paths(v, path + (i,))]
    return [("_".join(str(p) for p in path), tree)]


def _to_host(leaf: torch.Tensor):
    """(numpy array as it goes on disk, manifest dtype) of a tensor,
    copied off the device (cloned on the CPU) before this returns."""
    host = leaf.detach().to("cpu", copy=True).contiguous()
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy(), BF16
    arr = host.numpy()
    return arr, str(arr.dtype)


def _save(path: Path, arr: np.ndarray, dtype: str) -> None:
    """`np.save`, with a bf16 leaf's 16-bit words under the descriptor
    numpy gives an ``ml_dtypes`` bfloat16 array."""
    if dtype != BF16:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        arr.tofile(f)


def _from_disk(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        self.dir = Path(cfg.directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------- save
    def save(self, step: int, state, extra: dict = None) -> None:
        """state: tree of tensors. Blocks for the copies to host memory
        only; the files are written on the worker thread when
        `async_save`."""
        host = [(name,) + _to_host(leaf)
                for name, leaf in _leaf_paths(state)]
        if self._pending is not None:
            self._pending.result()  # one in flight at a time
        if self.cfg.async_save:
            self._pending = self._pool.submit(self._write, step, host,
                                              extra or {})
        else:
            self._write(step, host, extra or {})

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _write(self, step: int, host, extra: dict):
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        manifest = {"step": step, "extra": extra, "leaves": []}
        for name, arr, dtype in host:
            _save(tmp / f"{name}.npy", arr, dtype)
            manifest["leaves"].append(
                {"name": name, "shape": list(arr.shape), "dtype": dtype})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        with self._lock:
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: max(0, len(steps) - self.cfg.keep)]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None, device=None):
        """Restore into the structure of `template`, each leaf loaded by
        its name, in the dtype it was saved in, on `device` or else on
        its template leaf's device. Returns (state, step, extra), or
        (None, None, None) when there is no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None, None
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        dtypes = {leaf["name"]: leaf["dtype"] for leaf in manifest["leaves"]}

        def load(name, leaf):
            t = _from_disk(np.load(d / f"{name}.npy"), dtypes[name])
            return t.to(device if device is not None else leaf.device)

        return _map_named(load, template), step, manifest.get("extra", {})
