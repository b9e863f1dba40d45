"""The port's runnable examples on the CPU (`--device cpu`): quickstart's
loss falls and it decodes; serve_paged's DaeMon store moves fewer wire
bytes than the Remote-style one, as the reference's tests/test_system.py
holds its store, and its Perfetto trace is written where it is told;
train_100m resumes from its checkpoint directory."""
import json

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.examples import quickstart, serve_paged, train_100m

torch.set_num_threads(1)


def test_quickstart_trains_and_decodes():
    out = quickstart.main(["--device", "cpu", "--steps", "4"])
    losses = out["losses"]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert out["tokens"].shape == (1, 4 + 8)


def test_serve_paged_daemon_moves_fewer_bytes(tmp_path):
    trace = tmp_path / "TRACE_tenants.json"
    out = serve_paged.main(["--device", "cpu", "--steps", "40",
                            "--trace-out", str(trace)])
    assert out["daemon"]["wire_bytes"] < out["remote"]["wire_bytes"]
    assert out["daemon"]["local_hits"] > 0
    assert 0 < out["saving"] < 1
    doc = json.loads(trace.read_text())
    assert doc["traceEvents"]
    assert out["tenants"]["wire_bytes"] > 0
    assert out["replicated"]["requests"] > 0


def test_train_100m_resumes(tmp_path, monkeypatch):
    tiny = ArchConfig(name="tiny", family="dense", num_layers=2, d_model=64,
                      num_heads=2, num_kv_heads=2, head_dim=32, d_ff=128,
                      vocab_size=512, dtype="float32")
    monkeypatch.setattr(train_100m, "make_cfg", lambda full: tiny)
    argv = ["--device", "cpu", "--seq", "32", "--batch", "2",
            "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)]
    first = train_100m.main(argv + ["--steps", "4"])
    assert first["start"] == 0 and np.isfinite(first["loss"])
    again = train_100m.main(argv + ["--steps", "6"])
    assert again["start"] == 4
