"""The port's simulator against the seed golden capture.

`tests/golden/seed_movement_golden.json` holds 9 schemes x 3 networks x
{pr, dr} at r = 6000, captured from the seed code; it is read as
tests/test_movement_plane.py:49-65 reads it, rtol 1e-5, atol 1e-6. One
lattice per workload, on the CPU. (Kept apart from
tests/test_torch_sim.py so a test runner that splits work by file can put
the two long lattices beside the rest.)"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.params import NetworkParams
from repro_torch.sim import (SCHEMES, WORKLOADS, SimConfig, generate_trace,
                             make_net, simulate_lattice)

torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden" / "seed_movement_golden.json"


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


@pytest.mark.parametrize("wl", ("pr", "dr"))
def test_lattice_matches_seed_golden(golden, wl):
    rec = golden["workloads"][wl]
    names = golden["schemes"]
    tr = generate_trace(WORKLOADS[wl], golden["r"], seed=rec["seed"])
    nets = [make_net(NetworkParams(bw_factor=bf, switch_latency_ns=sw))
            for sw, bf in golden["net_pairs"]]
    res = simulate_lattice([SCHEMES[s] for s in names], SimConfig(), tr,
                           nets, rec["comp_ratio"], device="cpu")
    for i, s in enumerate(names):
        for j in range(len(nets)):
            assert set(res[i][j]) == set(rec["schemes"][s][j])
            for key, new in res[i][j].items():
                old = rec["schemes"][s][j][key]
                np.testing.assert_allclose(
                    new, old, rtol=1e-5, atol=1e-6,
                    err_msg=f"{wl}/{s}/net{j}/{key}")
