"""The port's plain kernel versions against the reference's.

`fused_residency_step` on the `_rand_case` snapshots of
tests/test_residency_fused.py (plus three more geometries) under every
policy, the same-set overflow case, and `paged_gather` / `paged_scatter`
including clamped and dropped indices. Everything must be equal. The
CUDA kernels are held to these plain versions on the card by
chip_smoke.py; `test_kernels_match_plain_on_card` repeats that here when
a card is present."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import residency as JR
from repro.kernels import ref as JK
from repro_torch.core import residency as TR
from repro_torch.kernels import ops
from repro_torch.kernels import ref as TK

from test_residency_fused import _rand_case

torch.set_num_threads(1)

POLICY_NAMES = ("lru", "fifo", "rrip", "dirty-averse")
OUT_NAMES = ("res.page", "res.age", "res.ready", "res.dirty", "res.rrpv",
             "kpool", "vpool", "evicted", "n_ev", "k_local", "v_local",
             "hit")
CASES = [dict(), dict(s=1, w=12), dict(s=4, w=3), dict(s=16, w=4, p=9)]


def _to_torch(args):
    res, *rest = args
    t_res = TR.ResidencyState(*(torch.from_numpy(np.array(x)) for x in res))
    return (t_res,) + tuple(torch.from_numpy(np.array(x)) for x in rest)


def _flat(out):
    return list(out[0]) + list(out[1:])


def _assert_same(ref_out, port_out):
    for name, a, b in zip(OUT_NAMES, _flat(ref_out), _flat(port_out)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=name)


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("pol_name", POLICY_NAMES)
def test_fused_residency_step_matches_reference(case, pol_name):
    for seed in (0, 1, 2):
        args = _rand_case(seed, **CASES[case])
        ref = JK.fused_residency_step(*args, JR.as_policy(pol_name))
        port = TK.fused_residency_step(*_to_torch(args),
                                       TR.as_policy(pol_name))
        _assert_same(ref, port)


@pytest.mark.parametrize("pol_name", POLICY_NAMES)
def test_fused_same_set_overflow_drops(pol_name):
    s, w, p, pr = 2, 2, 6, 32
    row = (2, 1, 4)
    rng = np.random.default_rng(0)
    res = jax.tree.map(lambda x: x[None], JR.init_residency(s, w))
    rk = rng.standard_normal((pr,) + row).astype(np.float32)
    args = (res, np.zeros((1, s * w) + row, np.float32),
            np.zeros((1, s * w) + row, np.float32), rk, rk,
            np.ones((1, p), bool),
            np.array([[0, 2, 4, 6, 8, 10]], np.int32),
            np.array([[0, 2, 4]], np.int32), np.zeros((1, 3), bool),
            np.float32(1.0))
    ref = JK.fused_residency_step(*(jnp.asarray(a) if i else a
                                    for i, a in enumerate(args)),
                                  JR.as_policy(pol_name))
    port = TK.fused_residency_step(*_to_torch(args),
                                   TR.as_policy(pol_name))
    _assert_same(ref, port)
    assert set(port[0].page[0, 0].tolist()) == {0, 2}
    assert port[7].tolist() == [[True, True, False]]


def test_paged_gather_clamps_and_masks():
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((8, 2, 1, 4)).astype(np.float32)
    idx = np.array([3, -2, 7, 11, 0], np.int32)
    ref = JK.paged_gather(jnp.asarray(pool), jnp.asarray(idx))
    got = ops.paged_gather(torch.from_numpy(pool), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    mask = np.array([True, False, True, True, False])
    got = ops.paged_gather(torch.from_numpy(pool), torch.from_numpy(idx),
                           torch.from_numpy(mask))
    want = np.where(mask[:, None, None, None], np.asarray(ref), 0.0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_paged_scatter_drop_never_clobbers():
    rng = np.random.default_rng(1)
    pool = rng.standard_normal((6, 3)).astype(np.float32)
    pages = rng.standard_normal((5, 3)).astype(np.float32)
    idx = np.array([6, 2, -1, 4, -9], np.int32)      # lanes 0, 4 dropped
    ref = JK.paged_scatter(jnp.asarray(pool), jnp.asarray(idx),
                           jnp.asarray(pages), mode="drop")
    got = ops.paged_scatter(torch.from_numpy(pool.copy()),
                            torch.from_numpy(idx), torch.from_numpy(pages),
                            mode="drop")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    none_live = np.array([-7, 9], np.int32)
    got = ops.paged_scatter(torch.from_numpy(pool.copy()),
                            torch.from_numpy(none_live),
                            torch.from_numpy(pages[:2]), mode="drop")
    np.testing.assert_array_equal(got.numpy(), pool)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Both CUDA kernels equal their plain versions bit for bit (the
    same comparison chip_smoke.py makes at the serving shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check "
                    "on the card")
    dev = torch.device("cuda")
    for pol_name in POLICY_NAMES:
        args = _to_torch(_rand_case(5, s=16, w=4, p=9, row=(4, 1, 8)))
        args = tuple(a.to(dev) if isinstance(a, torch.Tensor) else
                     TR.ResidencyState(*(x.to(dev) for x in a))
                     for a in args)
        pol = TR.as_policy(pol_name, device=dev)
        clone = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                      for a in args)
        ref = ops.residency_fused(*clone, pol, impl="ref")
        got = ops.residency_fused(*args, pol, impl="cuda")
        for name, a, b in zip(OUT_NAMES, _flat(ref), _flat(got)):
            assert torch.equal(a, b), name
    pool = torch.randn(64, 16, 8, 128, device=dev).to(torch.bfloat16)
    idx = torch.randint(-3, 70, (32,), device=dev, dtype=torch.int32)
    assert torch.equal(ops.paged_gather(pool, idx, impl="cuda"),
                       ops.paged_gather(pool, idx, impl="ref"))
