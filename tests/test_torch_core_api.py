"""The port's `repro_torch.core` package exports against `repro.core`'s,
driven through the package as the reference's library boundary is: the
export list name for name, the scalar channel API
(`bandwidth.Channel` / `PartitionedLink`) and the §4.3 dirty unit
(`engine.note_dirty_eviction`) on the reference's own cases of
tests/test_daemon_core.py:105-141, and the paged-decode oracle
`kernels.ref.decode_attention_paged` on the case of
tests/test_kernels.py:126-144.

Channel clocks and dirty-unit states must be equal (the same f32
operations in the same order; the reference runs eagerly); the
attention oracle agrees within rtol = atol = 2e-5, the reference test's
own tolerance (f32 sums in another order)."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core import bandwidth as JB
from repro.kernels import ref as JREF
from repro_torch import convert
from repro_torch.core import bandwidth as TB
from repro_torch.kernels import ref as TREF

torch.set_num_threads(1)


def test_core_exports_every_reference_name():
    names = {n for n, v in vars(J).items() if not n.startswith("_")
             and not isinstance(v, types.ModuleType)}
    assert len(names) > 60
    missing = sorted(n for n in names if not hasattr(T, n))
    assert not missing, missing
    assert not any(isinstance(getattr(T, n), types.ModuleType)
                   for n in names)


@pytest.mark.parametrize("ratio,n", [(0.05, 1), (0.25, 7), (0.5, 30),
                                     (0.8, 13), (0.95, 60)])
def test_partitioned_link_matches_reference(ratio, n):
    """`send_line` / `send_page` on a fresh `init_link`: every done time
    and both busy clocks equal the reference's, and each channel
    serializes at its share of the link (the reference's bound)."""
    bw = 4.25
    jl, tl = J.init_link(), T.init_link(device="cpu")
    for _ in range(n):
        jl, jd_line = J.send_line(jl, 0.0, 64.0, bw, ratio)
        tl, td_line = T.send_line(tl, 0.0, 64.0, bw, ratio)
        jl, jd_page = J.send_page(jl, 0.0, 4096.0, bw, ratio)
        tl, td_page = T.send_page(tl, 0.0, 4096.0, bw, ratio)
        assert float(td_line) == float(jd_line)
        assert float(td_page) == float(jd_page)
    assert float(tl.line.busy_until) == float(jl.line.busy_until)
    assert float(tl.page.busy_until) == float(jl.page.busy_until)
    exp_line = n * 64.0 / (bw * ratio)
    exp_page = n * 4096.0 / (bw * (1 - ratio))
    assert abs(float(td_line) - exp_line) < 1e-5 * exp_line + 1e-2
    assert abs(float(td_page) - exp_page) < 1e-5 * exp_page + 1e-2


@pytest.mark.parametrize("gate", [True, False])
def test_channel_transmit_and_gated_occupy_match_reference(gate):
    """`transmit`, then `occupy` gated on or off (off: the clock stays
    and done is t_ready), on a busy channel, from tensor and Python
    inputs alike. `occupy`, `line_bw` and `page_bw` are in the module,
    not in the package exports, in both packages."""
    jc, tc = J.init_channel(), T.init_channel(device="cpu")
    jc, jd = J.transmit(jc, 3.0, 100.0, 2.5)
    tc, td = T.transmit(tc, 3.0, 100.0, 2.5)
    assert float(td) == float(jd)
    jc, jd = JB.occupy(jc, jnp.float32(10.0), 48.0, 0.7, gate=gate)
    tc, td = TB.occupy(tc, torch.tensor(10.0), 48.0, 0.7,
                       gate=torch.tensor(gate))
    assert float(td) == float(jd)
    assert float(tc.busy_until) == float(jc.busy_until)
    assert TB.line_bw(4.0, 0.25) == JB.line_bw(4.0, 0.25)
    assert TB.page_bw(4.0, 0.25) == JB.page_bw(4.0, 0.25)


def _assert_engines_equal(jst, tst):
    for f in jst._fields:
        np.testing.assert_array_equal(convert.to_numpy(getattr(tst, f)),
                                      np.asarray(getattr(jst, f)),
                                      err_msg=f)


def test_dirty_unit_thresholds_and_throttles_match_reference():
    """A page in flight: the first `threshold` dirty evictions are
    buffered, the next flushes and throttles the entry; the whole engine
    state equals the reference's after every eviction."""
    dp_j, dp_t = J.DaemonParams(), T.DaemonParams()
    jst = J.schedule_page(J.init_engine_state(dp_j), jnp.int32(11),
                          jnp.float32(0.0), jnp.float32(1e6))
    tst = T.schedule_page(T.init_engine_state(dp_t), torch.tensor(11),
                          torch.tensor(0.0), torch.tensor(1e6))
    buffered_count = 0
    for _ in range(dp_t.dirty_flush_threshold + 1):
        jst, jb = J.note_dirty_eviction(jst, jnp.int32(11), dp_j)
        tst, tb = T.note_dirty_eviction(tst, torch.tensor(11), dp_t)
        assert bool(tb) == bool(jb)
        buffered_count += int(tb)
        _assert_engines_equal(jst, tst)
    assert buffered_count == dp_t.dirty_flush_threshold
    _, idx = T.find(tst.page_key, 11)
    assert int(tst.page_state[idx]) == T.THROTTLED


def test_dirty_eviction_not_in_flight_matches_reference():
    """A page not in flight goes straight to remote memory, and, as in
    the reference, entry 0's dirty counter is reset (the `argmax` of an
    all-False match): entry 0 holds page 11 with one buffered line."""
    dp_j, dp_t = J.DaemonParams(), T.DaemonParams()
    jst = J.schedule_page(J.init_engine_state(dp_j), jnp.int32(11),
                          jnp.float32(0.0), jnp.float32(1e6))
    tst = T.schedule_page(T.init_engine_state(dp_t), torch.tensor(11),
                          torch.tensor(0.0), torch.tensor(1e6))
    jst, _ = J.note_dirty_eviction(jst, jnp.int32(11), dp_j)
    tst, _ = T.note_dirty_eviction(tst, torch.tensor(11), dp_t)
    assert int(tst.page_dirty[0]) == 1
    jst, jb = J.note_dirty_eviction(jst, jnp.int32(42), dp_j)
    tst, tb = T.note_dirty_eviction(tst, 42, dp_t)
    assert not bool(tb) and not bool(jb)
    assert int(tst.page_dirty[0]) == 0
    _assert_engines_equal(jst, tst)
    fresh = T.init_engine_state(dp_t)
    st2, buffered = T.note_dirty_eviction(fresh, 42, dp_t)
    assert not bool(buffered)
    _assert_engines_equal(fresh, st2)


def test_decode_attention_paged_matches_reference():
    """The case of tests/test_kernels.py:126-144 (identity page table,
    one full and one 2-page length) from numpy inputs, plus a permuted
    table with a -1 pad."""
    b, nh, kvh, d, page, npages = 2, 8, 4, 64, 16, 4
    rng = np.random.default_rng(9)
    q = rng.standard_normal((b, nh, d)).astype(np.float32)
    kp = rng.standard_normal((npages, page, kvh, d)).astype(np.float32)
    vp = rng.standard_normal((npages, page, kvh, d)).astype(np.float32)
    lengths = np.asarray([npages * page, page * 2], np.int32)
    for table in (np.tile(np.arange(npages, dtype=np.int32)[None], (b, 1)),
                  np.asarray([[2, 0, 3, 1], [1, 3, -1, -1]], np.int32)):
        want = JREF.decode_attention_paged(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(table), jnp.asarray(lengths))
        got = TREF.decode_attention_paged(
            torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(table), torch.from_numpy(lengths))
        assert got.shape == (b, nh, d) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
