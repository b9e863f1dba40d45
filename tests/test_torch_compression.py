"""`repro_torch.core.compression` against `repro.core.compression` on
the same numpy inputs, exactly: block int8 and int4 (packed) with their
scales, including sizes that need padding, BDI blocks including int32
wraparound, the int8 wire ratio and `ef_compress`'s residual. The
reference runs op by op (not under jit), where its divisions are IEEE
divisions, as the port's are."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as J
from repro_torch.core import compression as T

torch.set_num_threads(1)

SHAPES = [(7,), (256,), (3, 100), (2, 3, 129), (64, 64)]


def _x(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    return x * np.float32(10.0 ** rng.integers(-4, 3))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("block", [128, 256])
def test_int8_roundtrip_matches_reference(shape, block):
    x = _x(shape, seed=sum(shape) + block)
    q, s = T.quantize_block_int8(torch.from_numpy(x), block)
    qj, sj = J.quantize_block_int8(jnp.asarray(x), block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    assert q.shape == (-(-x.size // block), block)
    d = T.dequantize_block_int8(q, s, shape, block)
    dj = J.dequantize_block_int8(qj, sj, shape, block)
    assert d.shape == shape
    np.testing.assert_array_equal(d.numpy(), np.asarray(dj))


@pytest.mark.parametrize("shape", SHAPES)
def test_int4_roundtrip_matches_reference(shape):
    x = _x(shape, seed=len(shape))
    p, s = T.quantize_block_int4(torch.from_numpy(x))
    pj, sj = J.quantize_block_int4(jnp.asarray(x))
    assert p.dtype == torch.uint8
    np.testing.assert_array_equal(p.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    d = T.dequantize_block_int4(p, s, shape)
    np.testing.assert_array_equal(d.numpy(), np.asarray(
        J.dequantize_block_int4(pj, sj, shape)))


@pytest.mark.parametrize("case", ["small", "wrap", "random"])
def test_bdi_block_matches_reference(case):
    rng = np.random.default_rng(11)
    if case == "small":
        x = 1000 + rng.integers(-128, 128, 64)
        x[0] = 1000
    elif case == "wrap":          # x - base overflows int32, wraps small
        x = -2**31 + rng.integers(0, 100, 64)
        x[0] = 2**31 - 1
    else:
        x = rng.integers(-2**31, 2**31, 64)
    x = x.astype(np.int32)
    base, deltas, ok = T.bdi_compress_block(torch.from_numpy(x))
    bj, dj, okj = J.bdi_compress_block(jnp.asarray(x))
    assert int(base) == int(bj) and bool(ok) == bool(okj)
    np.testing.assert_array_equal(deltas.numpy(), np.asarray(dj))
    assert bool(ok) == (case != "random")
    rec = T.bdi_decompress_block(base, deltas)
    np.testing.assert_array_equal(rec.numpy(), np.asarray(
        J.bdi_decompress_block(bj, dj)))
    if bool(ok):
        np.testing.assert_array_equal(rec.numpy(), x)


@pytest.mark.parametrize("shape", [(1000,), (4, 256), (3, 5, 7)])
def test_compression_ratio_int8(shape):
    assert T.compression_ratio_int8(shape) == J.compression_ratio_int8(shape)


def test_ef_compress_matches_reference():
    g = _x((5, 77), seed=1)
    r = _x((5, 77), seed=2) * np.float32(1e-2)
    q, s, res = T.ef_compress(torch.from_numpy(g), torch.from_numpy(r))
    qj, sj, resj = J.ef_compress(jnp.asarray(g), jnp.asarray(r))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(res.numpy(), np.asarray(resj))
    # two rounds of feedback: the residual carries what int8 dropped
    q2, s2, res2 = T.ef_compress(torch.from_numpy(g), res)
    qj2, sj2, resj2 = J.ef_compress(jnp.asarray(g), resj)
    np.testing.assert_array_equal(res2.numpy(), np.asarray(resj2))
    assert float(res.abs().max()) <= float(s.max()) * 0.5 * (1 + 2**-16)
