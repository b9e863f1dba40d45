"""The plain versions of the block int8 quantizer (K3) and BDI (K4)
against the reference's jnp oracles and its Pallas kernels in interpret
mode, on the same numpy inputs, exactly (but for interpret mode's
quantize scale, see below); and the dispatch rules of their `ops`
entries."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bdi as KB
from repro.kernels import qdq_int8 as KQ
from repro.kernels import ref as R
from repro_torch.kernels import _build, ops
from repro_torch.kernels import bdi as bdi_kernel
from repro_torch.kernels import qdq_int8 as qdq_kernel
from repro_torch.kernels import ref

torch.set_num_threads(1)


def _float_rows(n, b, seed):
    """Mixed-magnitude rows with exact .5 ties, an all-zero row and a
    single-spike row."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, b)).astype(np.float32)
    x *= 10.0 ** rng.integers(-6, 4, (n, 1))
    x[0] = 0.0
    ties = (np.arange(b) % 254 - 127 + 0.5).astype(np.float32)
    ties[0] = 127.0                       # amax 127 -> scale 1.0
    x[1] = ties
    x[2] = 2.0 * ties                     # scale 2.0, x/scale = k + .5
    x[3] = 0.0
    x[3, 5] = -3.0
    return x


def _int_rows(n, b, seed):
    """Rows of base + small deltas; rows whose x - base overflows int32
    and wraps to a small delta (they compress only under int32
    wraparound); random rows (they do not compress)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2**31, 2**31, (n, b), dtype=np.int64)
    k = n // 3
    d = rng.integers(-128, 128, (k, b))
    d[:, 0] = 0
    x[:k] = rng.integers(-2**30, 2**30, (k, 1)) + d
    x[k:2 * k, 0] = 2**31 - 1
    x[k:2 * k, 1:] = -2**31 + rng.integers(0, 100, (k, b - 1))
    x[2 * k] = 2**31 - 1 - np.arange(b) % 100             # near the top
    return x.astype(np.int32)


@pytest.mark.parametrize("shape", [(8, 128), (16, 256), (64, 256),
                                   (32, 1024)])
def test_quantize_plain_matches_pallas_and_oracle(shape):
    """Exactly the jnp oracle. The Pallas kernel in interpret mode is
    traced as one jitted program, where XLA:CPU rewrites amax / 127 into
    amax * (1/127): its scale can sit one f32 ulp off the IEEE quotient
    (the oracle, run op by op, divides). The port divides, as the CUDA
    kernel does; against interpret mode the scales agree to 1 ulp and q
    is equal on every row whose scale is equal."""
    x = _float_rows(*shape, seed=shape[0])
    q, s = ref.quantize_block_int8(torch.from_numpy(x))
    qj, sj = R.quantize_block_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    qk, sk = (np.asarray(a) for a in KQ.quantize_block_int8(
        jnp.asarray(x), interpret=True))
    np.testing.assert_array_max_ulp(s.numpy(), sk, maxulp=1)
    same = (s.numpy() == sk)[:, 0]
    assert same.mean() > 0.5
    np.testing.assert_array_equal(q.numpy()[same], qk[same])
    assert s[0, 0] == 1.0 and s[1, 0] == 1.0 and s[2, 0] == 2.0
    # half to even at the exact ties -125.5, -124.5, -123.5
    np.testing.assert_array_equal(q[1, 1:4].numpy(), [-126, -124, -124])


def _non_finite_rows(n, b, seed):
    """Finite rows, then a row holding a NaN (scale 1), one holding +Inf
    (scale Inf, its Inf / Inf quotient NaN) and one holding NaN and -Inf
    (scale 1, -Inf clamps to -127)."""
    x = _float_rows(n, b, seed)
    x[4, 5] = np.nan
    x[5, 7] = np.inf
    x[6, 1], x[6, 2] = np.nan, -np.inf
    return x


def test_quantize_non_finite_rows_match_pallas_and_oracle():
    """NaN quotients give q = 0, as the reference's float-to-int8 convert
    does; scales 1 or Inf are exact, so interpret mode agrees too."""
    x = _non_finite_rows(8, 256, seed=11)
    q, s = ref.quantize_block_int8(torch.from_numpy(x))
    for qj, sj in (R.quantize_block_int8(jnp.asarray(x)),
                   KQ.quantize_block_int8(jnp.asarray(x), interpret=True)):
        np.testing.assert_array_equal(q.numpy()[4:7], np.asarray(qj)[4:7])
        np.testing.assert_array_equal(s.numpy()[4:7], np.asarray(sj)[4:7])
    np.testing.assert_array_equal(s.numpy()[4:7, 0], [1.0, np.inf, 1.0])
    np.testing.assert_array_equal(q.numpy()[[4, 5, 6, 6], [5, 7, 1, 2]],
                                  [0, 0, 0, -127])
    qj, sj = R.quantize_block_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    # dequantize: 0 x Inf is NaN on both sides
    np.testing.assert_array_equal(ref.dequantize_block_int8(q, s).numpy(),
                                  np.asarray(R.dequantize_block_int8(qj, sj)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_plain_matches_pallas_and_oracle(dtype):
    x = _float_rows(16, 256, seed=3)
    qj, sj = R.quantize_block_int8(jnp.asarray(x))
    q = torch.from_numpy(np.array(qj))
    s = torch.from_numpy(np.array(sj))
    got = ref.dequantize_block_int8(q, s, getattr(torch, dtype)).float()
    for want in (KQ.dequantize_block_int8(qj, sj, out_dtype=jnp.dtype(dtype),
                                          interpret=True),
                 R.dequantize_block_int8(qj, sj, jnp.dtype(dtype))):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want, np.float32))


@pytest.mark.parametrize("shape", [(24, 128), (48, 256)])
def test_bdi_plain_matches_pallas_and_oracle(shape):
    x = _int_rows(*shape, seed=shape[1])
    got = ref.bdi_compress(torch.from_numpy(x))
    for want in (KB.bdi_compress(jnp.asarray(x), interpret=True),
                 R.bdi_compress(jnp.asarray(x))):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ok = got[2].numpy()[:, 0]
    k = shape[0] // 3
    assert ok[:2 * k + 1].all() and not ok[2 * k + 1:].any()
    raw = torch.from_numpy(x)
    rec = ref.bdi_decompress(*got, raw)
    np.testing.assert_array_equal(rec.numpy(), x)
    # with a different raw copy, decompress takes base + delta (wrapped)
    # on ok rows and raw elsewhere, as the reference does
    other = np.roll(x, 1, axis=0)
    jb, jd, jo = (np.asarray(a) for a in R.bdi_compress(jnp.asarray(x)))
    want = KB.bdi_decompress(jb, jd, jo, jnp.asarray(other), interpret=True)
    got2 = ref.bdi_decompress(*got, torch.from_numpy(other))
    np.testing.assert_array_equal(got2.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got2.numpy(),
        np.asarray(R.bdi_decompress(jb, jd, jo, jnp.asarray(other))))


def test_wrap_i32():
    x = torch.tensor([2**31, -2**31 - 1, 2**32 + 5, -7], dtype=torch.int64)
    np.testing.assert_array_equal(ref.wrap_i32(x).numpy(),
                                  [-2**31, 2**31 - 1, 5, -7])


def test_dispatch_takes_plain_on_cpu_and_never_falls_back():
    x = torch.from_numpy(_float_rows(13, 256, seed=5))   # a ragged N
    q, s = ops.quantize_block_int8(x)
    rq, rs = ref.quantize_block_int8(x)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    assert torch.equal(ops.dequantize_block_int8(q, s),
                       ref.dequantize_block_int8(q, s))
    xi = torch.from_numpy(_int_rows(9, 128, seed=6))
    got = ops.bdi_compress(xi)
    for a, b in zip(got, ref.bdi_compress(xi)):
        assert torch.equal(a, b)
    assert torch.equal(ops.bdi_decompress(*got, xi), xi)
    for call in (lambda: ops.quantize_block_int8(x, impl="cuda"),
                 lambda: ops.dequantize_block_int8(q, s, impl="cuda"),
                 lambda: ops.bdi_compress(xi, impl="cuda"),
                 lambda: ops.bdi_decompress(*got, xi, impl="cuda"),
                 lambda: qdq_kernel.quantize_block_int8(x),
                 lambda: bdi_kernel.bdi_compress(xi)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="impl"):
        ops.quantize_block_int8(x, impl="pallas")
    for k in qdq_kernel.KERNELS + bdi_kernel.KERNELS:
        assert k.launches == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            _build.build_all(list(qdq_kernel.KERNELS + bdi_kernel.KERNELS))


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    """Bit for bit on the card (chip_smoke.py runs the same checks at the
    train path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.from_numpy(_non_finite_rows(13, 256, seed=7)).cuda()
    q, s = ops.quantize_block_int8(x)
    rq, rs = ref.quantize_block_int8(x)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    for dt in (torch.float32, torch.bfloat16):
        torch.testing.assert_close(ops.dequantize_block_int8(q, s, dt),
                                   ref.dequantize_block_int8(q, s, dt),
                                   rtol=0, atol=0, equal_nan=True)
    xi = torch.from_numpy(_int_rows(24, 256, seed=8)).cuda()
    got = ops.bdi_compress(xi)
    for a, b in zip(got, ref.bdi_compress(xi)):
        assert torch.equal(a, b)
    assert torch.equal(ops.bdi_decompress(*got, xi), xi)
