"""The port's `layers.dot` and the two tensor-parallel `ModelOptions`
(`tp_reduce_bf16`, `seq_shard_residual`) against the reference, on the
CPU.

`dot` returns the reference's `preferred_element_type=F32` product: the
operands widened to f32, so a bf16 product is the f32 sum of the exact
products and is never rounded to bf16 first. On f32 operands it is the
plain f32 einsum, bit for bit. With `tp_reduce_bf16` the row-parallel
products are the f32 product rounded once to bf16; XLA:CPU computes the
reference's bf16-output dot on f32 operands the same way, so the
reduced (f32) configs hold the port to it directly. Parameters come
from the reference's `init_model` through numpy.

Tolerances: a bf16-output product within one bf16 ulp of the
reference's elementwise (the f32 sums before the rounding differ in
order); with `tp_reduce_bf16` the model's logits within 2^-8 of the
largest logit (one bf16 ulp of it) and the loss within rtol 1e-4; with
`seq_shard_residual`, which is the identity without a mesh, the port's
own logits bit-equal to the option off, and the reference's within the
f32 parity tolerance of `test_torch_train.py` (loss rtol 1e-5).
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.models.layers import dot

torch.set_num_threads(1)

BF16 = torch.bfloat16
SPEC = "bsd,df->bsf"


def _operands(shape_a, shape_b, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal(shape_a).astype(np.float32))
            .to(dtype),
            torch.from_numpy(rng.standard_normal(shape_b).astype(np.float32))
            .to(dtype))


def _check_f32_accumulation(got, a, b):
    """`got` is the f32 sum of the exact products of bf16 `a`, `b`: equal
    to the widened f32 product, within f32 accumulation error of the f64
    one, and not the bf16-rounded GEMM output."""
    assert torch.equal(got, torch.einsum(SPEC, a.float(), b.float()))
    _check_f32_sum(got, a, b)


def _check_f32_sum(got, a, b):
    """`got` is an f32 sum of the exact products of bf16 `a`, `b`, in any
    order: within f32 accumulation error of the f64 product, not the
    bf16-rounded GEMM output, and nearer the f64 product than it."""
    a32, b32 = a.float(), b.float()
    assert got.dtype == torch.float32
    exact = torch.einsum(SPEC, a32.double(), b32.double())
    scale = torch.einsum(SPEC, a32.double().abs(), b32.double().abs())
    k = a.shape[-1]
    assert ((got.double() - exact).abs()
            <= k * 2.0 ** -24 * scale).all()
    rounded = torch.einsum(SPEC, a, b).float()
    assert not torch.equal(got, rounded)
    assert (got.double() - exact).abs().max() < \
        (rounded.double() - exact).abs().max()


def test_dot_on_f32_operands_is_the_f32_einsum():
    a, b = _operands((3, 5, 64), (64, 7), torch.float32)
    got = dot(a, b, SPEC)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.einsum(SPEC, a, b))


def test_dot_on_bf16_operands_accumulates_exact_products_in_f32():
    a, b = _operands((2, 4, 512), (512, 48), BF16)
    _check_f32_accumulation(dot(a, b, SPEC), a, b)


@pytest.mark.cuda
def test_dot_on_bf16_operands_on_card():
    """The same at qwen3-1.7b's MLP shape on the card, with `allow_tf32`
    at its default: at decode's B·S = 8 rows the decode matmul kernel's
    f32 sum, in its own order of the additions; at a train microbatch's
    1 x 1024 rows the widened product, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py's [dot_f32_accum] "
                    "runs this check on the card")
    a, b = (t.cuda() for t in _operands((8, 1, 2048), (2048, 6144), BF16))
    with torch.no_grad():
        got = dot(a, b, SPEC)
    _check_f32_sum(got.cpu(), a.cpu(), b.cpu())
    a, b = (t.cuda() for t in _operands((1, 1024, 2048), (2048, 6144), BF16))
    got = dot(a, b, SPEC)
    assert torch.equal(got, torch.einsum(SPEC, a.float(), b.float()))
    _check_f32_sum(got.cpu(), a.cpu(), b.cpu())


def _bf16_ulp(x):
    """One bf16 ulp at each |x| (the spacing of its binade)."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _within_one_bf16_ulp(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.all(np.abs(got - want) <= _bf16_ulp(want))


def test_dot_bf16_output_is_the_f32_product_rounded_once():
    import jax.numpy as jnp
    a, b = _operands((3, 5, 64), (64, 7), torch.float32, seed=1)
    got = dot(a, b, SPEC, out_dtype=BF16)
    assert got.dtype == BF16
    assert torch.equal(got, torch.einsum(SPEC, a, b).to(BF16))
    want = jnp.einsum(SPEC, a.numpy(), b.numpy(),
                      preferred_element_type=jnp.bfloat16)
    _within_one_bf16_ulp(got.float().numpy(), want.astype(jnp.float32))


# ------------------------------------------------- the two options
@functools.lru_cache(maxsize=None)
def _setup():
    import jax
    from repro.configs import get_config as j_get_config
    from repro.configs.base import ShapeConfig as JShape
    from repro.data.pipeline import DataConfig as JData
    from repro.data.pipeline import synthetic_batch as j_batch
    from repro.models.model import init_model as j_init_model
    jcfg = j_get_config("qwen3-1.7b").reduced()
    np_params = jax.device_get(j_init_model(jax.random.PRNGKey(0), jcfg)[0])
    batch = jax.device_get(j_batch(jcfg, JShape("t", 64, 4, "train"),
                                   JData(seed=0), 0))
    return jcfg, np_params, batch


def _port(opts):
    """(logits, loss) of the port's reduced qwen3-1.7b with `opts`."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models.model import ModelOptions, forward, loss_fn
    _, np_params, batch = _setup()
    cfg = get_config("qwen3-1.7b").reduced()
    params = convert.params_from_numpy(np_params, cfg, "cpu")
    tb = convert.batch_from_numpy(batch, "cpu")
    opt = ModelOptions(remat="none", **opts)
    with torch.no_grad():
        logits, _ = forward(params, cfg, tb, opt)
        loss, _ = loss_fn(params, cfg, tb, opt)
    return logits.numpy(), float(loss)


def _reference(opts):
    from repro.models.model import ModelOptions as JOpt
    from repro.models.model import forward as j_forward
    from repro.models.model import loss_fn as j_loss_fn
    jcfg, np_params, batch = _setup()
    opt = JOpt(remat="none", **opts)
    logits, _ = j_forward(np_params, jcfg, batch, opt)
    loss, _ = j_loss_fn(np_params, jcfg, batch, opt)
    return np.asarray(logits), float(loss)


def test_tp_reduce_bf16_forward_and_loss_match_reference():
    logits, loss = _port({"tp_reduce_bf16": True})
    j_logits, j_loss = _reference({"tp_reduce_bf16": True})
    assert np.abs(logits - j_logits).max() <= \
        2.0 ** -8 * np.abs(j_logits).max()
    np.testing.assert_allclose(loss, j_loss, rtol=1e-4)
    off, _ = _port({})
    assert not np.array_equal(logits, off)       # the option is applied


def test_seq_shard_residual_forward_and_loss_match_reference():
    logits, loss = _port({"seq_shard_residual": True})
    off, off_loss = _port({})
    assert np.array_equal(logits, off) and loss == off_loss
    j_logits, j_loss = _reference({"seq_shard_residual": True})
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    np.testing.assert_allclose(logits, j_logits, rtol=1e-5,
                               atol=1e-5 * np.abs(j_logits).max())


@pytest.mark.parametrize("block", ["attention", "mlp"])
def test_row_parallel_products_in_bf16_match_reference(block):
    """Layer 0's attention and MLP with reduce_dtype=bf16 on an f32
    input: each output is a bf16 value within one bf16 ulp of the
    reference's."""
    import jax.numpy as jnp
    from repro.models import attention as JA
    from repro.models import layers as JL

    from repro_torch.configs import get_config
    from repro_torch.models import attention as TA
    from repro_torch.models import layers as TL
    jcfg, np_params, _ = _setup()
    cfg = get_config("qwen3-1.7b").reduced()
    layer = np_params["runs"][0]
    x = np.random.default_rng(2).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    if block == "mlp":
        p = {k: v[0] for k, v in layer["ffn"].items()}
        want = JL.mlp(p, jnp.asarray(x), reduce_dtype=jnp.bfloat16)
        got = TL.mlp({k: torch.from_numpy(np.array(v))
                      for k, v in p.items()}, torch.from_numpy(x),
                     reduce_dtype=BF16)
    else:
        p = {k: v[0] for k, v in layer["attn"].items()}
        want = JA.attention(p, jcfg, jnp.asarray(x),
                            reduce_dtype=jnp.bfloat16)
        got = TA.attention({k: torch.from_numpy(np.array(v))
                            for k, v in p.items()}, cfg,
                           torch.from_numpy(x), reduce_dtype=BF16)
    got = got.numpy()
    assert np.array_equal(got, got.astype(jnp.bfloat16).astype(np.float32))
    _within_one_bf16_ulp(got, want)
