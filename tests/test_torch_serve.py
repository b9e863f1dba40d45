"""The port's paged serving path against the reference's, on reduced
qwen3-1.7b in f32.

Parameters come from the reference's `init_model` through
`convert.params_from_numpy`, so both packages compute the same function.
Greedy tokens must be equal and the store ledger equal within rtol 1e-5,
atol 1e-6; per-step logits within rtol = atol = 1e-4 (f32 sums taken in
another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.core.daemon_store import KVStoreConfig as JKVStoreConfig
from repro.models.model import ModelOptions as JModelOptions
from repro.models.model import decode_step as j_decode_step
from repro.models.model import init_decode_state as j_init_decode_state
from repro.models.model import init_model as j_init_model
from repro.runtime.serve_loop import PagedServeConfig as JPaged
from repro.runtime.serve_loop import ServeConfig as JServe
from repro.runtime.serve_loop import serve_batch_paged as j_serve
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.daemon_store import KVStoreConfig
from repro_torch.models.model import (ModelOptions, decode_step,
                                      init_decode_state)
from repro_torch.runtime.serve_loop import (PagedServeConfig, ServeConfig,
                                            serve_batch_paged)

torch.set_num_threads(1)

# small enough that the decode's append window outgrows the pool: pages
# are evicted dirty and written back
STORE = dict(num_local_pages=4, page_tokens=2, kv_heads=2, head_dim=16,
             page_budget_per_step=2)


def _setup():
    jcfg = j_get_config("qwen3-1.7b").reduced()
    cfg = get_config("qwen3-1.7b").reduced()
    j_params, _ = j_init_model(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_numpy(jax.device_get(j_params), cfg, "cpu")
    prompts = np.random.default_rng(1).integers(2, 200, (2, 6)).astype(
        np.int32)
    return jcfg, cfg, j_params, params, prompts


def test_serve_batch_paged_matches_reference():
    jcfg, cfg, j_params, params, prompts = _setup()
    j_tokens, j_led = j_serve(j_params, jcfg, jnp.asarray(prompts),
                              JServe(max_new_tokens=10),
                              JKVStoreConfig(**STORE),
                              JPaged(window_pages=2, pages_per_seq=8))
    tokens, led = serve_batch_paged(params, cfg, torch.from_numpy(prompts),
                                    ServeConfig(max_new_tokens=10),
                                    KVStoreConfig(**STORE),
                                    PagedServeConfig(window_pages=2,
                                                     pages_per_seq=8),
                                    device="cpu")
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(j_tokens))
    assert set(led) == set(j_led)
    for k, v in j_led.items():
        np.testing.assert_allclose(led[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert led["dirty_evicts"] > 0
    assert led["requests"] == 2 * 2 * 16


def test_decode_step_logits_match_reference():
    jcfg, cfg, j_params, params, prompts = _setup()
    b, steps = prompts.shape[0], 8
    j_state, _ = j_init_decode_state(jcfg, b, steps, JModelOptions())
    state = init_decode_state(cfg, b, steps, ModelOptions(), device="cpu")
    j_step = jax.jit(lambda p, s, t, pos: j_decode_step(
        p, jcfg, s, t, pos, JModelOptions()))
    tok = prompts[:, :1]
    for pos in range(steps):
        j_logits, j_state = j_step(j_params, j_state, jnp.asarray(tok),
                                   jnp.int32(pos))
        logits, state = decode_step(params, cfg, state,
                                    torch.from_numpy(tok), pos,
                                    ModelOptions())
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"pos {pos}")
        tok = np.asarray(j_logits)[:, :cfg.vocab_size].argmax(
            -1)[:, None].astype(np.int32)
    np.testing.assert_allclose(
        state["runs"][0]["k"].numpy(),
        np.asarray(j_state["runs"][0]["k"]), rtol=1e-4, atol=1e-4)
