"""OLMoE's published block in the port: the three `ArchConfig` options
(`norm_topk_prob`, `qk_norm_width`, `norm_eps`) at a tiny size on the
CPU, each alone and together against transformers' `OlmoeForCausalLM`,
the defaults against the per-head block they keep, and the `model.moe`
layer span with its routed-experts count."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config
from repro_torch.core import telemetry
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.models import moe as moe_mod
from repro_torch.runtime.obs import SpanRecorder

OLMOE = {"norm_topk_prob": False, "qk_norm_width": "full", "norm_eps": 1e-5}
OPT = M.ModelOptions(remat="none")
B, T = 2, 7


def _cfg(**options):
    """Reduced olmoe-1b-7b (d 64, 4 x 16 heads over 2 KV heads, 8 experts
    top-2, 4 layers, f32) with `options`."""
    return dataclasses.replace(get_config("olmoe-1b-7b").reduced(), **options)


def _params(cfg, seed=0):
    """The port's initialisation, with every RMSNorm offset drawn at 0.1
    (the port starts them at 0, where a norm's width hardly shows), and
    the router and the output head at 1/sqrt(d), as the benchmark draws
    them (the port's 0.02 leaves the routing near ties, its head at 1
    makes logits of ~30, whose f32 rounding is ~1e-4). A full-width
    q/k scale repeats the per-head draw once per head, so that only the
    width of the normalisation differs from the per-head block."""
    gen = torch.Generator().manual_seed(seed)
    params = M.init_model(cfg, gen)
    run = params["runs"][0]
    for leaf in (run["norm1"]["scale"], run["norm2"]["scale"],
                 params["final_norm"]["scale"]):
        leaf.copy_(0.1 * torch.randn(leaf.shape, generator=gen))
    hd = cfg.resolved_head_dim
    for name, heads in (("q_norm", cfg.num_heads),
                        ("k_norm", cfg.num_kv_heads)):
        head = 0.1 * torch.randn((cfg.num_layers, hd), generator=gen)
        full = cfg.qk_norm_width == "full"
        run["attn"][name] = head.repeat(1, heads) if full else head
    scale = cfg.d_model ** -0.5
    run["ffn"]["router"].mul_(scale / 0.02)
    params["unembed"]["table"].mul_(scale)
    return params


def _tokens(cfg, seed=3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T)))


def _outputs(cfg, params, tokens):
    """(forward logits, decode logits through the cache, prefill logits)
    over the logical vocabulary."""
    v = cfg.vocab_size
    fwd, _ = M.forward(params, cfg, {"tokens": tokens}, OPT)
    state = M.init_decode_state(cfg, B, T, OPT, device="cpu")
    steps = []
    for pos in range(T):
        logits, state = M.decode_step(params, cfg, state,
                                      tokens[:, pos:pos + 1], pos, OPT)
        steps.append(logits[:, :v])
    pre, _ = M.prefill(params, cfg, {"tokens": tokens}, T, OPT)
    return fwd[..., :v], torch.stack(steps, dim=1), pre[..., :v]


# the least change each option alone makes in the logits (of ~1): eps
# 1e-5 against 1e-6 moves a norm of variance ~1 by ~5e-6 a layer, still
# ten times the logits' f32 rounding (~1e-6)
CHANGES = {"norm_topk_prob": 1e-2, "qk_norm_width": 1e-2, "norm_eps": 1e-5}


@pytest.mark.parametrize("option", sorted(OLMOE))
def test_each_option_alone_changes_the_output(option):
    base = _cfg()
    one = _cfg(**{option: OLMOE[option]})
    tokens = _tokens(base)
    got = _outputs(one, _params(one), tokens)
    want = _outputs(base, _params(base), tokens)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) > CHANGES[option], option


def _per_head_route(params, cfg, x):
    """`moe._route` as the per-head block has it: the softmax over the k
    chosen logits."""
    logits = layers.dot(x, params["router"].to(x.dtype), "bsd,de->bse")
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = moe_mod.top_k_lowest_first(logits, cfg.experts_per_token)
    top_w = torch.softmax(top_w, dim=-1)
    flat = top_i.reshape(-1)
    counts = (flat[:, None] == torch.arange(
        cfg.num_experts, device=x.device)).to(torch.float32).sum(0)
    load = counts / top_i.numel()
    return top_w, top_i, cfg.num_experts * torch.sum(
        probs.mean(dim=(0, 1)) * load)


def test_defaults_reproduce_the_per_head_block_bit_for_bit(monkeypatch):
    """With the options at their defaults every output equals, bit for
    bit, the block the port ran before it had them: the route's softmax
    over the chosen logits, per-head q/k norms and RMSNorm's own eps."""
    cfg = _cfg()
    assert (cfg.norm_topk_prob, cfg.qk_norm_width, cfg.norm_eps) == \
        (True, "head", 1e-6)
    params, tokens = _params(cfg), _tokens(cfg)
    new = _outputs(cfg, params, tokens)
    with monkeypatch.context() as m:
        m.setattr(moe_mod, "_route", _per_head_route)
        for mod in (attn_mod, M):
            m.setattr(mod, "qk_norm",
                      lambda t, scale, cfg: layers.rms_norm(t, scale))
            m.setattr(mod, "rms_norm",
                      lambda x, scale, eps=1e-6: layers.rms_norm(x, scale))
        old = _outputs(cfg, params, tokens)
    for a, b in zip(new, old):
        assert torch.equal(a, b)


def _hf_model(cfg, params):
    """transformers' OlmoeForCausalLM at `cfg`'s sizes, f32, eager
    attention, holding `params` (the port's tree) mapped onto its
    modules: projections transposed, each RMSNorm weight 1 + offset."""
    tf = pytest.importorskip("transformers")
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nh, nkv, v = cfg.num_heads, cfg.num_kv_heads, cfg.vocab_size
    hf_cfg = tf.OlmoeConfig(
        vocab_size=v, hidden_size=d, intermediate_size=cfg.d_ff,
        num_hidden_layers=cfg.num_layers, num_attention_heads=nh,
        num_key_value_heads=nkv, num_experts=cfg.num_experts,
        num_experts_per_tok=cfg.experts_per_token,
        norm_topk_prob=cfg.norm_topk_prob, rms_norm_eps=cfg.norm_eps,
        rope_theta=cfg.rope_theta, max_position_embeddings=64,
        tie_word_embeddings=False, attn_implementation="eager")
    hf = tf.OlmoeForCausalLM(hf_cfg).float().eval()
    run = params["runs"][0]
    a, f = run["attn"], run["ffn"]
    sd = {"model.embed_tokens.weight": params["embed"]["table"][:v],
          "model.norm.weight": 1 + params["final_norm"]["scale"],
          "lm_head.weight": params["unembed"]["table"][:v]}
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        sd[pre + "input_layernorm.weight"] = 1 + run["norm1"]["scale"][i]
        sd[pre + "post_attention_layernorm.weight"] = \
            1 + run["norm2"]["scale"][i]
        sd[pre + "self_attn.q_proj.weight"] = a["wq"][i].reshape(d, nh * hd).T
        sd[pre + "self_attn.k_proj.weight"] = a["wk"][i].reshape(d, nkv * hd).T
        sd[pre + "self_attn.v_proj.weight"] = a["wv"][i].reshape(d, nkv * hd).T
        sd[pre + "self_attn.o_proj.weight"] = a["wo"][i].reshape(nh * hd, d).T
        sd[pre + "self_attn.q_norm.weight"] = 1 + a["q_norm"][i]
        sd[pre + "self_attn.k_norm.weight"] = 1 + a["k_norm"][i]
        sd[pre + "mlp.gate.weight"] = f["router"][i].T
        for e in range(cfg.num_experts):
            ex = f"{pre}mlp.experts.{e}."
            sd[ex + "gate_proj.weight"] = f["w_gate"][i, e].T
            sd[ex + "up_proj.weight"] = f["w_up"][i, e].T
            sd[ex + "down_proj.weight"] = f["w_down"][i, e].T
    missing, unexpected = hf.load_state_dict(
        {k: t.contiguous() for k, t in sd.items()}, strict=False)
    assert not unexpected and all("rotary" in k for k in missing)
    return hf


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 3])
def test_published_block_matches_transformers(seed):
    """The three options together are OLMoE: forward, decode through the
    cache and prefill against `OlmoeForCausalLM` on one seeded draw, to
    f32 rounding (the two sum and order the same f32 products
    differently)."""
    cfg = _cfg(**OLMOE)
    params, tokens = _params(cfg, seed), _tokens(cfg, seed)
    hf = _hf_model(cfg, params)
    with torch.no_grad():
        want = hf(input_ids=tokens).logits
    for got in _outputs(cfg, params, tokens):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
    other = _outputs(_cfg(), _params(_cfg(), seed), tokens)[0]
    assert float((other - want).abs().max()) > 1e-2


class _Ops(TorchDispatchMode):
    """The aten ops dispatched under it, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def _decode(cfg, params, tokens, state, pos, rec=None):
    ops = _Ops()
    ctx = rec.active() if rec is not None else telemetry.recording(None)
    with ctx, ops:
        M.decode_step(params, cfg, state, tokens[:, pos:pos + 1], pos, OPT)
    return ops.ops


def test_moe_span_per_layer_under_model_decode(monkeypatch):
    cfg = _cfg(**OLMOE)
    params, tokens = _params(cfg), _tokens(cfg)
    routes = []
    top_k = moe_mod.top_k_lowest_first

    def kept(x, k):
        vals, idx = top_k(x, k)
        routes.append(idx.clone())
        return vals, idx
    monkeypatch.setattr(moe_mod, "top_k_lowest_first", kept)
    rec = SpanRecorder()
    state = M.init_decode_state(cfg, B, T, OPT, device="cpu")
    off = [_decode(cfg, params, tokens, state, pos) for pos in range(2)]
    on = [_decode(cfg, params, tokens, state, pos, rec)
          for pos in range(2, 4)]
    # the span and its count read no device value and queue nothing
    assert off[0] == off[1] == on[0] == on[1]
    assert "_local_scalar_dense" not in on[0]
    assert not any("unique" in op for op in on[0])
    events = rec.events
    decodes = [e for e in events if e["name"] == "model.decode"]
    moes = [e for e in events if e["name"] == "model.moe"]
    assert len(decodes) == 2 and len(moes) == 2 * cfg.num_layers
    ids = [d["args"]["id"] for d in decodes]
    for k, e in enumerate(moes):
        assert e["args"]["parent"] == ids[k // cfg.num_layers]
        assert (e["args"]["tokens"], e["args"]["experts"], e["args"]["k"]) \
            == (B, cfg.num_experts, cfg.experts_per_token)
        want = routes[2 * cfg.num_layers + k]
        assert e["args"]["routed"] == int(torch.unique(want).numel())
    assert {type(e["args"]["routed"]) for e in moes} == {int}


def test_nothing_is_recorded_without_a_recorder():
    cfg = _cfg(**OLMOE)
    assert telemetry.span("model.moe", tokens=1, experts=8, k=2) is \
        telemetry.span("model.decode", batch=1)
    rec = SpanRecorder()
    params, tokens = _params(cfg), _tokens(cfg)
    state = M.init_decode_state(cfg, B, T, OPT, device="cpu")
    _decode(cfg, params, tokens, state, 0)
    assert rec.events == []


def test_note_reaches_only_the_named_innermost_span():
    rec = SpanRecorder()
    telemetry.note("model.moe", routed=3)            # no recorder: nothing
    with rec.active():
        with telemetry.span("model.decode", batch=2):
            telemetry.note("model.moe", routed=5)    # another span: nothing
            with telemetry.span("model.moe", tokens=2):
                telemetry.note("model.moe", routed=lambda: 7)
    moe, decode = rec.events
    assert moe["args"]["routed"] == 7 and "routed" not in decode["args"]
    assert rec.events[0]["args"]["routed"] == 7
