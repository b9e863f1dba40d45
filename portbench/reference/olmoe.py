"""Plain PyTorch reference of OLMoE's decoder block (arXiv:2409.02060;
transformers' `OlmoeForCausalLM`).

Written from the published architecture, in float32 with TF32 off: token
embedding; per layer RMSNorm, attention whose q and k projections are
RMS-normalised over their whole width (num_heads * head_dim and
num_key_value_heads * head_dim) before the split into heads and before
rotary embeddings over (first half, second half) pairs, causal softmax
over the positions so far, the output projection and a residual add;
then RMSNorm and the routed experts: router logits over all experts, the
`num_experts_per_tok` largest chosen, each weighted by the softmax over
all the experts' logits without renormalising (`norm_topk_prob` false),
and each chosen expert's SwiGLU computed only on the tokens routed to
it (`moe.experts`); a residual add; a final RMSNorm and the untied
output head over the logical vocabulary. Every RMSNorm uses the
configuration's `rms_norm_eps`. The whole sequence is computed at once,
with no cache and no batching tricks.

Departures from the published block, none of which changes a value the
comparison reads: each RMSNorm's weight is stored as an offset from 1
(the published weight is 1 + offset); the experts are chosen from the
logits where the published code takes the top k of their softmax (the
same order, but equal logits go to the lower expert index here); the
embedding and head tables carry the port's padding rows, which no
token id reaches and which the logits leave out; `clip_qkv` is null in
the published configuration and not computed; the arithmetic is
float32 where the published model runs in bfloat16.

`leaves(cfg, vocab_rows)` lists what the benchmark draws from the seed:
the mixture-of-experts reference's leaves with q_norm and k_norm at the
projections' widths, (layers, num_heads * head_dim) and (layers,
num_key_value_heads * head_dim); `port_params(weights)` places them in
repro_torch's tree; `logits(weights, cfg, tokens, quant)` with
`quant="fp8"` is the lower-precision control (`dense.linear`).
"""
from __future__ import annotations

import torch

from portbench.reference import dense, moe

F32 = torch.float32


def leaves(cfg, vocab_rows: int) -> list:
    """The leaves the seed draws, in order (`moe.leaves`), with the
    full-width q and k norm offsets."""
    layers, hd = cfg["num_hidden_layers"], cfg["head_dim"]
    width = {"q_norm": cfg["num_attention_heads"] * hd,
             "k_norm": cfg["num_key_value_heads"] * hd}
    return [(name, (layers, width[name]), scale, dtype) if name in width
            else (name, shape, scale, dtype)
            for name, shape, scale, dtype in moe.leaves(cfg, vocab_rows)]


def port_params(w: dict) -> dict:
    """`w` in repro_torch's parameter tree (`moe.port_params`)."""
    return moe.port_params(w)


def attention(w, cfg, layer, h, quant):
    s, t, d = h.shape
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, eps = cfg["head_dim"], cfg["rms_norm_eps"]
    q = dense.linear(h, w["wq"][layer].reshape(d, nh * hd), quant)
    k = dense.linear(h, w["wk"][layer].reshape(d, nkv * hd), quant)
    v = dense.linear(h, w["wv"][layer].reshape(d, nkv * hd), quant)
    q = dense.rms_norm(q, w["q_norm"][layer], eps).view(s, t, nh, hd)
    k = dense.rms_norm(k, w["k_norm"][layer], eps).view(s, t, nkv, hd)
    v = v.view(s, t, nkv, hd)
    pos = torch.arange(t, device=h.device)
    q = dense.rotary(q, pos, cfg["rope_theta"])
    k = dense.rotary(k, pos, cfg["rope_theta"])
    group = nh // nkv
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    scores = torch.einsum("sqnh,sknh->snqk", q, k) / hd ** 0.5
    causal = torch.ones(t, t, dtype=torch.bool, device=h.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.einsum("snqk,sknh->sqnh", scores.softmax(dim=-1), v)
    return dense.linear(out.reshape(s, t, nh * hd),
                        w["wo"][layer].reshape(nh * hd, d), quant)


def logits(w, cfg, tokens, quant=None, vocab_block=32768):
    """tokens (S, T) -> logits (S, T, vocab_size) f32."""
    eps = cfg["rms_norm_eps"]
    with dense.exact_f32(), torch.no_grad():
        x = w["embed"][tokens.long()].to(F32)
        for layer in range(cfg["num_hidden_layers"]):
            h = dense.rms_norm(x, w["norm1"][layer], eps)
            x = x + attention(w, cfg, layer, h, quant)
            h = dense.rms_norm(x, w["norm2"][layer], eps)
            x = x + moe.experts(w, cfg, layer, h, quant)
        x = dense.rms_norm(x, w["final_norm"], eps)
        out = [dense.linear(x, w["unembed"][i:i + vocab_block].T, quant)
               for i in range(0, cfg["vocab_size"], vocab_block)]
        return torch.cat(out, dim=-1)[..., :cfg["vocab_size"]]
