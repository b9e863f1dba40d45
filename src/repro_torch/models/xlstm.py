"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel forward) and
sLSTM (scalar memory, exponential gating, sequential forward), each with
its O(1)-state decode.

PyTorch counterpart of ``repro.models.xlstm``. The numerics follow the
reference rather than the torch defaults:

- log-sigmoid is `-softplus(-x)` with softplus `logaddexp(x, 0)`, as
  `jax.nn.log_sigmoid` computes it;
- the running maximum of the chunkwise form is `torch.cummax`
  (`lax.cummax`), its stabiliser starts at 0, not -inf, and the
  intra-chunk exponent is masked to -1e30 before `exp`, so the dead
  triangle is exactly 0 and its gradient finite;
- the denominators are max(|n.q|, exp(-m)) (mLSTM) and max(n, 1e-6)
  (sLSTM);
- an activation in f32 against a weight in the compute type computes in
  f32, as jnp promotes mixed operands (`layers.dot` widens both).

The sLSTM forward is a Python loop over the sequence in chunks, each
chunk under `torch.utils.checkpoint` while grad is on (the reference's
`jax.checkpoint` around its chunk scan). The decodes write their state
in place, as the attention decode writes its KV cache, and read nothing
back to the host.
"""
from __future__ import annotations

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.models.layers import (F32, dot, normal, ones, rms_norm,
                                       round_up, silu, zeros)
from repro_torch.models.ssm import _pick_chunk, softplus

GATES = ("z", "i", "f", "o")


def log_sigmoid(x):
    return -softplus(-x)


# ==========================================================================
# mLSTM
# ==========================================================================
def _mlstm_dims(cfg):
    d_in = 2 * cfg.d_model
    nh = cfg.num_heads
    return d_in, nh, d_in // nh


def init_mlstm(gen: torch.Generator, cfg, *, layers: int = 0, dtype=F32):
    """The projections in `dtype` (the reference casts them to the
    compute type at use); the gate biases (forget bias 1) and the norm
    scale in f32."""
    d = cfg.d_model
    d_in, nh, hd = _mlstm_dims(cfg)
    dev = gen.device

    def w(shape, scale=None):
        return normal(gen, shape, scale=scale, layers=layers, dtype=dtype)

    return {"w_up": w((d, d_in)), "w_gate": w((d, d_in)),
            "wq": w((d_in, nh, hd)), "wk": w((d_in, nh, hd)),
            "wv": w((d_in, nh, hd)),
            "wi": w((d_in, nh), 0.02), "wf": w((d_in, nh), 0.02),
            "bi": zeros((nh,), layers=layers, device=dev),
            "bf": ones((nh,), layers=layers, device=dev),
            "norm": zeros((d_in,), layers=layers, device=dev),
            "w_down": w((d_in, d))}


def mlstm_axes():
    """Logical axes of `init_mlstm`'s parameters."""
    return {"w_up": ("fsdp", "tensor"), "w_gate": ("fsdp", "tensor"),
            "wq": ("tensor", None, None), "wk": ("tensor", None, None),
            "wv": ("tensor", None, None), "wi": ("tensor", None),
            "wf": ("tensor", None), "bi": (None,), "bf": (None,),
            "norm": ("tensor",), "w_down": ("tensor", "fsdp")}


def mlstm_state_axes():
    """Logical axes of one layer's `init_mlstm_state`."""
    return {"C": ("batch", None, None, None), "n": ("batch", None, None),
            "m": ("batch", None)}


def init_mlstm_state(cfg, batch: int, *, layers=(), device=None):
    """Zero decode state: "C" (*layers, B, NH, HD, HD), "n" (..., NH, HD)
    and the stabiliser "m" (..., NH), all f32."""
    d_in, nh, hd = _mlstm_dims(cfg)
    lead = tuple(layers) + (batch, nh)
    return {"C": torch.zeros(lead + (hd, hd), dtype=F32, device=device),
            "n": torch.zeros(lead + (hd,), dtype=F32, device=device),
            "m": torch.zeros(lead, dtype=F32, device=device)}


def _mlstm_cell(state, q, k, v, ig, fg):
    """One step. q,k,v: (B,NH,HD); ig,fg: (B,NH) gate preactivations.
    Returns (new state, h (B,NH,HD))."""
    c, n, m = state["C"], state["n"], state["m"]
    flog = log_sigmoid(fg)
    m_new = torch.maximum(flog + m, ig)
    fct = torch.exp(flog + m - m_new)
    ict = torch.exp(ig - m_new)
    c = c * fct[..., None, None] + ict[..., None, None] * (
        v[..., :, None] * k[..., None, :])              # (B,NH,HD,HD)
    n = n * fct[..., None] + ict[..., None] * k
    num = torch.einsum("bkij,bkj->bki", c, q)
    den = torch.maximum(torch.einsum("bkj,bkj->bk", n, q).abs(),
                        torch.exp(-m_new))[..., None]
    return {"C": c, "n": n, "m": m_new}, num / den


def _mlstm_qkvg(params, cfg, x):
    dtype = x.dtype
    d_in, nh, hd = _mlstm_dims(cfg)
    a = silu(dot(x, params["w_up"].to(dtype), "...d,de->...e"))
    g = dot(x, params["w_gate"].to(dtype), "...d,de->...e")
    q = dot(a, params["wq"].to(dtype), "...e,ekh->...kh")
    k = dot(a, params["wk"].to(dtype), "...e,ekh->...kh") / (hd ** 0.5)
    v = dot(a, params["wv"].to(dtype), "...e,ekh->...kh")
    ig = dot(a, params["wi"].to(dtype), "...e,ek->...k") \
        + params["bi"].to(F32)
    fg = dot(a, params["wf"].to(dtype), "...e,ek->...k") \
        + params["bf"].to(F32)
    return q, k, v, ig, fg, g


def _mlstm_chunkwise(q, k, v, ig, fg, chunk: int = 256):
    """Chunkwise-parallel mLSTM: attention-like products within a chunk
    and the state (C, n, m) carried from chunk to chunk; equals the
    per-token cell. q,k,v: (B,S,NH,HD); ig,fg: (B,S,NH). Returns h
    (B,S,NH,HD) f32."""
    bsz, s, nh, hd = q.shape
    cq = _pick_chunk(s, chunk)
    tri = torch.tril(torch.ones((cq, cq), dtype=torch.bool,
                                device=q.device))
    q, k, v = q.to(F32), k.to(F32), v.to(F32)
    c = torch.zeros((bsz, nh, hd, hd), dtype=F32, device=q.device)
    n = torch.zeros((bsz, nh, hd), dtype=F32, device=q.device)
    m = torch.zeros((bsz, nh), dtype=F32, device=q.device)
    hs = []
    for c0 in range(0, s, cq):
        sl = slice(c0, c0 + cq)
        qc, kc, vc, igc, fgc = q[:, sl], k[:, sl], v[:, sl], ig[:, sl], \
            fg[:, sl]
        flog = log_sigmoid(fgc)                          # (B,q,NH)
        b = torch.cumsum(flog, dim=1)                    # within-chunk
        a = igc - b
        mt = torch.maximum(m[:, None, :],
                           torch.cummax(a, dim=1).values)  # M_t (B,q,NH)
        # intra-chunk scores: S_ij = (q_i.k_j) exp(a_j - M_i), j <= i
        sc = torch.einsum("bikh,bjkh->bkij", qc, kc)     # (B,NH,q_i,q_j)
        w_exp = a.permute(0, 2, 1)[:, :, None, :] \
            - mt.permute(0, 2, 1)[:, :, :, None]         # (B,NH,i,j)
        w_exp = torch.where(tri, w_exp, -1e30)           # mask BEFORE exp
        sc = sc * torch.exp(w_exp)
        num = torch.einsum("bkij,bjkh->bikh", sc, vc)
        den = sc.sum(dim=-1).permute(0, 2, 1)            # (B,q,NH)
        # inter-chunk from the carried state: h_out[o] = sum_h C[o,h] q[h]
        inter_w = torch.exp(m[:, None, :] - mt)          # (B,q,NH)
        num = num + torch.einsum("bikh,bkoh->biko", qc, c) \
            * inter_w[..., None]
        den = den + torch.einsum("bikh,bkh->bik", qc, n) * inter_w
        m_step = b + mt                                  # running stabiliser
        hs.append(num / torch.maximum(den.abs(),
                                      torch.exp(-m_step))[..., None])
        # end-of-chunk state:
        # C_Q = e^{m + b_Q - m_new} C + sum_j e^{i_j + b_Q - b_j - m_new} v k^T
        m_new = m_step[:, -1, :]
        c_decay = torch.exp(m + b[:, -1, :] - m_new)     # (B,NH)
        wj = torch.exp(igc + b[:, -1:, :] - b - m_new[:, None, :])
        c = c * c_decay[..., None, None] + torch.einsum(
            "bjkh,bjk,bjki->bkhi", vc, wj, kc)
        n = n * c_decay[..., None] + torch.einsum("bjkh,bjk->bkh", kc, wj)
        m = m_new
    return torch.cat(hs, dim=1)


def _mlstm_out(params, h, g, dtype):
    """Norm, output gate and down projection of the cell output h
    (..., d_in) f32."""
    h = rms_norm(h.to(dtype), params["norm"])
    h = (h.to(F32) * silu(g.to(F32))).to(dtype)
    return dot(h, params["w_down"].to(dtype), "...e,ed->...d").to(dtype)


def mlstm(params, cfg, x, chunk: int = 256):
    """Training / prefill forward, chunkwise-parallel. x: (B,S,D)."""
    bsz, s, _ = x.shape
    d_in, _, _ = _mlstm_dims(cfg)
    q, k, v, ig, fg, g = _mlstm_qkvg(params, cfg, x)
    hs = _mlstm_chunkwise(q, k, v, ig, fg, chunk)
    return _mlstm_out(params, hs.reshape(bsz, s, d_in), g, x.dtype)


def mlstm_decode(params, cfg, x, state):
    """x: (B,1,D); one cell step, the state written IN PLACE. Returns
    (y (B,1,D), state)."""
    bsz = x.shape[0]
    d_in, _, _ = _mlstm_dims(cfg)
    q, k, v, ig, fg, g = _mlstm_qkvg(params, cfg, x[:, 0, :])
    new, h = _mlstm_cell(state, q, k, v, ig, fg)
    y = _mlstm_out(params, h.reshape(bsz, d_in), g, x.dtype)
    for name, t in new.items():
        state[name].copy_(t)
    return y[:, None, :], state


# ==========================================================================
# sLSTM
# ==========================================================================
def _slstm_dims(cfg):
    nh = cfg.num_heads
    return nh, cfg.d_model // nh


def init_slstm(gen: torch.Generator, cfg, *, layers: int = 0, dtype=F32):
    """Input weights and the FFN in `dtype`; the block-diagonal recurrent
    weights r_* in f32 (the reference computes them in f32), the biases
    (forget bias 1) and the FFN norm scale in f32."""
    d = cfg.d_model
    nh, dh = _slstm_dims(cfg)
    dff = round_up(int(8 * d / 3), 16)
    dev = gen.device
    p = {}
    for gate in GATES:
        p[f"w_{gate}"] = normal(gen, (d, d), layers=layers, dtype=dtype)
        p[f"r_{gate}"] = normal(gen, (nh, dh, dh), scale=0.05,
                                layers=layers)
        p[f"b_{gate}"] = (ones if gate == "f" else zeros)(
            (d,), layers=layers, device=dev)
    p["ffn_gate"] = normal(gen, (d, dff), layers=layers, dtype=dtype)
    p["ffn_up"] = normal(gen, (d, dff), layers=layers, dtype=dtype)
    p["ffn_down"] = normal(gen, (dff, d), layers=layers, dtype=dtype)
    p["ffn_norm"] = zeros((d,), layers=layers, device=dev)
    return p


def slstm_axes():
    """Logical axes of `init_slstm`'s parameters."""
    a = {}
    for gate in GATES:
        a[f"w_{gate}"] = ("fsdp", "tensor")
        a[f"r_{gate}"] = (None, None, None)
        a[f"b_{gate}"] = (None,)
    a.update(ffn_gate=("fsdp", "tensor"), ffn_up=("fsdp", "tensor"),
             ffn_down=("tensor", "fsdp"), ffn_norm=(None,))
    return a


def slstm_state_axes():
    """Logical axes of one layer's `init_slstm_state`."""
    return {k: ("batch", None) for k in ("c", "n", "h", "m")}


def init_slstm_state(cfg, batch: int, *, layers=(), device=None):
    """Zero decode state "c", "n", "h", "m", each (*layers, B, D) f32."""
    shape = tuple(layers) + (batch, cfg.d_model)
    return {k: torch.zeros(shape, dtype=F32, device=device)
            for k in ("c", "n", "h", "m")}


def _slstm_cell(params, cfg, state, wx):
    """wx: gate -> (B,D) input contributions (Wx + b). Returns (new
    state, h (B,D))."""
    nh, dh = _slstm_dims(cfg)
    bsz, d = state["h"].shape

    def rec(gate):
        hh = state["h"].reshape(bsz, nh, dh)
        return torch.einsum("bkh,khj->bkj", hh,
                            params[f"r_{gate}"].to(F32)).reshape(bsz, d)

    zt = torch.tanh(wx["z"] + rec("z"))
    it = wx["i"] + rec("i")
    ft = wx["f"] + rec("f")
    ot = torch.sigmoid(wx["o"] + rec("o"))
    flog = log_sigmoid(ft)
    m_new = torch.maximum(flog + state["m"], it)
    ict = torch.exp(it - m_new)
    fct = torch.exp(flog + state["m"] - m_new)
    c = fct * state["c"] + ict * zt
    n = fct * state["n"] + ict
    h = ot * c / torch.clamp_min(n, 1e-6)
    return {"c": c, "n": n, "h": h, "m": m_new}, h


def _slstm_wx(params, x):
    return {g: dot(x, params[f"w_{g}"].to(x.dtype), "...d,de->...e")
            + params[f"b_{g}"].to(F32) for g in GATES}


def _slstm_ffn(params, x):
    """x + SwiGLU(rms_norm(x)): the FFN carries its own residual."""
    dtype = x.dtype
    h = rms_norm(x, params["ffn_norm"])
    g = dot(h, params["ffn_gate"].to(dtype), "...d,df->...f")
    u = dot(h, params["ffn_up"].to(dtype), "...d,df->...f")
    return x + dot((silu(g) * u).to(dtype), params["ffn_down"].to(dtype),
                   "...f,fd->...d").to(dtype)


def _slstm_steps(params, cfg, state, wx):
    """The cell over every position of the chunk wx (gate -> (B,q,D)).
    Returns (state, hs (B,q,D))."""
    hs = []
    for t in range(wx["z"].shape[1]):
        state, h = _slstm_cell(params, cfg, state,
                               {g: v[:, t] for g, v in wx.items()})
        hs.append(h)
    return state, torch.stack(hs, dim=1)


def slstm(params, cfg, x, chunk: int = 256):
    """Training / prefill forward: the recurrence token by token, in
    chunks, each chunk recomputed in the backward pass while grad is on
    (residuals peak at one chunk's worth). x: (B,S,D)."""
    bsz, s, _ = x.shape
    wx = _slstm_wx(params, x)
    state = init_slstm_state(cfg, bsz, device=x.device)
    cq = _pick_chunk(s, chunk)
    hs = []
    for c0 in range(0, s, cq):
        part = {g: v[:, c0:c0 + cq] for g, v in wx.items()}
        if torch.is_grad_enabled():
            state, h = ckpt.checkpoint(_slstm_steps, params, cfg, state,
                                       part, use_reentrant=False)
        else:
            state, h = _slstm_steps(params, cfg, state, part)
        hs.append(h)
    return _slstm_ffn(params, torch.cat(hs, dim=1).to(x.dtype))


def slstm_decode(params, cfg, x, state):
    """x: (B,1,D); one cell step, the state written IN PLACE. Returns
    (y (B,1,D), state)."""
    wx = _slstm_wx(params, x[:, 0, :])
    new, h = _slstm_cell(params, cfg, state, wx)
    y = _slstm_ffn(params, h.to(x.dtype))
    for name, t in new.items():
        state[name].copy_(t)
    return y[:, None, :], state
