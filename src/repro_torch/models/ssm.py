"""Mamba2 (SSD) block: the chunked training/prefill forward and the O(1)
recurrent decode.

PyTorch counterpart of ``repro.models.ssm``. The chunked SSD keeps the
reference's form — quadratic products within a chunk and a state carried
from chunk to chunk — as a Python loop over the chunks. Three numerics
follow the reference rather than the torch defaults:

- the causal depthwise convolution (width `ssm_conv_width`) is W shifted
  multiply-adds in f32, the decode's own form, never cuDNN's conv (which
  may run f32 in TF32 on the card);
- softplus is `logaddexp(x, 0)`, as `jax.nn.softplus` is (torch's
  `softplus` returns x itself above 20);
- the intra-chunk decay exponent is masked to -1e30 before `exp`, so the
  dead triangle is exactly 0 and its gradient finite.

The decode writes its state {"ssm" (B,H,P,N) f32, "conv" (B,W,C)} in
place, as the attention decode writes its KV cache.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import F32, dot, normal, rms_norm, silu
from repro_torch.runtime.mesh_rules import constrain


def _dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_head_dim
    return d_in, nheads, cfg.ssm_head_dim, cfg.ssm_state


def init_mamba2(gen: torch.Generator, cfg, *, layers: int = 0, dtype=F32):
    """The reference's Mamba2 parameters: the projections in `dtype`
    (the reference casts them to the compute type at use), the per-head
    vectors, the conv kernels and the norm scale in f32."""
    d = cfg.d_model
    d_in, h, p, n = _dims(cfg)
    w = cfg.ssm_conv_width
    lead = (layers,) if layers else ()
    dev = gen.device

    def const(shape, value):
        return torch.full(lead + shape, value, dtype=F32, device=dev)

    return {
        "wz": normal(gen, (d, d_in), layers=layers, dtype=dtype),
        "wx": normal(gen, (d, d_in), layers=layers, dtype=dtype),
        "wB": normal(gen, (d, n), layers=layers, dtype=dtype),
        "wC": normal(gen, (d, n), layers=layers, dtype=dtype),
        "wdt": normal(gen, (d, h), layers=layers, dtype=dtype),
        "dt_bias": const((h,), 0.0),
        "A_log": const((h,), 0.0),                 # A = -exp(A_log)
        "D": const((h,), 1.0),
        "conv_x": normal(gen, (w, d_in), scale=0.5, layers=layers),
        "conv_B": normal(gen, (w, n), scale=0.5, layers=layers),
        "conv_C": normal(gen, (w, n), scale=0.5, layers=layers),
        "norm": const((d_in,), 0.0),
        "wo": normal(gen, (d_in, d), layers=layers, dtype=dtype),
    }


def mamba2_axes():
    """Logical axes of `init_mamba2`'s parameters."""
    return {"wz": ("fsdp", "tensor"), "wx": ("fsdp", "tensor"),
            "wB": ("fsdp", None), "wC": ("fsdp", None),
            "wdt": ("fsdp", "tensor"), "dt_bias": ("tensor",),
            "A_log": ("tensor",), "D": ("tensor",),
            "conv_x": (None, "tensor"), "conv_B": (None, None),
            "conv_C": (None, None), "norm": ("tensor",),
            "wo": ("tensor", "fsdp")}


def softplus(x):
    """log(1 + exp(x)) as `jax.nn.softplus` computes it."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_depthwise_conv(u, kernel):
    """u: (B,S,C); kernel: (W,C). out[t] = sum_k u[t + k - (W-1)] *
    kernel[k] (zeros before the start), summed in f32 in k's order and
    returned in u.dtype."""
    w = kernel.shape[0]
    s = u.shape[1]
    pad = torch.nn.functional.pad(u.to(F32), (0, 0, w - 1, 0))
    kern = kernel.to(u.dtype).to(F32)
    out = pad[:, 0:s] * kern[0]
    for k in range(1, w):
        out = out + pad[:, k:k + s] * kern[k]
    return out.to(u.dtype)


def _pick_chunk(s: int, target: int = 256) -> int:
    for q in range(min(target, s), 0, -1):
        if s % q == 0:
            return q
    return s


def _ssd_chunked(xh, dt, a, b_in, c_in, chunk, h0=None):
    """Chunk-parallel SSD, chunk by chunk (peak memory = one chunk's
    quadratic intra tensors).

    xh (B,S,H,P), dt (B,S,H) [post-softplus], a (H,) [negative],
    b_in/c_in (B,S,N). Returns y (B,S,H,P) f32 and the final state
    (B,H,P,N)."""
    bsz, s, h, p = xh.shape
    n = b_in.shape[-1]
    q = _pick_chunk(s, chunk)
    nc = s // q
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                device=xh.device))
    hprev = h0 if h0 is not None else torch.zeros(
        (bsz, h, p, n), dtype=F32, device=xh.device)
    xf, bf, cf = xh.to(F32), b_in.to(F32), c_in.to(F32)
    ys = []
    for c in range(nc):
        sl = slice(c * q, (c + 1) * q)
        xc, dtc, bc, cc = xf[:, sl], dt[:, sl], bf[:, sl], cf[:, sl]
        da = dtc * a                                    # (B,q,H)
        cs = torch.cumsum(da, dim=1)
        xdt = xc * dtc[..., None]                       # (B,q,H,P)
        gap = cs[:, :, None, :] - cs[:, None, :, :]     # (B,i,j,H)
        gap = torch.where(tri[None, :, :, None], gap, -1e30)
        decay = torch.exp(gap)
        g = torch.einsum("bin,bjn->bij", cc, bc)        # (B,q,q)
        mm = g[..., None] * decay
        y_intra = torch.einsum("bijh,bjhp->bihp", mm, xdt)
        y_inter = torch.einsum("bin,bhpn->bihp", cc, hprev) \
            * torch.exp(cs)[..., None]
        to_end = torch.exp(cs[:, -1:, :] - cs)          # (B,q,H)
        s_chunk = torch.einsum("bjh,bjhp,bjn->bhpn", to_end, xdt, bc)
        hprev = hprev * torch.exp(cs[:, -1, :])[..., None, None] + s_chunk
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), hprev


def mamba2(params, cfg, x, chunk: int = 256):
    """Training/prefill forward. x: (B,S,D) -> (B,S,D)."""
    dtype = x.dtype
    bsz, s, d = x.shape
    d_in, h, p, n = _dims(cfg)
    z = dot(x, params["wz"].to(dtype), "bsd,de->bse").to(dtype)
    xr = dot(x, params["wx"].to(dtype), "bsd,de->bse").to(dtype)
    br = dot(x, params["wB"].to(dtype), "bsd,dn->bsn").to(dtype)
    cr = dot(x, params["wC"].to(dtype), "bsd,dn->bsn").to(dtype)
    dt = dot(x, params["wdt"].to(dtype), "bsd,dh->bsh")
    dt = softplus(dt + params["dt_bias"].to(F32))
    xr = silu(_causal_depthwise_conv(xr, params["conv_x"]))
    br = silu(_causal_depthwise_conv(br, params["conv_B"]))
    cr = silu(_causal_depthwise_conv(cr, params["conv_C"]))
    xh = constrain(xr.reshape(bsz, s, h, p), ("batch", None, "tensor", None))
    a = -torch.exp(params["A_log"].to(F32))
    y, _ = _ssd_chunked(xh, dt, a, br, cr, chunk)
    y = y + xh.to(F32) * params["D"].to(F32)[..., None]
    y = (y.reshape(bsz, s, d_in) * silu(z.to(F32))).to(dtype)
    y = rms_norm(y, params["norm"])
    return dot(y, params["wo"].to(dtype), "bse,ed->bsd").to(dtype)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------
def init_mamba2_state(cfg, batch: int, *, layers=(), device=None):
    """Zero decode state: "ssm" (*layers, B, H, P, N) f32 and the rolling
    conv window "conv" (*layers, B, W, d_in + 2N) in cfg.dtype."""
    d_in, h, p, n = _dims(cfg)
    w = cfg.ssm_conv_width
    lead = tuple(layers)
    return {
        "ssm": torch.zeros(lead + (batch, h, p, n), dtype=F32,
                           device=device),
        "conv": torch.zeros(lead + (batch, w, d_in + 2 * n),
                            dtype=getattr(torch, cfg.dtype), device=device),
    }


def mamba2_state_axes():
    """Logical axes of one layer's `init_mamba2_state`."""
    return {"ssm": ("batch", "tensor", None, None),
            "conv": ("batch", None, None)}


def mamba2_decode(params, cfg, x, state):
    """x: (B,1,D); O(1) state update, written IN PLACE into `state`.
    Returns (y (B,1,D), state)."""
    dtype = x.dtype
    bsz = x.shape[0]
    d_in, h, p, n = _dims(cfg)
    xt = x[:, 0, :]
    z = dot(xt, params["wz"].to(dtype), "bd,de->be")
    xr = dot(xt, params["wx"].to(dtype), "bd,de->be")
    br = dot(xt, params["wB"].to(dtype), "bd,dn->bn")
    cr = dot(xt, params["wC"].to(dtype), "bd,dn->bn")
    dt = dot(xt, params["wdt"].to(dtype), "bd,dh->bh")
    dt = softplus(dt + params["dt_bias"].to(F32))
    # rolling conv window over concat(x, B, C) channels
    u = torch.cat([xr, br, cr], dim=-1).to(state["conv"].dtype)
    conv = torch.cat([state["conv"][:, 1:, :], u[:, None, :]], dim=1)
    kern = torch.cat([params["conv_x"], params["conv_B"],
                      params["conv_C"]], dim=1)          # (W, d_in+2N)
    conv_out = torch.einsum("bwc,wc->bc", conv.to(F32), kern.to(F32))
    conv_out = silu(conv_out)
    xr = conv_out[:, :d_in]
    br = conv_out[:, d_in:d_in + n]
    cr = conv_out[:, d_in + n:]
    xh = xr.reshape(bsz, h, p)
    a = -torch.exp(params["A_log"].to(F32))
    da = torch.exp(dt * a)                               # (B,H)
    ssm = state["ssm"] * da[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xh, br)
    y = torch.einsum("bhpn,bn->bhp", ssm, cr) + xh * params["D"].to(
        F32)[..., None]
    y = (y.reshape(bsz, d_in) * silu(z.to(F32))).to(dtype)
    y = rms_norm(y, params["norm"])
    out = dot(y, params["wo"].to(dtype), "be,ed->bd").to(dtype)
    state["ssm"].copy_(ssm)
    state["conv"].copy_(conv)
    return out[:, None, :], state
