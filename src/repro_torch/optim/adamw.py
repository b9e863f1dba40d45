"""AdamW over parameter trees, with global-norm clipping.

PyTorch counterpart of ``repro.optim.adamw``: the same per-leaf f32
arithmetic. `adamw_update` updates the parameters and both moments IN
PLACE and returns them — the reference's launcher donates its params and
optimizer state to the jitted step for the same reason: at full width a
second copy of both would not fit beside the gradients. A caller that
still needs the old values passes clones.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.compute_plane import tree_leaves, tree_map

F32 = torch.float32


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params):
    """{"mu", "nu"}: f32 zeros like each leaf; "count": 0-d int32."""
    leaf = tree_leaves(params)[0]
    zeros = lambda p: torch.zeros_like(p, dtype=F32)    # noqa: E731
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def _global_norm(leaves):
    total = 0
    for g in leaves:
        total = total + torch.square(g.to(F32)).sum()
    return torch.sqrt(total)


def _clip_scale(gnorm, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so their global L2 norm is at most `max_norm`,
    the norm before scaling)."""
    gnorm = _global_norm(tree_leaves(grads))
    scale = _clip_scale(gnorm, max_norm)
    return tree_map(lambda g: (g.to(F32) * scale).to(g.dtype), grads), gnorm


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: AdamWConfig, lr=None):
    """Returns (params, opt_state, {"grad_norm"}), params and moments
    updated in place. Clipping is applied leaf by leaf as each leaf is
    updated (the same values as clipping the whole tree first, with one
    leaf of temporaries alive instead of a tree)."""
    gnorm = _global_norm(tree_leaves(grads))
    scale = _clip_scale(gnorm, cfg.grad_clip)
    count = opt_state["count"] + 1
    lr = cfg.lr if lr is None else lr
    b1c = 1.0 - torch.pow(cfg.b1, count.to(F32))
    b2c = 1.0 - torch.pow(cfg.b2, count.to(F32))

    def upd(p, g, mu, nu):
        g = (g.to(F32) * scale).to(g.dtype).to(F32)
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        step = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        pf = p.to(F32)
        p.copy_((pf - lr * (step + cfg.weight_decay * pf)).to(p.dtype))

    tree_map(upd, params, grads, opt_state["mu"], opt_state["nu"])
    return params, {"mu": opt_state["mu"], "nu": opt_state["nu"],
                    "count": count}, {"grad_norm": gnorm}

