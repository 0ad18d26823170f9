"""AdamW with f32 moments, the reference's ``training/optimizer.py``.

The state mirrors the parameter tree: ``{"mu", "nu"}`` f32 trees and an
int32 ``step``.  ``apply_updates`` follows the reference's arithmetic step
for step and writes the new parameters and moments into their tensors in
place, so a step holds no second copy of either.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import params as P

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def opt_state_specs(param_specs) -> dict:
    """Moment specs mirror param specs at f32."""

    def mom(s: P.ParamSpec) -> P.ParamSpec:
        return dataclasses.replace(s, dtype=f32, init="zeros")

    return {
        "mu": P.tree_map(mom, param_specs),
        "nu": P.tree_map(mom, param_specs),
        "step": P.ParamSpec((), (), dtype=torch.int32, init="zeros"),
    }


def init_opt_state(param_specs, device) -> dict:
    return P.init(None, opt_state_specs(param_specs), device)


def lr_at(cfg: AdamWConfig, step):
    """Linear warmup to ``cfg.lr``; ``step`` the count of steps taken."""
    s = step.to(f32) + 1.0
    warm = s / max(cfg.warmup_steps, 1)
    return cfg.lr * torch.clamp(warm, max=1.0)


@torch.no_grad()
def apply_updates(params, grads, opt_state, cfg: AdamWConfig):
    """One AdamW step, in place.  Returns (params, opt_state, stats
    {"grad_norm", "lr"}).  As the reference: the learning rate at the
    old step and the bias corrections at the new one; the gradients
    clipped to a global norm (an f32 sum of squares over the leaves in tree
    order); the update in f32, weight decay on every leaf, the result cast
    to the parameter's dtype."""
    step = opt_state["step"] + 1
    lr = lr_at(cfg, opt_state["step"])

    # global-norm clip
    gsq = sum(g.to(f32).square().sum() for g in P.tree_leaves(grads))
    gnorm = torch.sqrt(gsq)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
             if cfg.grad_clip else 1.0)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(f32)
    bc2 = 1.0 - b2 ** step.to(f32)
    for p, g, mu, nu in P.tree_zip(params, grads, opt_state["mu"], opt_state["nu"]):
        g = g.to(f32) * scale
        mu.copy_(b1 * mu + (1 - b1) * g)
        nu.copy_(b2 * nu + (1 - b2) * g * g)
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        u = u + cfg.weight_decay * p.to(f32)
        p.copy_((p.to(f32) - lr * u).to(p.dtype))
    opt_state = {"mu": opt_state["mu"], "nu": opt_state["nu"], "step": step}
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
