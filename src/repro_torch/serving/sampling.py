"""Batched token sampling: greedy / temperature / top-k / top-p.

One function over (B, V) logits with per-row parameter vectors.  Random
draws come from an explicit ``torch.Generator`` on the logits' device.
"""
from __future__ import annotations

import torch

f32 = torch.float32
NEG = -1e30


def filter_logits(logits, temperature, top_k, top_p):
    """Temperature-scaled logits with the top-k and top-p (nucleus) cuts
    applied as NEG, as the reference masks them.  top_k == 0 disables
    top-k; a row always keeps at least one token."""
    B, V = logits.shape
    t = temperature.clamp(min=1e-6)[:, None]
    scaled = logits / t
    neg = torch.full_like(scaled, NEG)

    # top-k: mask everything below the k-th largest
    sorted_desc = scaled.sort(dim=-1, descending=True).values
    k = torch.where(top_k <= 0, V, top_k).clamp(1, V).long()
    kth = sorted_desc.gather(1, (k - 1)[:, None])
    scaled = torch.where(scaled >= kth, scaled, neg)

    # top-p: keep the smallest prefix of sorted probs with mass >= p
    sorted_desc = scaled.sort(dim=-1, descending=True).values
    probs_sorted = torch.softmax(sorted_desc, dim=-1)
    cum = probs_sorted.cumsum(dim=-1)
    keep = ((cum - probs_sorted) < top_p[:, None]).sum(dim=-1).clamp(1, V)
    cutoff = sorted_desc.gather(1, (keep - 1)[:, None])
    return torch.where(scaled >= cutoff, scaled, neg)


def categorical(generator: torch.Generator, logits):
    """One draw per row from softmax(logits) (Gumbel-max)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=f32)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20, max=1.0 - 1e-7)))
    return (logits + gumbel).argmax(dim=-1)


def sample(logits, generator, temperature, top_k, top_p):
    """logits (B,V) f32; temperature/top_p (B,) f32; top_k (B,) int.

    temperature == 0 selects greedy for that row.  Returns (B,) int64."""
    greedy = logits.argmax(dim=-1)
    sampled = categorical(generator, filter_logits(logits, temperature, top_k, top_p))
    return torch.where(temperature <= 0.0, greedy, sampled)
