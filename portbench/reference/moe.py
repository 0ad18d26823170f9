"""Sparse-expert decoders (qwen3-moe): every layer's MLP routes each token
to its top-k of the experts by a softmax router, the k weights
renormalised (``norm_topk_prob``), each expert a SwiGLU.

Capacity: as the port serves it, an expert takes at most
C = max(1, ceil(S * k / E * capacity_factor)) of one sequence's tokens in
one call of width S, in token order, and drops the rest (the deployment's
``capacity_factor`` stands in the configuration's ``assumed``).  Which
tokens shared a call is given by each sequence's ``segments``: (start,
end, width) spans of its positions.  A span of one token keeps all its k
experts, which are distinct."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import decoder


def keep_mask(idx, segments, E: int, cf: float):
    """(T, k) expert ids -> (T, k) bool, False where capacity dropped it."""
    T, K = idx.shape
    keep = torch.ones(T, K, dtype=torch.bool, device=idx.device)
    for a, b, width in segments:
        if b - a <= 1:
            continue
        C = max(1, math.ceil(width * K / E * cf))
        e = idx[a:b].reshape(-1)
        rank = F.one_hot(e, E).cumsum(0).gather(1, e[:, None])[:, 0] - 1
        keep[a:b] = (rank < C).view(b - a, K)
    return keep


def mlp(x, w, conf, seqs, spans, quant):
    E, K = conf["num_experts"], conf["num_experts_per_tok"]
    cf = conf["assumed"]["capacity_factor"]
    probs = decoder.mm(x, w["router"], quant).softmax(dim=-1)
    wk, idx = torch.topk(probs, K, dim=-1)
    if conf["norm_topk_prob"]:
        wk = wk / wk.sum(-1, keepdim=True)
    keep = torch.cat([keep_mask(idx[a:b], s["segments"], E, cf)
                      for s, (a, b) in zip(seqs, spans)])
    y = torch.zeros_like(x)
    for e in range(E):
        t, k = ((idx == e) & keep).nonzero(as_tuple=True)
        if t.numel():
            ye = decoder.swiglu(x[t], w["w_gate"][e], w["w_up"][e], w["w_down"][e], quant)
            y.index_add_(0, t, ye * wk[t, k, None])
    return y


def forward(weights, conf: dict, seqs: list[dict], *, quant: bool = False):
    return decoder.forward(weights, conf, seqs, mlp, quant=quant)
