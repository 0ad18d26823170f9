"""The plain float32 decoder shared by the families: token embedding,
pre-norm layers of grouped-query attention (causal, rotary, optional
q/k/v biases and q/k RMSNorm) and an MLP the family supplies, a final
RMSNorm and the unembedding.

Written from the published descriptions of Qwen2 (arXiv:2407.10671) and
Qwen3: RMSNorm with a (1 + scale) weight, as the port parameterises it;
rotary embedding by half rotation; SwiGLU MLPs.  Every product is taken in
float32 with TF32 off.  The layers run one at a time over all sequences,
each layer's weights cast to float32 only while it runs, so the forward
fits beside the served weights.

``quant=True`` is the precision control: every matrix and every operand of
a product, q, k and v included, rounded to float8 (e4m3) with one scale
per row, the step below the bfloat16 the configurations state."""
from __future__ import annotations

import torch

f32 = torch.float32
FP8_MAX = 448.0
Q_BLOCK = 1024          # query rows per block of attention scores


def fp8(x, dim: int = -1):
    """x rounded to float8 e4m3 with one scale per slice along ``dim``."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(f32) * s


def mm(x, w, quant: bool):
    """x (..., K) @ w (K, N) in float32; under ``quant`` both rounded, x per
    row and w per output column."""
    if quant:
        x, w = fp8(x, -1), fp8(w, 0)
    return x @ w


def rmsnorm(x, scale, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + scale)


def rope(x, pos, theta: float):
    """x (T, heads, d) rotated by half rotation at positions ``pos`` (T,)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=f32, device=x.device) / half)
    ang = pos[:, None].to(f32) * freq
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(h, w, conf: dict, quant: bool):
    """Causal grouped-query attention over one sequence h (T, D)."""
    T, D = h.shape
    H, KV, d = conf["num_attention_heads"], conf["num_key_value_heads"], conf["head_dim"]
    eps, theta = conf["rms_norm_eps"], conf["rope_theta"]
    q = mm(h, w["wq"].reshape(D, H * d), quant).view(T, H, d)
    k = mm(h, w["wk"].reshape(D, KV * d), quant).view(T, KV, d)
    v = mm(h, w["wv"].reshape(D, KV * d), quant).view(T, KV, d)
    if "bq" in w:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    if "q_norm" in w:
        q = rmsnorm(q, w["q_norm"]["scale"], eps)
        k = rmsnorm(k, w["k_norm"]["scale"], eps)
    pos = torch.arange(T, device=h.device)
    q, k = rope(q, pos, theta), rope(k, pos, theta)
    if quant:
        q, k, v = fp8(q), fp8(k), fp8(v)
    rep = H // KV
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    out = torch.empty(T, H, d, dtype=f32, device=h.device)
    for q0 in range(0, T, Q_BLOCK):
        q1 = min(q0 + Q_BLOCK, T)
        s = torch.einsum("qhd,khd->hqk", q[q0:q1], k[:q1]) * d ** -0.5
        mask = torch.arange(q1, device=h.device)[None, :] <= torch.arange(
            q0, q1, device=h.device)[:, None]
        s = s.masked_fill(~mask, float("-inf")).softmax(dim=-1)
        out[q0:q1] = torch.einsum("hqk,khd->qhd", s, v[:q1])
    ctx = out.reshape(T, H * d)
    return mm(ctx, w["wo"].reshape(H * d, D), quant)


def swiglu(x, w_gate, w_up, w_down, quant: bool):
    h = torch.nn.functional.silu(mm(x, w_gate, quant)) * mm(x, w_up, quant)
    return mm(h, w_down, quant)


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.to(f32)


def forward(weights, conf: dict, seqs: list[dict], mlp, *, quant: bool = False):
    """Yield, for each sequence, the float32 logits (n, vocab) at positions
    ``first .. len(tokens) - 1``.  ``seqs``: dicts with ``tokens`` (the
    prompt and the served tokens but the last) and ``first`` (the last
    prompt position); a family's ``mlp(x, w, conf, seqs, spans, quant)``
    gets every sequence's rows stacked, ``spans`` their (start, end)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eps = conf["rms_norm_eps"]
    emb = weights["embed"]["embedding"]
    dev = emb.device
    toks = [torch.as_tensor(s["tokens"], device=dev) for s in seqs]
    spans, t = [], 0
    for tk in toks:
        spans.append((t, t + len(tk)))
        t += len(tk)
    x = emb[torch.cat(toks)].to(f32)
    if quant:
        x = fp8(x)
    with torch.no_grad():
        for layer in weights["layers"]:
            lw = _f32(layer)
            h = rmsnorm(x, lw["ln1"]["scale"], eps)
            x = x + torch.cat([attention(h[a:b], lw["mixer"], conf, quant)
                               for a, b in spans])
            h = rmsnorm(x, lw["ln2"]["scale"], eps)
            x = x + mlp(h, lw["mlp"], conf, seqs, spans, quant)
            del lw, h
        x = rmsnorm(x, weights["final_norm"]["scale"].to(f32), eps)
        w = (emb.to(f32).t() if conf["tie_word_embeddings"]
             else weights["embed"]["unembed"].to(f32))
        for s, (a, b) in zip(seqs, spans):
            yield mm(x[a + s["first"]:b], w, quant)
