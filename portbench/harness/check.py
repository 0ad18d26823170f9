"""Whether what the timed path served is correct.

After the window a sample of the requests the engine finished, drawn from
the seed with the longest among them, goes through the family's plain
float32 reference (``reference/<family>.py``), with each request's prompt
and the tokens the engine served, on the weights the harness drew.  Every
request decodes greedily, so each served token should be the reference's
best: the number compared is the widest gap by which a served token's
logit lies below the reference's best at its position
(``logit_gap_max``, in logits), or their mean over every compared token
(``logit_gap_mean``).  A cell's file names the numbers it compares, each
with its limit, set from the program's readings over many seeds and the
precision control's (``PERF.md``), and the fewest tokens a check compares
(``tokens_compared``).

The precision control (``control=True``) is put in the program's place:
at every position of the same sequences it takes the token that the
reference computed in float8 puts first, and that token's gap is judged
under the cell's own names and limits, so ``correct`` is the control's
verdict.  The program's own readings stay beside it, unjudged, as
``program_<name>``, and its verdict as ``program_correct``.

A sparse-expert layer drops tokens past its capacity per call, so the
reference is told which positions shared a call: the prompt past its
cached prefix went in calls of ``chunk`` positions from its first
uncached one, each served token in a call of its own.  A cached prefix is
taken as computed in calls of ``chunk`` from position 0, as the request
that first wrote it computed it when it started cold."""
from __future__ import annotations

import numpy as np
import torch

MIN_TOKENS = "tokens_compared"


def sample(recs: list, seed: int, n: int, tokens: int) -> list:
    """The longest finished request and others in an order drawn from the
    seed, until there are ``n`` and they served ``tokens`` tokens, or none
    is left; in request order."""
    done = sorted((r for r in recs if r.finish is not None), key=lambda r: r.rid)
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.req.output), -r.rid))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng([seed % 2 ** 64, 4]).permutation(len(rest))
    picked, served = [longest], len(longest.req.output)
    for i in order:
        if len(picked) >= n and served >= tokens:
            break
        picked.append(rest[i])
        served += len(rest[i].req.output)
    return sorted(picked, key=lambda r: r.rid)


def segments(n_prompt: int, n_hit: int, n_out: int, chunk: int) -> list[tuple[int, int, int]]:
    """(start, end, call width) of the calls that computed each position of
    prompt + served tokens but the last."""
    segs = [(a, min(a + chunk, n_hit), chunk) for a in range(0, n_hit, chunk)]
    segs += [(a, min(a + chunk, n_prompt), chunk) for a in range(n_hit, n_prompt, chunk)]
    segs += [(p, p + 1, 1) for p in range(n_prompt, n_prompt + n_out - 1)]
    return segs


def check(run, params, conf: dict, chunk: int, seed: int, ref, limits: dict, n: int,
          tokens: int, *, control: bool = False) -> dict:
    picked = sample(list(run.reqs.values()), seed, n, tokens)
    seqs = []
    for r in picked:
        prompt, out = list(r.req.prompt), list(r.req.output)
        seqs.append({"tokens": prompt + out[:-1], "first": len(prompt) - 1,
                     "served": out,
                     "segments": segments(len(prompt), r.req.prefix_hit_tokens,
                                          len(out), chunk)})
    gaps, ctl = [], []
    with torch.no_grad():
        exact = ref.forward(params, conf, seqs)
        lower = ref.forward(params, conf, seqs, quant=True) if control else None
        for s in seqs:
            logits = next(exact)
            served = torch.as_tensor(s["served"], device=logits.device)
            rows = torch.arange(len(served), device=logits.device)
            best = logits.max(dim=-1).values
            gaps.append((best - logits[rows, served]).float().cpu())
            if lower is not None:
                first = next(lower).argmax(dim=-1)
                ctl.append((best - logits[rows, first]).float().cpu())
            del logits
    n = sum(len(g) for g in gaps)
    served = _verdict({MIN_TOKENS: n, **_gaps(gaps, "logit")}, limits, bool(seqs))
    if not control:
        return served
    res = _verdict({MIN_TOKENS: n, **_gaps(ctl, "logit")}, limits, bool(seqs))
    for name, c in served["checks"].items():
        res["checks"]["program_" + name] = {"value": c["value"], "limit": None}
    res["program_correct"] = served["correct"]
    return res


def _verdict(readings: dict, limits: dict, any_seq: bool) -> dict:
    """Each limited reading against its limit; the others unjudged."""
    out = {name: {"value": readings[name], "limit": limit} for name, limit in limits.items()}
    correct = any_seq and all(
        c["value"] >= c["limit"] if name == MIN_TOKENS else c["value"] <= c["limit"]
        for name, c in out.items())
    for name in readings:
        out.setdefault(name, {"value": readings[name], "limit": None})
    return {"correct": correct, "checks": out}


def _gaps(per_seq: list, prefix: str) -> dict:
    """The widest and the mean gap over every compared token."""
    if not per_seq:
        return {f"{prefix}_gap_max": 0.0, f"{prefix}_gap_mean": 0.0}
    g = torch.cat(per_seq)
    return {f"{prefix}_gap_max": float(g.max()), f"{prefix}_gap_mean": float(g.mean())}
