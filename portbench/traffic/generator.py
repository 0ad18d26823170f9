"""The one traffic generator: it reads a mix (``traffic/<mix>.json``,
with the cell's load merged over it) and makes the run's requests.

Two loops, as the mix's ``loop`` says:

* ``open``: independent users.  Requests are due on a schedule whatever
  the system does, with inter-arrival gaps of the mix's ``arrivals``
  process at ``rate`` requests/s, over the window's ``seconds``.
* ``closed``: ``clients`` callers that each wait for their reply and then
  send the next request.  The first request of each client draws its
  remaining output uniformly from 1 to its drawn length, so completions
  are staggered from the start.

Sizes and arrival times are drawn from the mix's ``shape_seed``, so every
seed offers the same work and a seed repeats exactly.  The run's seed
draws the token ids and, in an open loop, orders the sizes over the
arrival times.  A closed loop sends its sizes in one order for every
seed: which of them a window reaches depends on that order, and a
seed-drawn order changed the work a window did (``PERF.md``).

Lengths are ``{"dist": "lognormal", "median": m, "sigma": s, "min": a,
"max": b}`` (rounded, clipped) or ``{"dist": "uniform", "min": a, "max":
b}`` (whole numbers, both ends included).  A ``prefix`` of ``{"count":
n, "tokens": t, "zipf_s": s}`` opens every prompt with one of n shared
prompts of t tokens, picked with Zipf popularity s.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Item:
    """One request to send: prompt tokens, output tokens to ask for, the
    due time in seconds after the window opens (open loop), and which
    shared prefix opens it (-1: none)."""
    prompt: list[int]
    max_new: int
    due: float | None = None
    prefix: int = -1


@dataclasses.dataclass
class Traffic:
    loop: str
    items: list[Item]            # open: every request of the window, by due time
    clients: int = 0             # closed: requests in flight
    prefixes: list | None = None  # the shared prompts, where the mix has them
    initial: list[Item] = dataclasses.field(default_factory=list)
    _next: object = None         # closed: the next request of the stream

    def next_item(self) -> Item:
        return self._next()


def _seed(seed: int) -> int:
    return seed % 2 ** 64        # SeedSequence takes non-negative whole numbers


def lengths(rng: np.random.Generator, spec: dict, n: int) -> np.ndarray:
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "lognormal":
        x = np.exp(np.log(spec["median"]) + spec["sigma"] * rng.standard_normal(n))
        return np.clip(np.rint(x), lo, hi).astype(np.int64)
    if spec["dist"] == "uniform":
        return rng.integers(lo, hi + 1, n).astype(np.int64)
    raise ValueError(f"length distribution {spec['dist']!r}")


def gaps(rng: np.random.Generator, mix: dict, seconds: float) -> np.ndarray:
    """Inter-arrival gaps whose sum stays inside the window."""
    if mix["arrivals"] != "poisson":
        raise ValueError(f"arrival process {mix['arrivals']!r}")
    rate = float(mix["rate"])
    g = rng.exponential(1.0 / rate, int(rate * seconds * 2) + 64)
    n = int(np.searchsorted(np.cumsum(g), seconds))
    return g[:n]


def _prefixes(mix: dict, seed: int, vocab: int) -> np.ndarray | None:
    p = mix.get("prefix")
    if not p:
        return None
    rng = np.random.default_rng([_seed(seed), 1])
    return rng.integers(0, vocab, (p["count"], p["tokens"]))


def _popularity(p: dict) -> np.ndarray:
    w = 1.0 / np.arange(1, p["count"] + 1) ** p["zipf_s"]
    return w / w.sum()


def _tokens(seed: int, i: int, n: int, vocab: int) -> list[int]:
    rng = np.random.default_rng([_seed(seed), 2, i])
    return rng.integers(0, vocab, n).tolist()


def build(mix: dict, seed: int, seconds: float, vocab: int) -> Traffic:
    shape = np.random.default_rng(int(mix["shape_seed"]))
    prefixes = _prefixes(mix, seed, vocab)
    if mix["loop"] == "open":
        order = np.random.default_rng([_seed(seed), 0])
        g = gaps(shape, mix, seconds)
        n = len(g)
        prompt = lengths(shape, mix["prompt"], n)
        out = lengths(shape, mix["output"], n)
        pick = (shape.choice(len(prefixes), n, p=_popularity(mix["prefix"]))
                if prefixes is not None else np.full(n, -1))
        due = np.cumsum(g)
        perm = order.permutation(n)
        items = []
        for i, j in enumerate(perm):
            head = prefixes[pick[j]].tolist() if pick[j] >= 0 else []
            items.append(Item(head + _tokens(seed, i, int(prompt[j]), vocab),
                              int(out[j]), float(due[i]), int(pick[j])))
        return Traffic("open", items,
                       prefixes=None if prefixes is None else prefixes.tolist())
    if mix["loop"] == "closed":
        clients, pool = int(mix["clients"]), int(mix["pool"])
        prompt = lengths(shape, mix["prompt"], pool)
        out = lengths(shape, mix["output"], pool)
        first = shape.integers(1, out[:clients] + 1)
        initial = [Item(_tokens(seed, i, int(prompt[i]), vocab), int(first[i]))
                   for i in range(clients)]
        count = [clients]

        def nxt() -> Item:
            i = count[0]
            if i >= pool:
                raise RuntimeError(f"closed loop: all {pool} requests of the mix sent")
            count[0] += 1
            return Item(_tokens(seed, i, int(prompt[i]), vocab), int(out[i]))

        return Traffic("closed", [], clients=clients, initial=initial, _next=nxt)
    raise ValueError(f"loop {mix['loop']!r}")
