"""Load balancing (paper §3 'Load balancing').

Istio-style request routing over the replicas of one (micro)service.
Policies: round-robin, least-outstanding-requests, power-of-two-choices,
weighted join-shortest-queue (weights = replica capacity, e.g. heterogeneous
hardware), prefix-affinity routing ("prefix": requests sharing a prompt
prefix rendezvous-hash to the same replica so its paged-KV prefix cache
keeps serving them), and cluster-directory routing ("directory": replicas
are scored by the *actual* cached-token overlap the cluster cache directory
reports for the whole prompt — beyond the first block — blended with load
slack).  Both locality policies carry a load guard: locality must never
create a hotspot.
"""
from __future__ import annotations

import hashlib
import random
from typing import Callable, Hashable, Sequence


def _rendezvous(key: Hashable, idx: int) -> int:
    h = hashlib.blake2b(f"{key!r}/{idx}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


class LoadBalancer:
    def __init__(self, policy: str = "p2c", seed: int = 0,
                 affinity_slack: float = 4.0,
                 directory=None, directory_load_weight: float = 4.0):
        assert policy in ("rr", "least", "p2c", "wjsq", "prefix", "directory")
        self.policy = policy
        self._rr = 0
        self._rng = random.Random(seed)
        # "prefix": max load gap over the coolest replica before affinity
        # yields to load balancing
        self.affinity_slack = affinity_slack
        # "directory": the ClusterCacheDirectory scored against, and how
        # many cached prompt tokens one unit of load is worth — the blend
        # that keeps cache-chasing from piling requests on one replica
        self.directory = directory
        self.directory_load_weight = directory_load_weight
        self._m_picks = None

    def attach_metrics(self, registry) -> None:
        """Bind routing instruments onto a cluster metrics registry."""
        self._m_picks = registry.counter(
            "lb_routing_decisions_total", "Routing decisions, by policy",
            ("policy",))

    def pick(self, replicas: Sequence, load: Callable[[object], float],
             weight: Callable[[object], float] = lambda r: 1.0,
             affinity_key: Hashable | None = None,
             tokens: Sequence[int] | None = None,
             block_size: int = 16) -> object:
        """Choose a replica.  ``load(r)`` = outstanding work (queue depth or
        busy seconds); ``weight(r)`` = capacity multiplier; ``affinity_key``
        = routing key for the "prefix" policy (e.g. the prompt's first KV
        block of tokens); ``tokens``/``block_size`` = the whole prompt for
        the "directory" policy's cluster-radix overlap walk."""
        live = [r for r in replicas]
        assert live, "no replicas"
        if self._m_picks is not None:
            self._m_picks.inc(policy=self.policy)
        if len(live) == 1:
            return live[0]
        if self.policy == "rr":
            # post-increment: replica 0 gets the first pick and the rotation
            # stays unbiased when the replica count changes
            i = self._rr % len(live)
            self._rr += 1
            return live[i]
        if self.policy == "least":
            return min(live, key=load)
        if self.policy == "p2c":
            a, b = self._rng.sample(live, 2)
            return a if load(a) <= load(b) else b
        if self.policy == "prefix":
            if affinity_key is None:
                return min(live, key=load)
            lo = min(load(r) for r in live)
            # rendezvous-hash on a stable replica identity (not the list
            # position): membership churn then remaps only the keys that
            # hashed to the departed replica, keeping warm caches warm
            ranked = sorted(live, key=lambda r: _rendezvous(
                affinity_key, getattr(r, "lb_id", id(r))), reverse=True)
            # always terminates: the minimum-load replica passes the guard
            return next(r for r in ranked
                        if load(r) <= lo + self.affinity_slack)
        if self.policy == "directory":
            if self.directory is None or tokens is None:
                return min(live, key=load)
            ov = self.directory.overlaps(tokens, block_size)
            lo = min(load(r) for r in live)
            # expected cached tokens minus the load premium over the coolest
            # replica: a replica must bring directory_load_weight extra
            # cached tokens per unit of extra load to justify the pick.
            # Cold directory / no overlap degrades to least-loaded exactly.
            def score(r):
                o = ov.get(getattr(r, "lb_id", id(r)), 0)
                return o - self.directory_load_weight * (load(r) - lo)
            best = max(live, key=lambda r: (score(r), -load(r)))
            return best
        # weighted JSQ: smallest load normalised by capacity
        return min(live, key=lambda r: load(r) / max(weight(r), 1e-9))
