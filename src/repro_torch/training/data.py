"""Synthetic-but-learnable data pipeline, the reference's ``training/data.py``.

Tokens are drawn from a fixed random bigram chain (per seed), so models have
real structure to learn (loss drops well below uniform) while the pipeline
stays fully deterministic and resumable: batch i is a pure function of
(seed, i) — restart-safe without data-state checkpoints beyond the step.
The draws are the reference's, numpy call for call, so batch i is
bit-identical to the reference's; the arrays become torch tensors on the
stream's device (tokens and labels int64, patches and frames float32).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


@dataclasses.dataclass
class DataConfig:
    batch: int = 8
    seq_len: int = 64
    seed: int = 17
    branching: int = 4          # candidate successors per token


class BigramStream:
    def __init__(self, cfg: ModelConfig, dcfg: DataConfig, device=None):
        """``device`` as for ``resolve_device``: the GPU unless the CPU is
        asked for."""
        self.cfg = cfg
        self.dcfg = dcfg
        self.device = resolve_device(device)
        rng = np.random.default_rng(dcfg.seed)
        V = cfg.vocab_size
        # successor table (V, branching) + logits
        self.succ = rng.integers(0, V, size=(V, dcfg.branching), dtype=np.int64)
        self.probs = rng.dirichlet(np.ones(dcfg.branching), size=V).astype(np.float64)

    def batch(self, step: int) -> dict:
        d = self.dcfg
        rng = np.random.default_rng((d.seed, step))
        B, S, V = d.batch, d.seq_len, self.cfg.vocab_size
        toks = np.empty((B, S), np.int64)
        toks[:, 0] = rng.integers(0, V, B)
        for t in range(1, S):
            cur = toks[:, t - 1]
            choice = np.array([rng.choice(d.branching, p=self.probs[c])
                               for c in cur])
            toks[:, t] = self.succ[cur, choice]
        tokens = torch.from_numpy(toks).to(self.device)
        out = {"tokens": tokens, "labels": tokens.clone()}
        if self.cfg.num_vision_tokens:
            out["patches"] = self._normal(rng, (B, self.cfg.num_vision_tokens,
                                                self.cfg.d_model))
        if self.cfg.is_encoder_decoder:
            out["frames"] = self._normal(rng, (B, self.cfg.encoder_seq, self.cfg.d_model))
        return out

    def _normal(self, rng, shape) -> torch.Tensor:
        return torch.from_numpy(rng.normal(0, 0.02, shape).astype(np.float32)).to(self.device)

    def uniform_nll(self) -> float:
        return float(np.log(self.cfg.vocab_size))
