"""Dense decoders (qwen2): every layer's MLP is one SwiGLU."""
from __future__ import annotations

from portbench.reference import decoder


def mlp(x, w, conf, seqs, spans, quant):
    return decoder.swiglu(x, w["w_gate"], w["w_up"], w["w_down"], quant)


def forward(weights, conf: dict, seqs: list[dict], *, quant: bool = False):
    return decoder.forward(weights, conf, seqs, mlp, quant=quant)
