"""Request lifecycle objects shared by the engine and the control plane."""
from __future__ import annotations

import dataclasses
import enum
from typing import Any


class State(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    MIGRATING = "migrating"
    DONE = "done"
    REJECTED = "rejected"


@dataclasses.dataclass
class SamplingParams:
    temperature: float = 0.0        # 0 => greedy
    top_k: int = 0                  # 0 => off
    top_p: float = 1.0
    max_new_tokens: int = 16
    stop_token: int | None = None


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]                       # token ids
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    arrival: float | None = None            # event-clock seconds; stamped at submit
    slo_ttft: float | None = None           # seconds; None = best effort
    slo_tpot: float | None = None
    # multi-model / multi-tenant identity: ``model`` names the endpoint the
    # registry routes by; ``tenant`` drives per-tenant quotas and the
    # weighted-fair scheduler.  The control plane stamps "default" when a
    # tenant is unset so metric labels never carry empty strings.
    model: str | None = None
    tenant: str | None = None
    extras: dict[str, Any] = dataclasses.field(default_factory=dict)  # vlm patches / frames

    # --- lifecycle (engine-owned) ---
    state: State = State.QUEUED
    output: list[int] = dataclasses.field(default_factory=list)
    t_admit: float | None = None
    t_first_token: float | None = None
    t_finish: float | None = None
    token_times: list[float] = dataclasses.field(default_factory=list)
    row: int | None = None                  # engine batch slot
    replica: int | None = None              # control-plane placement
    migrations: int = 0
    preemptions: int = 0                    # times displaced from a row pre-finish
    prefix_hit_tokens: int = 0              # prompt tokens served from KV cache
    finish_reason: str | None = None        # "stop" | "length" (OpenAI-style)

    # ------------------------------------------------------------ metrics
    @property
    def ttft(self) -> float | None:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.arrival

    @property
    def tpot(self) -> float | None:
        """Mean time-per-output-token after the first."""
        if len(self.token_times) < 2:
            return None
        return (self.token_times[-1] - self.token_times[0]) / (len(self.token_times) - 1)

    @property
    def e2e(self) -> float | None:
        if self.t_finish is None:
            return None
        return self.t_finish - self.arrival

    def done(self) -> bool:
        return self.state in (State.DONE, State.REJECTED)

    def slo_met(self) -> bool:
        # explicit None checks: ``ttft == 0.0`` (first token in the arrival
        # step under a logical clock) and ``tpot == 0.0`` are legitimate
        # values — ``(x or default)`` would misread both as "missing"
        if self.slo_ttft is not None:
            ttft = self.ttft if self.ttft is not None else 1e30
            if ttft > self.slo_ttft:
                return False
        if self.slo_tpot is not None:
            tpot = self.tpot if self.tpot is not None else 0.0
            if tpot > self.slo_tpot:
                return False
        return True
