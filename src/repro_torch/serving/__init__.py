from repro_torch.serving.api import (SSE_DONE, CompletionChunk,  # noqa: F401
                               CompletionError, CompletionRequest,
                               CompletionResponse, CompletionsAPI,
                               ModelInfo, ModelList, ModelsAPI, StreamDemux)
from repro_torch.serving.engine import InferenceEngine, StepStats  # noqa: F401
from repro_torch.serving.events import (EngineEvent, FinishEvent,  # noqa: F401
                                  FirstTokenEvent, PreemptEvent, TokenEvent)
from repro_torch.serving.prefix_cache import PrefixCache  # noqa: F401
from repro_torch.serving.request import Request, SamplingParams, State  # noqa: F401
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig  # noqa: F401
