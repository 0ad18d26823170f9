"""The paper's contribution, ported: the cloud-native control plane for LLM
serving.

Modules map 1:1 to the paper's six platform components: loadbalancer,
autoscaler, migration, predictor, profiler, microservice (``StagePipeline``,
the model split into stage microservices) — plus the cluster simulator
(``SimCluster``) and the real-engine orchestrator that host them, the
proactive scaling policy, the cluster cache directory, the simulated
transport, prefill/decode disaggregation, the multi-model endpoint registry,
request tracing and the metrics registry.
"""
from repro_torch.core.autoscaler import Autoscaler, HPAConfig  # noqa: F401
from repro_torch.core.cache_directory import ClusterCacheDirectory, DirectoryStats  # noqa: F401
from repro_torch.core.cluster import ClusterConfig, SimCluster  # noqa: F401
from repro_torch.core.endpoints import (EndpointRegistry, ModelEndpoint,  # noqa: F401
                                        TenantQuota)
from repro_torch.core.loadbalancer import LoadBalancer  # noqa: F401
from repro_torch.core.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                      MetricsRegistry, parse_exposition)
from repro_torch.core.microservice import StagedLM, StagePipeline  # noqa: F401
from repro_torch.core.migration import MigrationConfig, MigrationManager  # noqa: F401
from repro_torch.core.predictor import EWMA, HoltWinters, WindowedAR, make_predictor  # noqa: F401
from repro_torch.core.profiler import Profiler  # noqa: F401
from repro_torch.core.tracing import (Span, Tracer,  # noqa: F401
                                      attribute_slo_misses, trace_id_hex)
