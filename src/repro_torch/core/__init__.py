"""The cloud-native control plane of the port: load balancer, autoscaler
and proactive scaling policy, predictors, profiler, live migration over a
simulated transport, the cluster cache directory, the real-engine
orchestrator, prefill/decode disaggregation and the multi-model endpoint
registry — plus request tracing and the metrics registry."""
from repro_torch.core.autoscaler import Autoscaler, HPAConfig  # noqa: F401
from repro_torch.core.cache_directory import ClusterCacheDirectory, DirectoryStats  # noqa: F401
from repro_torch.core.endpoints import (EndpointRegistry, ModelEndpoint,  # noqa: F401
                                        TenantQuota)
from repro_torch.core.loadbalancer import LoadBalancer  # noqa: F401
from repro_torch.core.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                      MetricsRegistry, parse_exposition)
from repro_torch.core.migration import MigrationConfig, MigrationManager  # noqa: F401
from repro_torch.core.predictor import EWMA, HoltWinters, WindowedAR, make_predictor  # noqa: F401
from repro_torch.core.profiler import Profiler  # noqa: F401
from repro_torch.core.tracing import (Span, Tracer,  # noqa: F401
                                      attribute_slo_misses, format_attribution,
                                      trace_id_hex)
