"""Observability of the port: request tracing and the metrics registry."""
from repro_torch.core.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                      MetricsRegistry, parse_exposition)
from repro_torch.core.tracing import (Span, Tracer,  # noqa: F401
                                      attribute_slo_misses, format_attribution,
                                      trace_id_hex)
