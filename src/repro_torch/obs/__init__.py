"""Observability layer: span tracing, metrics, Chrome trace export.

A copy of src/repro/obs/ with the port's import paths (the port imports
nothing of `repro`); its traces name `repro_torch.obs` as their source.
See docs/observability.md for the span taxonomy, the trace-event
schema, and the histogram error-bound derivation.
"""
from repro_torch.obs.export import to_chrome_trace
from repro_torch.obs.metrics import (DEFAULT_GROWTH, DEFAULT_LO, Counter,
                                     Gauge, Histogram, MetricsRegistry)
from repro_torch.obs.tracer import PHASE_CATS, Span, Tracer, TraceSummary
from repro_torch.obs.validate import (CONSERVATION_TOL_US,
                                      validate_chrome_trace)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_GROWTH",
    "DEFAULT_LO",
    "Span",
    "Tracer",
    "TraceSummary",
    "PHASE_CATS",
    "to_chrome_trace",
    "validate_chrome_trace",
    "CONSERVATION_TOL_US",
]
