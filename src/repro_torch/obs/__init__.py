"""Observability of the port: the metrics registry (`metrics`, a copy of
`repro.obs.metrics`). The span tracer `repro.obs.trace` is not ported yet
(ROADMAP Queue 1 item 8)."""
from . import metrics

__all__ = ["metrics"]
