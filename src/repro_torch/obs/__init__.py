"""Observability of the port: the span tracer (`trace`, the port of
`repro.obs.trace`, fenced by CUDA stream syncs) and the metrics registry
(`metrics`, a copy of `repro.obs.metrics`). Neither imports anything of
`repro_torch.core`, which imports them."""
from . import metrics, trace
from .trace import (configure, disable, enable, enabled, export_chrome_trace,
                    span)

__all__ = ["metrics", "trace", "span", "configure", "enable", "disable",
           "enabled", "export_chrome_trace"]
