"""The serve path of the port: `engine.DecodeEngine` (continuous batching,
exact or ProMIPS-approximate greedy logits) and its hot-query result cache
(`qcache`); port of `repro.serve` without the load generator."""
from .engine import DecodeEngine, DegradationPolicy, Request
from .qcache import HotQueryCache

__all__ = ["DecodeEngine", "DegradationPolicy", "HotQueryCache", "Request"]
