"""The serve path of the port: `engine.DecodeEngine` (continuous batching,
exact or ProMIPS-approximate greedy logits, the decode step replayed as a
CUDA graph on the card), its hot-query result cache (`qcache`) and the
open-loop Zipfian load generator (`loadgen`); port of `repro.serve`."""
from .engine import DecodeEngine, DegradationPolicy, Request
from .loadgen import Arrival, LoadgenConfig, generate, run_load
from .qcache import HotQueryCache

__all__ = ["DecodeEngine", "DegradationPolicy", "Request", "HotQueryCache",
           "Arrival", "LoadgenConfig", "generate", "run_load"]
