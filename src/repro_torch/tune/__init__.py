"""The autotuner; port of `repro.tune`.

It fits the search's hardware knobs to the device: `tune.search.tune_point`
measures candidates on stage cutouts and full-search A/B pairs
(`tune.cutout`), gates every candidate on bitwise result parity, and records
the winners in the tuning cache (`tune.cache.save_entry`) under the key of
(n-bucket, d, device, torch version). The runtime, `api.build` and the serve
engine consult the cache wherever a tuned knob is left at None.

  PYTHONPATH=src python -m repro_torch.tune --n 100000 --d 128 --prefilter \\
      --budget-s 120 --write

This module imports only `space` and `cache`: `core.runtime` imports
`tune.cache` on the search path, so the measurement side (`cutout`,
`search`, which import the runtime) is imported by its callers.
"""
from . import cache, space
from .cache import lookup, resolved, save_entry
from .space import HAND_PICKED, KNOBS, Knob, knob, n_bucket, shape_key

__all__ = ["cache", "space", "lookup", "resolved", "save_entry",
           "HAND_PICKED", "KNOBS", "Knob", "knob", "n_bucket", "shape_key"]
