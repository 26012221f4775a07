"""The autotuner's declared knobs (`space`) and the read side of its tuning
cache (`cache`); the tuner that writes the cache is not ported yet (ROADMAP
Queue 1 item 10)."""
from . import cache, space
from .cache import lookup, resolved
from .space import HAND_PICKED, KNOBS, Knob, knob, n_bucket, shape_key

__all__ = ["cache", "space", "lookup", "resolved", "HAND_PICKED", "KNOBS",
           "Knob", "knob", "n_bucket", "shape_key"]
