"""The autotuner's declared knobs (`space`); the tuner and its cache are not
ported yet (ROADMAP Queue 1 item 10)."""
from .space import HAND_PICKED, KNOBS, Knob, knob, n_bucket

__all__ = ["HAND_PICKED", "KNOBS", "Knob", "knob", "n_bucket"]
