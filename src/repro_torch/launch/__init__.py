"""Launch-side analysis of the port; `roofline` is the counterpart of the
JAX package's `repro.launch.roofline.kernel_cost` (the mesh, the cell specs
and the dry run wait for ROADMAP Queue 1 item 12)."""
from . import roofline
from .roofline import HBM_BW, PEAK_FP32, cost

__all__ = ["roofline", "HBM_BW", "PEAK_FP32", "cost"]
