"""Launch-side code of the port: `roofline` is the counterpart of the JAX
package's `repro.launch.roofline.kernel_cost`, `train` the training
driver (`python -m repro_torch.launch.train`) and `serve` the serving
driver (`python -m repro_torch.launch.serve`). The mesh waits for the
multi-card training slice (ROADMAP Queue 1 item 17), the cell specs and
the dry run for item 12."""
from . import roofline
from .roofline import HBM_BW, PEAK_FP32, cost

__all__ = ["roofline", "HBM_BW", "PEAK_FP32", "cost"]
