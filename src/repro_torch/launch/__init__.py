"""Launch-side code of the port: `roofline` is the counterpart of the JAX
package's `repro.launch.roofline.kernel_cost`, `train` the training
driver (`python -m repro_torch.launch.train`) and `serve` the serving
driver (`python -m repro_torch.launch.serve`). The mesh, the cell specs
and the dry run (which import the mesh and `distributed.sharding`) wait
for the multi-card training slice (ROADMAP Queue 1 item 17)."""
from . import roofline
from .roofline import HBM_BW, PEAK_FP32, cost

__all__ = ["roofline", "HBM_BW", "PEAK_FP32", "cost"]
