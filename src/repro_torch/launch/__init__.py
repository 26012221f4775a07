"""Launch-side code of the port: `roofline` is the counterpart of the JAX
package's `repro.launch.roofline.kernel_cost`, `train` the training
driver (`python -m repro_torch.launch.train`) and `serve` the serving
driver (`python -m repro_torch.launch.serve`), `mesh` the meshes over
`torch.distributed` ranks and `specs` the abstract inputs and specs of
every (arch x shape x mesh) cell, `dryrun` the dry run of those cells (one
rank of the split program counted on ``meta``: ``python -m
repro_torch.launch.dryrun``) and `roofline.analyse_cell` / ``python -m
repro_torch.launch.roofline`` the roofline of a cell on the H100."""
from . import roofline
from .roofline import HBM_BW, PEAK_FP32, cost

__all__ = ["roofline", "HBM_BW", "PEAK_FP32", "cost"]
