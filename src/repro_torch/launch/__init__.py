"""Launch-side code of the port: `roofline` is the counterpart of the JAX
package's `repro.launch.roofline.kernel_cost`, `train` the training
driver (`python -m repro_torch.launch.train`) and `serve` the serving
driver (`python -m repro_torch.launch.serve`), `mesh` the meshes over
`torch.distributed` ranks and `specs` the abstract inputs and specs of
every (arch x shape x mesh) cell. The dry run and the roofline of a cell
(`roofline.analyse_cell`) wait for the split of the compute over the
``model`` axis (ROADMAP Queue 1 item 27)."""
from . import roofline
from .roofline import HBM_BW, PEAK_FP32, cost

__all__ = ["roofline", "HBM_BW", "PEAK_FP32", "cost"]
