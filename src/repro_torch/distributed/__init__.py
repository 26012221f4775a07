"""Host-side fault policy (`fault.py`, a copy of `repro.distributed.fault`),
the train state's checkpoints (`checkpoint.py`: sharded saves written
whole, restores that reshard), the error-feedback gradient compression and
`int8_psum` (`compression.py`) and the sharding rules with the pieces they
give each rank (`sharding.py`) and the split of the compute over the
``model`` axis (`tensor_parallel.py`: the collectives GSPMD inserts, as
autograd functions with their conjugate backwards; the decode step
follows the cache's layout, `sharding.kv_layout`). The sharded search
itself is `core.sharded`."""
from .fault import ElasticPolicy, StragglerMonitor, restart_plan

__all__ = ["ElasticPolicy", "StragglerMonitor", "restart_plan"]
