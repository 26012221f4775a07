"""Host-side fault policy (`fault.py`, a copy of `repro.distributed.fault`),
the train state's checkpoints (`checkpoint.py`: sharded saves written
whole, restores that reshard), the error-feedback gradient compression and
`int8_psum` (`compression.py`) and the sharding rules with the pieces they
give each rank (`sharding.py`). The sharded search itself is
`core.sharded`. The ranks compute on whole parameters; splitting the
compute over the ``model`` axis is ROADMAP Queue 1 item 27."""
from .fault import ElasticPolicy, StragglerMonitor, restart_plan

__all__ = ["ElasticPolicy", "StragglerMonitor", "restart_plan"]
