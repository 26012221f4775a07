"""Host-side fault policy of the distributed runtime (`fault.py`, a copy of
`repro.distributed.fault`). The sharded search itself is `core.sharded`."""
from .fault import ElasticPolicy, StragglerMonitor, restart_plan

__all__ = ["ElasticPolicy", "StragglerMonitor", "restart_plan"]
