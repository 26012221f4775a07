"""Host-side fault policy (`fault.py`, a copy of `repro.distributed.fault`),
the train state's checkpoints (`checkpoint.py`) and the error-feedback
gradient compression (`compression.py`). The sharded search itself is
`core.sharded`; the collectives and parameter shardings wait for the
multi-card training slice (ROADMAP Queue 1 item 17)."""
from .fault import ElasticPolicy, StragglerMonitor, restart_plan

__all__ = ["ElasticPolicy", "StragglerMonitor", "restart_plan"]
