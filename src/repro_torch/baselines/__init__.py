"""The paper's baselines (Section VIII-A1) as numpy host engines; copies of
`repro.baselines`, with the same ids, scores and page counts at the same
seed."""
from .exact import ExactMIPS, exact_topk
from .h2_alsh import H2ALSH
from .pq import PQBased
from .range_lsh import RangeLSH

__all__ = ["ExactMIPS", "exact_topk", "H2ALSH", "RangeLSH", "PQBased"]
