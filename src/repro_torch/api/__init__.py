"""The index API of the port (`repro.api`'s facade):

>>> from repro_torch import api
>>> s = api.build(x, backend="promips-stream",
...               guarantee=api.GuaranteeConfig(c=0.9, p0=0.9, k=4))
>>> res = s.search(queries)             # SearchResult(ids, scores, stats)
>>> s.delete([3]); s.update([5], row)   # the mutation contract
>>> s.save("idx_dir"); s2 = api.load("idx_dir")   # bit-identical round trip
>>> api.backends()
('exact', 'h2alsh', 'pq', 'promips', 'promips-stream', 'rangelsh', 'sharded')
"""
from .base import (CorruptSnapshotError, Searcher, UnsupportedOperation,
                   read_header, saved_bytes)
from .registry import backends, build, get_backend, iter_backends, load, register
from .types import (Capabilities, GuaranteeConfig, GuaranteePlan,
                    SearchResult, STAT_KEYS)

# importing the module registers the built-in backends
from . import adapters as _builtin_adapters  # noqa: E402,F401
from .adapters import ShardedSearcher  # noqa: E402

__all__ = [
    "CorruptSnapshotError", "Searcher", "UnsupportedOperation",
    "read_header", "saved_bytes",
    "backends", "build", "get_backend", "iter_backends", "load", "register",
    "Capabilities", "GuaranteeConfig", "GuaranteePlan", "SearchResult",
    "STAT_KEYS", "ShardedSearcher",
]
