"""The index API of the port (`repro.api`'s facade, so far for the
``promips-stream`` backend):

>>> from repro_torch import api
>>> s = api.build(x, backend="promips-stream",
...               guarantee=api.GuaranteeConfig(c=0.9, p0=0.9, k=4))
>>> res = s.search(queries)             # SearchResult(ids, scores, stats)
>>> s.delete([3]); s.update([5], row)   # the mutation contract
"""
from .base import Searcher, UnsupportedOperation
from .registry import backends, build, get_backend, register
from .types import (Capabilities, GuaranteeConfig, GuaranteePlan,
                    SearchResult, STAT_KEYS)

# importing the module registers the built-in backends
from . import adapters as _builtin_adapters  # noqa: E402,F401

__all__ = [
    "Searcher", "UnsupportedOperation",
    "backends", "build", "get_backend", "register",
    "Capabilities", "GuaranteeConfig", "GuaranteePlan", "SearchResult",
    "STAT_KEYS",
]
