"""The facade: `repro_torch.api.build(backend="promips")` and the
searcher's `.search`, as a user of the API calls them. The configuration's
``guarantee`` becomes the `GuaranteeConfig`, its ``build`` the backend's
options; the page size, the verification backend and the tuned tile knobs
come from the program's defaults and its tuning cache. The facade reports
the batch's pages as a total."""
from __future__ import annotations

from .common import free, index_meta, prepare  # noqa: F401


class Sut:
    def __init__(self, x, config: dict, seed: int, device, k: int):
        from repro_torch import api
        self.device, self.k = device, k
        self.searcher = api.build(
            x, backend="promips",
            guarantee=api.GuaranteeConfig(**config["guarantee"]), seed=seed,
            device=device, **config["build"])
        self.meta = index_meta(self.searcher.pm.meta)

    def search(self, q):
        res = self.searcher.search(q, k=self.k)
        return res.ids, res.scores, int(res.stats["pages"])

    def close(self) -> None:
        del self.searcher
        free(self.device)


def build(x, config: dict, seed: int, device, k: int) -> Sut:
    return Sut(x, config, seed, device, k)
