"""`repro_torch.stream.mutable.MutableProMIPS`: the same host build as
`ProMIPS.build` (the configuration's ``build``, the rows in id order) as the
base segment, a delta segment on the host for inserted rows, tombstones for
deletes, and `.search` (`core/runtime.py` `search_segments`: the base's fused
search, over-fetching past its tombstones, merged with `ops.mips_score` over
the snapshot's delta prefix). The configuration's ``search`` becomes the
`RuntimeConfig`. The pages reported are the base search's
(`StreamStats.base`), the ones `block_mips` verifies."""
from __future__ import annotations

from .common import free, index_meta, prepare  # noqa: F401


class Sut:
    def __init__(self, x, config: dict, seed: int, device, k: int):
        from repro_torch.core.runtime import RuntimeConfig
        from repro_torch.stream.mutable import MutableProMIPS
        self.device, self.k = device, k
        self.index = MutableProMIPS(x, device=device, seed=seed,
                                    **config["build"])
        self.meta = index_meta(self.index.meta)
        self.runtime = RuntimeConfig(**config.get("search", {}))

    def insert(self, ids, rows) -> None:
        self.index.insert(ids, rows)

    def delete(self, ids) -> None:
        self.index.delete(ids)

    def snapshot(self) -> None:
        self.index.snapshot()

    def search(self, q):
        ids, scores, stats = self.index.search(q, k=self.k,
                                               runtime=self.runtime)
        return ids.cpu().numpy(), scores.cpu().numpy(), stats.base.pages

    def close(self) -> None:
        del self.index
        free(self.device)


def build(x, config: dict, seed: int, device, k: int) -> Sut:
    return Sut(x, config, seed, device, k)
