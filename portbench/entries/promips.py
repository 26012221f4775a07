"""`repro_torch.core.promips.ProMIPS`: `ProMIPS.build` on the host, the
index's arrays on the card, and `.search` (the runtime's fused two-phase
search, the main path). The configuration's ``build`` goes to `build`, its
``search`` to `.search`; knobs it leaves out take the program's defaults
and its tuning cache."""
from __future__ import annotations

from .common import free, index_meta, prepare  # noqa: F401


class Sut:
    def __init__(self, x, config: dict, seed: int, device, k: int):
        from repro_torch.core.promips import ProMIPS
        self.device = device
        self.pm = ProMIPS.build(x, seed=seed, device=device,
                                **config["build"])
        self.meta = index_meta(self.pm.meta)
        self.kw = dict(config.get("search", {}), k=k)

    def search(self, q):
        ids, scores, stats = self.pm.search(q, **self.kw)
        return ids.cpu().numpy(), scores.cpu().numpy(), stats.pages

    def close(self) -> None:
        del self.pm
        free(self.device)


def build(x, config: dict, seed: int, device, k: int) -> Sut:
    return Sut(x, config, seed, device, k)
