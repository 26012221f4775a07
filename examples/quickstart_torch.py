"""Quickstart of the PyTorch/CUDA port: the unified index API
(`repro_torch.api`), on the card by default.

Declare the paper's guarantee ("c-AMIP results with probability >= p0")
once as a `GuaranteeConfig`; every registered backend builds and searches
behind the same facade, returns the same `SearchResult`, and persists with
`save` / `load` (a loaded index searches bit-identically). The same flow as
`examples/quickstart.py`, through the port:

  PYTHONPATH=src python examples/quickstart_torch.py               # the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # plain path
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch import api
from repro_torch.baselines.exact import exact_topk
from repro_torch.core.metrics import overall_ratio, recall_at_k
from repro_torch.data.synthetic import paper_dataset, paper_queries

# every backend behind the same build / search calls
SWEEP = (
    ("promips", dict(m=6)),
    ("promips", dict(m=6, mode="progressive")),
    ("h2alsh", {}),
    ("rangelsh", {}),
    ("pq", dict(n_cells=32)),
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="where the searches run (default: the card; raises "
                         "without one)")
    ap.add_argument("--n", type=int, default=None,
                    help="first n rows of the corpus (default: all 17,770)")
    args = ap.parse_args(argv)

    # Netflix-like PureSVD factors (paper Table III shape: 17770 x 300)
    x = paper_dataset("netflix")[:args.n]
    queries = paper_queries("netflix", 16)
    print(f"corpus {x.shape}, queries {queries.shape}, device {args.device}")

    # the declarative contract: c-AMIP with probability >= p0, top-k.
    # m, radii and Quick-Probe budgets are DERIVED (paper §V-B), not picked:
    guarantee = api.GuaranteeConfig(c=0.9, p0=0.5, k=10)
    plan = guarantee.derive(len(x))
    print(f"derived plan: m={plan.m} x_p={plan.x_p:.3f} "
          f"probe_cost={plan.probe_cost:.0f} "
          f"budget={'all blocks' if plan.budget is None else plan.budget}")

    eids, escores = exact_topk(x, queries, 10)
    for backend, opts in SWEEP:
        s = api.build(x, backend=backend, guarantee=guarantee, seed=0,
                      device=args.device, **opts)
        res = s.search(queries)  # one batched call, any backend
        ratios = [overall_ratio(res.scores[i], escores[i])
                  for i in range(len(queries))]
        recalls = [recall_at_k(res.ids[i], eids[i])
                   for i in range(len(queries))]
        label = backend + ("+" if opts.get("mode") == "progressive" else "")
        print(f"{label:12s} guaranteed={s.capabilities.guaranteed!s:5s} "
              f"ratio={np.mean(ratios):.4f} "
              f"P[ratio>=c]={np.mean([r >= 0.9 for r in ratios]):.2f} "
              f"recall={np.mean(recalls):.3f} "
              f"pages/q={res.pages / len(queries):.0f} "
              f"index={s.index_bytes / 1e6:.2f}MB")

    # persistence: save -> load -> search is bit-identical
    s = api.build(x, backend="promips", guarantee=guarantee, seed=0, m=6,
                  device=args.device)
    before = s.search(queries)
    with tempfile.TemporaryDirectory() as td:
        path = s.save(os.path.join(td, "netflix_idx"))
        disk = api.saved_bytes(path)
        after = api.load(path, device=args.device).search(queries)
    same = (np.array_equal(before.ids, after.ids)
            and np.array_equal(before.scores, after.scores))
    print(f"save/load round trip: {disk / 1e6:.2f}MB on disk, "
          f"bit-identical={same}")
    return same


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
