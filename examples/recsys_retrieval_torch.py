"""Matrix-factorization recommendation retrieval (paper §I use case) on the
PyTorch/CUDA port: user vectors query an item-factor corpus; ProMIPS
returns probability-guaranteed top-10 items. Everything goes through the
unified `repro_torch.api` facade: the backend is a registry name (the
range-routed mutable ``sharded`` backend when several cards are present,
the single index otherwise); build, search and the churn loop's mutations
are the same calls either way. The same run as
`examples/recsys_retrieval.py`, on the card by default:

  PYTHONPATH=src python examples/recsys_retrieval_torch.py
  PYTHONPATH=src python examples/recsys_retrieval_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch import api
from repro_torch.baselines.exact import exact_topk
from repro_torch.core.index import resolve_device
from repro_torch.core.metrics import overall_ratio, recall_at_k
from repro_torch.data.synthetic import mf_factors

GUARANTEE = api.GuaranteeConfig(c=0.9, p0=0.7, k=10)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="where the searches run (default: the card; raises "
                         "without one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n_items, n_users, rank, d = 50_000, 32, 32, 128
    items = mf_factors(n_items, d, rank, decay=0.15, seed=0, norm_tail=0.3)
    users = mf_factors(n_users, d, rank, decay=0.15, seed=1)
    eids, escores = exact_topk(items, users, 10)

    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    backend = "sharded" if n_dev >= 2 else "promips"
    opts = dict(n_shards=n_dev) if backend == "sharded" else {}
    s = api.build(items, backend=backend, guarantee=GUARANTEE, seed=0,
                  m=8, mode="progressive", norm_strata=4, device=device,
                  **opts)
    res = s.search(users)

    ratios = [overall_ratio(res.scores[i], escores[i]) for i in range(n_users)]
    recalls = [recall_at_k(res.ids[i], eids[i]) for i in range(n_users)]
    print(f"recsys retrieval (backend={backend}, {n_dev} device(s)): "
          f"{n_items} items, {n_users} users")
    print(f"  ratio={np.mean(ratios):.4f} recall={np.mean(recalls):.3f} "
          f"total_pages={res.pages}")
    print(f"  sample user 0 recommended items: {res.ids[0][:5].tolist()}")

    rounds = churn_loop(items, users, device=device)
    return dict(backend=backend, ratio=float(np.mean(ratios)),
                recall=float(np.mean(recalls)), pages=res.pages,
                rounds=rounds)


def churn_loop(items, users, rounds: int = 4, device="cuda"):
    """Streaming catalog churn through the facade's uniform mutation
    surface: every round retires a slice of items, ships a batch of new
    ones, refreshes a few embeddings, then searches and reports recall
    against an exact scan of the current catalog (`alive_items`). Returns
    each round's ``(ids, recall)``."""
    n, d = items.shape
    rng = np.random.RandomState(7)
    s = api.build(items[: n // 2], backend="promips-stream",
                  guarantee=GUARANTEE, seed=0, m=8, norm_strata=4,
                  auto_compact=True, device=device)
    assert s.capabilities.supports_mutation
    alive = set(range(n // 2))
    next_id, k = n // 2, 10
    out = []

    print(f"churn loop: {len(alive)} items live (backend=promips-stream)")
    for r in range(rounds):
        dead = rng.choice(sorted(alive), size=1000, replace=False)
        s.delete(dead)
        alive.difference_update(dead.tolist())
        fresh = items[n // 2 + (r * 2000) % (n // 2):][:2000]
        gids = np.arange(next_id, next_id + len(fresh))
        next_id += len(fresh)
        s.insert(gids, fresh)
        alive.update(gids.tolist())
        refresh = rng.choice(sorted(alive), size=200, replace=False)
        s.update(refresh, rng.randn(len(refresh), d).astype(np.float32))

        res = s.search(users, k=k)
        # exact oracle over the live catalog (refreshed rows via the stream)
        cat_ids, cat_rows = s.alive_items()
        eids, _ = exact_topk(cat_rows, users, k)
        rec = np.mean([len(set(res.ids[i]) & set(cat_ids[eids[i]])) / k
                       for i in range(len(users))])
        out.append((res.ids, float(rec)))
        print(f"  round {r}: live={s.n} recall={rec:.3f} "
              f"pages={res.pages} wall={res.wall_time_s*1e3:.0f}ms")
    s.flush()
    print(f"  post-churn live={s.n}")
    return out


if __name__ == "__main__":
    main()
