"""CLI: tune one (n, d) point on a device and optionally write its cache
entry; port of `python -m repro.tune`.

Defaults match the LARGE_N benchmark point, so a written entry covers the
shape the port's main path runs at. ``--device`` defaults to the card and
raises without one (pass ``--device cpu`` for the plain path):

  PYTHONPATH=src python -m repro_torch.tune --prefilter --budget-s 120 --write
"""
from __future__ import annotations

import argparse
import json

from . import cutout, search


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--n-q", type=int, default=64)
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--decay", type=float, default=0.5)
    ap.add_argument("--norm-tail", type=float, default=0.6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--k-p", type=int, default=8)
    ap.add_argument("--k-sp", type=int, default=8)
    ap.add_argument("--norm-strata", type=int, default=8)
    ap.add_argument("--c", type=float, default=0.9)
    ap.add_argument("--p", type=float, default=0.6)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--prefilter", action="store_true")
    ap.add_argument("--prefilter-eps", type=float, default=0.1)
    ap.add_argument("--budget-s", type=float, default=120.0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="device to tune on (default: the card; raises "
                         "without one)")
    ap.add_argument("--include-build", action="store_true",
                    help="also tune rebuild-requiring knobs (page_bytes, "
                         "max_probe_groups): one index rebuild per "
                         "candidate")
    ap.add_argument("--write", action="store_true",
                    help="save the entry to the tuning cache "
                         "(results/tune/tuning.json or $REPRO_TUNE_CACHE)")
    ap.add_argument("--out", default=None,
                    help="explicit cache path (implies --write)")
    args = ap.parse_args(argv)

    x, q = cutout.make_cutout(args.n, args.d, args.n_q, rank=args.rank,
                              decay=args.decay, norm_tail=args.norm_tail,
                              seed=args.seed)
    build_opts = dict(m=args.m, c=args.c, p=args.p, k_p=args.k_p,
                      k_sp=args.k_sp, norm_strata=args.norm_strata,
                      seed=args.seed)
    search_opts = dict(k=args.k, norm_adaptive=True, cs_prune=True,
                       prefilter=args.prefilter,
                       prefilter_eps=args.prefilter_eps)
    entry = search.tune_point(
        x, q, build_opts=build_opts, search_opts=search_opts,
        device=args.device, budget_s=args.budget_s, reps=args.reps,
        include_build=args.include_build,
        write=args.write or args.out is not None, path=args.out,
        progress=print)
    print(json.dumps({"key": entry.get("key"), "runtime": entry["runtime"],
                      "build": entry["build"],
                      "summary": entry["trace"]["summary"]}, indent=1))


if __name__ == "__main__":
    main()
