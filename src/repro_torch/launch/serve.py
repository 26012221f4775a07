"""Serving driver of the port: batched requests through the
continuous-batching engine; counterpart of `repro.launch.serve`.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \\
      --reduced --requests 12 --logits-mode promips

Every config of the registry runs, the recurrent ``--arch xlstm-1.3b`` and
``--arch zamba2-1.2b`` included.

The JAX driver's flags, plus ``--device`` (default ``cuda``: the card, and
a `RuntimeError` naming CUDA without one; ``--device cpu`` runs the plain
versions on the CPU). The parameters come from a `torch.Generator` seeded
with 0 (not the JAX PRNG: the draws differ from the JAX driver's); the
prompts are the JAX driver's, from ``RandomState(0)``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs import get_config
from ..core.index import resolve_device
from ..models import transformer as model_lib
from ..serve.engine import DecodeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--logits-mode", choices=("exact", "promips"), default="exact")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = model_lib.init_params(cfg, seed=0, device=device)
    engine = DecodeEngine(params, cfg, batch_slots=args.slots,
                          max_len=args.max_len, logits_mode=args.logits_mode,
                          device=device)
    rng = np.random.RandomState(0)
    reqs = [engine.submit(rng.randint(1, cfg.vocab, size=args.prompt_len),
                          max_new_tokens=args.max_new)
            for _ in range(args.requests)]
    t0 = time.time()
    engine.run()
    dt = time.time() - t0
    total_tokens = sum(len(r.out_tokens) for r in reqs)
    print(f"served {len(reqs)} requests, {total_tokens} tokens in {dt:.1f}s "
          f"({total_tokens / max(dt, 1e-9):.1f} tok/s, engine steps {engine.steps}, "
          f"logit pages {engine.pages})")
    for i, r in enumerate(reqs[:3]):
        print(f"  req{i}: {r.out_tokens[:10]}...")
    return reqs


if __name__ == "__main__":
    main()
