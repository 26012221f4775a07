"""END-TO-END DRIVER (paper kind = search/serving) on the PyTorch/CUDA
port: serve a small LM with batched requests through the
continuous-batching engine, comparing exact greedy decoding against
ProMIPS approximate-logit decoding, the paper's c-AMIP search applied to
the decode-time vocabulary MIPS problem. The same run as
`examples/serve_lm_promips.py`, on the card by default:

  PYTHONPATH=src python examples/serve_lm_promips_torch.py
  PYTHONPATH=src python examples/serve_lm_promips_torch.py --device cpu

The parameters come from a `torch.Generator` seeded with 0 (the JAX
example draws its own from the JAX PRNG); the prompts are the JAX
example's.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.index import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve.engine import DecodeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="where the model and the searches run (default: the "
                         "card; raises without one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config("phi4-mini-3.8b").reduced()  # family-faithful small model
    params = T.init_params(cfg, seed=0, device=device)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab, size=24) for _ in range(12)]

    results = {}
    for mode in ("exact", "promips"):
        eng = DecodeEngine(params, cfg, batch_slots=4, max_len=128,
                           logits_mode=mode,
                           promips_kwargs=dict(m=8, c=0.95, p=0.95),
                           device=device)
        reqs = [eng.submit(p, max_new_tokens=12) for p in prompts]
        t0 = time.time()
        eng.run()
        dt = time.time() - t0
        toks = sum(len(r.out_tokens) for r in reqs)
        results[mode] = [r.out_tokens for r in reqs]
        print(f"{mode:8s}: {len(reqs)} reqs, {toks} tokens, {dt:.1f}s "
              f"({toks/dt:.1f} tok/s), engine steps {eng.steps}, "
              f"logit pages touched {eng.pages}")

    agree = np.mean([a == b for a, b in zip(results["exact"], results["promips"])])
    per_tok = np.mean([np.mean([x == y for x, y in zip(a, b)])
                       for a, b in zip(results["exact"], results["promips"])])
    print(f"greedy agreement: {agree:.2f} of sequences identical, "
          f"{per_tok:.3f} of tokens identical")
    return results


if __name__ == "__main__":
    main()
