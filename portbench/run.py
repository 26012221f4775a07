"""Run one cell of the port's benchmark once on one card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Exits non-zero, printing no result, without a
CUDA device (or with fewer than the cell asks for), without the port's
package beside this folder, or if a module of JAX or of the JAX package was
loaded. The last line of standard output is the result's JSON object.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # this folder's modules are imported as `portbench.*` only
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    for path in (os.path.join(ROOT, "src"), ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)
    import torch
    from portbench import harness, spec
    cell = spec.find_cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s), this machine has {have}", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails here without the port)
    harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                cell=cell)
    return 0


if __name__ == "__main__":
    sys.exit(main())
