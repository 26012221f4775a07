"""The control of `correct`: the reference put in the program's place at the
next precision below the configuration's (TF32 for float32 with TF32 off),
run through the cell's own loop, check and limits. It has to come out as
not correct. The benchmark's own runs never run it.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 2

runs the control at the cell's own size, one seed after another in this one
process (each seed's corpus is made anew; there is no index to build), and
prints each seed's readings and result line. `--device cpu` (tests only)
runs it on the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class ControlSut:
    """`reference.ControlSearch` behind the entry points' interface."""

    def __init__(self, x, config, seed, device, k):
        from portbench import spec
        ref = spec.reference_module(config["reference"])
        self.search = ref.ControlSearch(x, k, device)
        self.insert, self.delete = self.search.insert, self.search.delete
        self.meta = None

    def snapshot(self):
        pass

    def close(self):
        del self.search


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # this folder's modules are imported as `portbench.*` only
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    for path in (os.path.join(ROOT, "src"), ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)
    from portbench import harness
    failed = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        print(f"control {args.workload} seed {seed}", flush=True)
        res = harness.run(args.workload, seed, args.seconds, False,
                          device=args.device, make_sut=ControlSut)
        failed += not res["correct"]
    n = len(args.seeds.split(","))
    print(f"control {args.workload}: {failed} of {n} seeds not correct")
    return 0


if __name__ == "__main__":
    sys.exit(main())
