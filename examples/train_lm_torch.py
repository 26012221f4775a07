"""Train a reduced LM for a few hundred steps with checkpoint/resume through
the PyTorch/CUDA port, on the card by default: the trainer, AdamW,
microbatching and the fault-tolerance path. The same run as
`examples/train_lm.py`, through `repro_torch.launch.train`:

  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]
  PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20
"""
import argparse
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default: the card; raises "
                         "without one)")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(ROOT, "build", "train_lm_torch_ckpt"),
                    help="checkpoint directory (default: the gitignored "
                         "build/ of the checkout)")
    args = ap.parse_args(argv)
    losses = train_main([
        "--arch", args.arch, "--reduced", "--device", args.device,
        "--steps", str(args.steps), "--batch", "8", "--seq", "256",
        "--microbatches", "2",
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "50", "--log-every", "20",
    ])
    print(f"checkpoints in {args.ckpt_dir}; rerun to resume from the latest step")
    return losses


if __name__ == "__main__":
    main()
