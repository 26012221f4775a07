"""End-to-end training driver of the port; counterpart of
`repro.launch.train`.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --steps 200 --batch 8 --seq 256 --reduced --ckpt-dir /tmp/ckpt

Every config of the registry trains, the recurrent ``--arch xlstm-1.3b``
and ``--arch zamba2-1.2b`` too. It runs on the card unless ``--device
cpu`` is given, and keeps the JAX driver's fault-tolerance story:
  * auto-resume from the latest complete checkpoint (restart-safe);
  * deterministic data position = step index (no replay/skip after restart);
  * straggler monitor -> tightened checkpoint cadence while degraded;
  * the (data, model) layout from `ElasticPolicy` for the devices alive
    (one card here: the sharded layouts wait for the multi-card slice, so
    ``--model-parallel`` is accepted and reported, not used);
  * async (non-blocking) checkpoint writes in the JAX on-disk format.
The parameters come from an explicit `torch.Generator` seeded with 0 (not
the JAX PRNG: the draws differ from the JAX driver's). The final
checkpoint is written unless the last step's periodic one already holds
that step (the JAX driver writes it a second time).
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config
from ..core.index import resolve_device
from ..data.synthetic import TokenStream
from ..distributed import checkpoint as ckpt_lib
from ..distributed.fault import ElasticPolicy, StragglerMonitor
from ..models import transformer as model_lib
from ..train.loop import TrainCfg, init_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--reduced", action="store_true", help="smoke-size model")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=2)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainCfg(lr=args.lr, warmup=max(10, args.steps // 10),
                    total_steps=args.steps, microbatches=args.microbatches,
                    compress_grads=args.compress_grads,
                    remat="full")

    n_devices = 1
    policy = ElasticPolicy(model_parallel=args.model_parallel)
    data, model = policy.mesh_shape(n_devices)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {device} ({name}); mesh {{'data': {data}, 'model': "
          f"{model}}} devices={n_devices}; --model-parallel "
          f"{args.model_parallel} not used on one device")

    generator = torch.Generator(device=device)
    generator.manual_seed(0)
    params = model_lib.init_params(cfg, generator=generator, device=device)
    state = init_state(params, tcfg)

    start_step = 0
    if args.ckpt_dir:
        latest = ckpt_lib.latest_step(args.ckpt_dir)
        if latest is not None:
            state = ckpt_lib.restore(args.ckpt_dir, latest, state, device)
            start_step = latest
            print(f"resumed from step {latest}")

    step_fn = make_train_step(cfg, tcfg, donate=True)
    stream = TokenStream(vocab=cfg.vocab, batch=args.batch, seq=args.seq)
    monitor = StragglerMonitor()
    ckpt_every = args.ckpt_every
    pending = None
    saved = start_step
    t_start = time.time()
    losses = []
    for step in range(start_step, args.steps):
        batch = stream.batch_at(step)
        monitor.start()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        straggled = monitor.stop()
        if straggled:
            ckpt_every = max(10, ckpt_every // 2)  # tighten cadence while degraded
            print(f"[straggler] step {step}: latency spike; ckpt_every -> {ckpt_every}")
        if args.log_every and step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e}")
        if args.ckpt_dir and (step + 1) % ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = ckpt_lib.save(args.ckpt_dir, step + 1, state, blocking=False)
            saved = step + 1
    if pending is not None:
        pending.join()
    if args.ckpt_dir and saved != args.steps:
        ckpt_lib.save(args.ckpt_dir, args.steps, state)
    dt = time.time() - t_start
    summary = (f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; " if losses
               else "no step to run; ")
    print(f"done: {args.steps - start_step} steps in {dt:.1f}s "
          f"({(args.steps - start_step) / max(dt, 1e-9):.2f} steps/s); "
          f"{summary}straggler events: {monitor.events}")
    return losses


if __name__ == "__main__":
    main()
