"""End-to-end training driver of the port; counterpart of
`repro.launch.train`.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --steps 200 --batch 8 --seq 256 --reduced --ckpt-dir /tmp/ckpt

Every config of the registry trains, the recurrent ``--arch xlstm-1.3b``
and ``--arch zamba2-1.2b`` too. It runs on the card unless ``--device
cpu`` is given, and keeps the JAX driver's fault-tolerance story:
  * auto-resume from the latest complete checkpoint (restart-safe);
  * deterministic data position = step index (no replay/skip after restart);
  * straggler monitor -> tightened checkpoint cadence while degraded
    (under ranks, a spike on any rank changes every rank's cadence);
  * elastic mesh: (data, model) from `ElasticPolicy` for the ranks
    alive, and checkpoints reshard on load (save under one mesh, restore
    under another);
  * async (non-blocking) checkpoint writes in the JAX on-disk format.
The parameters come from an explicit `torch.Generator` seeded with 0 (not
the JAX PRNG: the draws differ from the JAX driver's). The final
checkpoint is written unless the last step's periodic one already holds
that step (the JAX driver writes it a second time).

Ranks: under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT`` in the environment; or ``--init-method``
with ``RANK`` and ``WORLD_SIZE``) each rank is a process of one gloo
group, on ``cuda:{LOCAL_RANK % device_count()}`` (several ranks may share
one card) or on the CPU:

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu \
      --reduced --steps 8 --batch 4 --seq 64 --ckpt-dir /tmp/ckpt

The layout is the JAX launcher's, not ZeRO: the parameters, both moments
and the error-feedback residual under `sharding.param_specs`, the rest
whole on every rank; the batch split over ``data`` and the compute over
``model`` (`--model-parallel`, halved until it divides the ranks; see
`train.loop`). Every rank draws the same parameters and keeps its pieces;
only rank 0 prints. Without a distributed environment the run is one
process, as before.
"""
from __future__ import annotations

import argparse
import datetime
import os
import time

import torch
import torch.distributed as dist

from ..configs import ShapeCfg, get_config
from ..core.index import resolve_device
from ..data.synthetic import TokenStream
from ..distributed import checkpoint as ckpt_lib
from ..distributed.compression import ErrorFeedback
from ..distributed.fault import ElasticPolicy, StragglerMonitor
from ..distributed.sharding import P, batch_specs, param_specs, shard_tree
from ..models import transformer as model_lib
from ..train.loop import TrainCfg, TrainState, init_state, make_train_step
from ..train.optimizer import AdamWState
from .mesh import make_host_mesh

# a rank that waits longer than this in a collective fails instead of hanging
TIMEOUT = datetime.timedelta(seconds=60)


def join_world(init_method=None) -> bool:
    """Join the gloo group that ``torchrun``'s environment (or
    ``init_method`` with ``RANK`` and ``WORLD_SIZE``) describes. False
    when there is none (one process) or when the caller already joined."""
    if dist.is_initialized():
        return False
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 and init_method is None:
        return False
    dist.init_process_group("gloo", init_method=init_method or "env://",
                            rank=int(os.environ["RANK"]), world_size=world,
                            timeout=TIMEOUT)
    return True


def rank_device(device: str) -> torch.device:
    """``device``, with a plain "cuda" under ranks meaning this rank's card,
    ``cuda:{LOCAL_RANK % device_count()}``."""
    if device == "cuda" and dist.is_initialized() and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = f"cuda:{local % torch.cuda.device_count()}"
    return resolve_device(device)


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
    ap.add_argument("--init-method", default=None,
                    help="torch.distributed init method (default env://, "
                         "under torchrun)")
    args = ap.parse_args(argv)
    joined = join_world(args.init_method)
    try:
        return _run(args)
    finally:
        if joined:
            dist.destroy_process_group()


def _run(args):
    device = rank_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainCfg(lr=args.lr, warmup=max(10, args.steps // 10),
                    total_steps=args.steps, microbatches=args.microbatches,
                    compress_grads=args.compress_grads,
                    remat="full")

    policy = ElasticPolicy(model_parallel=args.model_parallel)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    mesh = specs = None
    if dist.is_initialized():
        mesh = make_host_mesh(policy.mesh_shape(dist.get_world_size())[1])
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
    if mesh is None:
        data, model = policy.mesh_shape(1)
        say(f"device: {device} ({name}); mesh {{'data': {data}, 'model': "
            f"{model}}} devices=1; --model-parallel {args.model_parallel} "
            f"not used on one device")
    else:
        say(f"device: {device} ({name}); mesh: {mesh.shape} devices="
            f"{mesh.size} (gloo ranks)")

    generator = torch.Generator(device=device)
    generator.manual_seed(0)
    params = model_lib.init_params(cfg, generator=generator, device=device)
    if mesh is not None:
        p_spec = param_specs(params, mesh)
        params = shard_tree(params, p_spec, mesh)
        specs = TrainState(
            params=p_spec, opt=AdamWState(mu=p_spec, nu=p_spec, count=P()),
            ef=ErrorFeedback(residual=p_spec) if tcfg.compress_grads else None,
            step=P())
    state = init_state(params, tcfg)

    start_step = 0
    if args.ckpt_dir:
        latest = ckpt_lib.latest_step(args.ckpt_dir, mesh)
        if latest is not None:
            state = ckpt_lib.restore(args.ckpt_dir, latest, state, device,
                                     specs=specs, mesh=mesh)
            start_step = latest
            say(f"resumed from step {latest}")

    if mesh is None:
        step_fn = make_train_step(cfg, tcfg, donate=True)
    else:
        shape = ShapeCfg("cli", args.seq, args.batch, "train")
        mb_specs = {k: P(None, *s)
                    for k, s in batch_specs(cfg, shape, mesh).items()}
        step_fn = make_train_step(cfg, tcfg, mesh=mesh, mb_specs=mb_specs,
                                  param_specs=specs.params, donate=True)
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
        if mesh is not None:
            # every rank takes the same cadence, since a save is collective:
            # a spike on any rank's clock counts on all of them
            straggled = bool(mesh.all_reduce(
                torch.tensor(float(straggled)), mesh.axis_names, "max"))
        if straggled:
            ckpt_every = max(10, ckpt_every // 2)  # tighten cadence while degraded
            say(f"[straggler] step {step}: latency spike; ckpt_every -> {ckpt_every}")
        if args.log_every and step % args.log_every == 0:
            say(f"step {step:5d} loss {loss:.4f} gnorm {float(metrics['grad_norm']):.3f} "
                f"lr {float(metrics['lr']):.2e}")
        if args.ckpt_dir and (step + 1) % ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = ckpt_lib.save(args.ckpt_dir, step + 1, state,
                                    blocking=False, specs=specs, mesh=mesh)
            saved = step + 1
    if pending is not None:
        pending.join()
    if args.ckpt_dir and saved != args.steps:
        ckpt_lib.save(args.ckpt_dir, args.steps, state, specs=specs, mesh=mesh)
    dt = time.time() - t_start
    summary = (f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; " if losses
               else "no step to run; ")
    say(f"done: {args.steps - start_step} steps in {dt:.1f}s "
        f"({(args.steps - start_step) / max(dt, 1e-9):.2f} steps/s); "
        f"{summary}straggler events: {monitor.events}")
    return losses


if __name__ == "__main__":
    main()
