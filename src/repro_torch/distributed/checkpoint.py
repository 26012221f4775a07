"""Checkpoints of the train state in the JAX package's on-disk format; port
of `repro.distributed.checkpoint`.

Layout:
  <dir>/step_<N>/manifest.json   — tree structure + dtypes + shapes
  <dir>/step_<N>/arrays.npz      — flat leaves, ``leaf_i`` in JAX flatten order
  <dir>/step_<N>/.complete       — commit marker (atomicity)

A step is written into ``step_<N>.tmp`` and moved into place with one
``os.replace``, so a reader sees a whole step or none. The manifest's
``treedef`` is the string JAX writes for the same tree, and each package
restores the other's checkpoints of the same `TrainState`. The async mode
copies the leaves to the host first and writes them on a thread, so the
step loop waits only for the copy, and a later in-place step does not
reach the checkpoint.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from .. import tree as tree_lib
from ..core.index import resolve_device


def save(ckpt_dir: str, step: int, tree: Any, *, blocking: bool = True):
    """Atomically save a tree under step_<N>. Returns None, or with
    ``blocking=False`` the started writer thread (join it)."""
    # a copy even of a CPU tensor: the step loop updates the state in place
    host_leaves = [t.detach().to("cpu", copy=True).numpy() if torch.is_tensor(t)
                   else np.array(t, copy=True) for t in tree_lib.leaves(tree)]
    treedef = tree_lib.treedef_str(tree)

    def _write():
        final = os.path.join(ckpt_dir, f"step_{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"leaf_{i}": l for i, l in enumerate(host_leaves)})
        manifest = {
            "step": step,
            "treedef": treedef,
            "n_leaves": len(host_leaves),
            "shapes": [list(l.shape) for l in host_leaves],
            "dtypes": [str(l.dtype) for l in host_leaves],
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, ".complete"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The largest complete step in ``ckpt_dir`` (``.tmp`` and unmarked
    directories ignored), or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, ".complete")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, target: Any, device="cuda") -> Any:
    """Restore step ``step`` into the structure of ``target`` (a tree of
    tensors, or of anything with ``shape`` and ``dtype``), each leaf a
    tensor on ``device``. Raises on an incomplete step, on another number
    of leaves, or on a leaf whose shape or dtype differs from the
    target's."""
    dev = resolve_device(device)
    path = os.path.join(ckpt_dir, f"step_{step}")
    if not os.path.exists(os.path.join(path, ".complete")):
        raise FileNotFoundError(f"incomplete checkpoint at {path}")
    leaves = tree_lib.leaves(target)
    with open(os.path.join(path, "manifest.json")) as f:
        n_saved = json.load(f)["n_leaves"]
    if n_saved != len(leaves):
        raise ValueError(f"{path} holds {n_saved} leaves, the target "
                         f"{len(leaves)}")
    loaded = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, want in enumerate(leaves):
            arr = data[f"leaf_{i}"]
            want_dtype = (str(want.dtype).replace("torch.", "")
                          if torch.is_tensor(want) else str(np.dtype(want.dtype)))
            if tuple(arr.shape) != tuple(want.shape) or str(arr.dtype) != want_dtype:
                raise ValueError(
                    f"{path} leaf_{i}: {arr.dtype}{list(arr.shape)} does not "
                    f"match the target's {want_dtype}{list(want.shape)}")
            loaded.append(torch.from_numpy(arr).to(dev))
    return tree_lib.unflatten(target, loaded)


__all__ = ["latest_step", "restore", "save"]
