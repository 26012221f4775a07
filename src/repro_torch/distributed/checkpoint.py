"""Checkpoints of the train state in the JAX package's on-disk format; port
of `repro.distributed.checkpoint`.

Layout:
  <dir>/step_<N>/manifest.json   — tree structure + dtypes + shapes
  <dir>/step_<N>/arrays.npz      — flat leaves, ``leaf_i`` in JAX flatten order
  <dir>/step_<N>/.complete       — commit marker (atomicity)

A step is written into ``step_<N>.tmp`` and moved into place with one
``os.replace``, so a reader sees a whole step or none. The manifest's
``treedef`` is the string JAX writes for the same tree, and each package
restores the other's checkpoints of the same `TrainState`. A bf16 leaf is
written as JAX's is: numpy's raw 2-byte records (``|V2``) in
``arrays.npz`` and ``"bfloat16"`` in the manifest's ``dtypes``, from
which `restore` reads it back as bf16, bit for bit. The async mode
copies the leaves to the host first and writes them on a thread, so the
step loop waits only for the copy, and a later in-place step does not
reach the checkpoint.

Under a mesh of several ranks (`launch.mesh.Mesh`) the tree holds each
rank's pieces under ``specs``: `save` gathers every leaf whole (every rank
takes part), rank 0 alone writes the step in the same format, and every
rank waits at a barrier after the write (at `join` for an async save).
`restore` slices each saved leaf into this rank's piece, so a step saved
under N ranks, or by the JAX package or one process, restores under M.
`latest_step` is rank 0's answer, broadcast, so the ranks never disagree
about a step that is being written.
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
from .sharding import gather, shard, shard_shape


class _Pending:
    """An async save under a mesh: `join` waits for rank 0's writer and
    then for every rank (call it on every rank, in program order)."""

    def __init__(self, writer: Optional[threading.Thread], mesh):
        self._writer, self._mesh = writer, mesh

    def join(self):
        if self._writer is not None:
            self._writer.join()
        self._mesh.barrier()


def _sharded(mesh) -> bool:
    return mesh is not None and mesh.size > 1


def save(ckpt_dir: str, step: int, tree: Any, *, blocking: bool = True,
         specs: Any = None, mesh=None):
    """Atomically save a tree under step_<N>. Returns None, or with
    ``blocking=False`` the started writer thread (join it). Under a mesh
    of several ranks ``tree`` holds this rank's pieces under ``specs`` (a
    tree of `sharding.P`; None: every leaf whole) and every rank calls
    `save`; the non-blocking form returns an object whose `join` every rank
    calls."""
    leaves = tree_lib.leaves(tree)
    if _sharded(mesh):
        spec_leaves = (tree_lib.leaves(specs) if specs is not None
                       else [()] * len(leaves))
        # every rank takes part in each gather; rank 0 keeps a host copy
        host_leaves = []
        for t, spec in zip(leaves, spec_leaves):
            whole = gather(t, spec, mesh)
            if mesh.rank == 0:
                host_leaves.append(tree_lib.leaf_to_numpy(whole))
            del whole
    else:
        # a copy even of a CPU tensor: the step loop updates the state in place
        host_leaves = [tree_lib.leaf_to_numpy(t) for t in leaves]
    dtypes = [tree_lib.dtype_name(t) for t in leaves]
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
            "dtypes": dtypes,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, ".complete"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)

    writes = not _sharded(mesh) or mesh.rank == 0
    if blocking:
        if writes:
            _write()
        if _sharded(mesh):
            mesh.barrier()
        return None
    t = threading.Thread(target=_write, daemon=True) if writes else None
    if t is not None:
        t.start()
    return _Pending(t, mesh) if _sharded(mesh) else t


def latest_step(ckpt_dir: str, mesh=None) -> Optional[int]:
    """The largest complete step in ``ckpt_dir`` (``.tmp`` and unmarked
    directories ignored), or None. Under a mesh of several ranks, rank 0's
    answer on every rank (collective)."""
    if _sharded(mesh):
        found = _latest_step(ckpt_dir) if mesh.rank == 0 else None
        return mesh.broadcast_object(found)
    return _latest_step(ckpt_dir)


def _latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, ".complete")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, target: Any, device="cuda", *,
            specs: Any = None, mesh=None) -> Any:
    """Restore step ``step`` into the structure of ``target`` (a tree of
    tensors, or of anything with ``shape`` and ``dtype``), each leaf a
    tensor on ``device``. With a ``mesh`` each leaf is this rank's piece
    of the saved array under its spec in ``specs`` (the counterpart of the
    JAX ``shardings`` argument), and ``target`` holds pieces. Raises on an
    incomplete step, on another number of leaves, or on a leaf whose dtype
    or (piece) shape differs from the target's."""
    dev = resolve_device(device)
    spec_leaves = None
    if mesh is not None:
        spec_leaves = (tree_lib.leaves(specs) if specs is not None
                       else [()] * len(tree_lib.leaves(target)))
    path = os.path.join(ckpt_dir, f"step_{step}")
    if not os.path.exists(os.path.join(path, ".complete")):
        raise FileNotFoundError(f"incomplete checkpoint at {path}")
    leaves = tree_lib.leaves(target)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    n_saved = manifest["n_leaves"]
    saved_dtypes = manifest.get("dtypes", [""] * n_saved)
    if n_saved != len(leaves):
        raise ValueError(f"{path} holds {n_saved} leaves, the target "
                         f"{len(leaves)}")
    loaded = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, want in enumerate(leaves):
            arr = data[f"leaf_{i}"]
            want_dtype = tree_lib.dtype_name(want)
            # a bf16 leaf is raw 2-byte records, named by the manifest
            got_dtype = (saved_dtypes[i] if arr.dtype == tree_lib.BF16_RECORD
                         else str(arr.dtype))
            shape = (tuple(arr.shape) if spec_leaves is None
                     else shard_shape(spec_leaves[i], arr.shape, mesh))
            if shape != tuple(want.shape) or got_dtype != want_dtype:
                raise ValueError(
                    f"{path} leaf_{i}: {got_dtype}{list(shape)} does not "
                    f"match the target's {want_dtype}{list(want.shape)}")
            whole = tree_lib.leaf_from_numpy(arr, got_dtype, copy=False)
            if spec_leaves is not None:
                whole = shard(whole, spec_leaves[i], mesh).contiguous()
            loaded.append(whole.to(dev))
    return tree_lib.unflatten(target, loaded)


__all__ = ["latest_step", "restore", "save"]
