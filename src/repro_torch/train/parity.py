"""How close two train states are: the port against the JAX package (the
CPU tests) or the card against the CPU (`chip_smoke.py`).

An error is relative to the largest magnitude of the reference leaf,
``max |got - want| / max |want|``, and a part's error is the largest over
its leaves. Two effects make correct implementations that sum in another
order part by more than that, and each is bounded apart:

- Adam's normalization. The update ``mu_hat / (sqrt(nu_hat) + eps)`` of an
  element whose gradient is small against its leaf's largest multiplies
  that element's share of the gradient error by ``G / sqrt(nu_hat)``. So a
  parameter's error may exceed the tolerance by `adam_allowance`: the sum
  over the steps of ``lr * GRAD_TOL * G / (sqrt(nu_hat) + eps)``, ``G`` the
  leaf's largest ``sqrt(nu_hat)`` and ``GRAD_TOL`` the gradients' own
  tolerance, at most a reversed step (``2 * lr``) per step.
- int8 flips of the error-feedback compression. An element whose value
  lies within rounding noise of a half step of the int8 grid rounds to
  neighbouring codes; its residual then differs by one step (the leaf's
  scale) and its moments and parameter by what that step moves. A flip is
  taken only with its margin, the distance of the reference's value from
  the half step in grid units (``|0.5 - |r| / scale|``); the largest margin
  is returned for the caller to hold to its bound. A residual's error is
  relative to what was quantized (127 scales), not to the residual.

The tolerance is GRAD_TOL for every leaf unless the caller gives one a
leaf (`leaf_tols`), or one a leaf for each part: the recurrent models
amplify f32 rounding past GRAD_TOL, so their leaves are held to twice the
reference's own measured error (`tests/test_torch_recurrent_train.py`,
`chip_smoke.py` phase 12a).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import tree as tree_lib

GRAD_TOL = 1e-5
# a gradient error of GRAD_TOL of its leaf's largest moves a value by at
# most 127 * GRAD_TOL int8 steps: the largest margin a flip may have
FLIP_MARGIN = 127 * GRAD_TOL


def _np(leaves):
    # a bf16 tensor widens exactly to f64 (numpy has no bfloat16)
    return [t.detach().cpu().double().numpy() if torch.is_tensor(t)
            else np.asarray(t, dtype=np.float64) for t in leaves]


def leaf_names(params) -> list:
    """Dotted paths of the parameter leaves, in flatten order."""
    names = []

    def walk(node, prefix):
        for key in sorted(node):
            if isinstance(node[key], dict):
                walk(node[key], f"{prefix}{key}.")
            else:
                names.append(prefix + key)

    walk(params, "")
    return names


def leaf_tols(grad_tol, n: int) -> list:
    """``grad_tol`` as ``n`` per-leaf tolerances: one number for every
    leaf, or a sequence of one a leaf (in flatten order)."""
    if np.ndim(grad_tol) == 0:
        return [float(grad_tol)] * n
    tols = [float(t) for t in grad_tol]
    if len(tols) != n:
        raise ValueError(f"{len(tols)} tolerances for {n} leaves")
    return tols


def adam_allowance(allowance, state, lr: float, *, grad_tol=GRAD_TOL,
                   b2: float = 0.95, eps: float = 1e-8) -> list:
    """``allowance`` (per-leaf arrays, or None before the first step) plus
    this step's share, from the reference ``state`` after the step, the
    step's learning rate ``lr`` and the gradients' tolerance ``grad_tol``
    (`leaf_tols`)."""
    bc2 = 1.0 - b2 ** int(state.opt.count)
    nus = _np(tree_lib.leaves(state.opt.nu))
    tols = leaf_tols(grad_tol, len(nus))
    out = []
    for i, nu in enumerate(nus):
        r = np.sqrt(nu / bc2)
        share = np.minimum(lr * tols[i] * r.max() / (r + eps), 2.0 * lr)
        out.append(share if allowance is None else allowance[i] + share)
    return out


def compare_states(got, want, *, allowance=None, grad_tol=GRAD_TOL) -> dict:
    """``got`` against ``want`` (two `TrainState`s of one config, on any
    devices). Returns the largest relative errors {"params", "mu", "nu",
    "ef"} over the elements that did not flip, the parameters' beyond
    ``allowance`` (`adam_allowance`, or None for none); "allowed" (the
    parameter elements whose error exceeds their leaf's tolerance but not
    their allowance); "excess" (the largest ratio of a leaf's error to its
    tolerance over the parts: at most 1 when every leaf holds); "flips"
    (elements whose residuals differ by about one int8 step) and
    "flip_margin" (the largest margin of a flip, 0.0 without one); and
    "worst" (the part and leaf of the largest error). A leaf's int8 scale
    is taken as twice its largest residual (``|r| <= scale / 2``; enough to
    tell a one-step difference from noise), and a flip's own difference of
    residuals is its scale in its margin.
    ``grad_tol`` is one tolerance for every part (`leaf_tols`), or a dict of
    one a part ({"params", "mu", "nu", "ef"}; GRAD_TOL for a part left
    out)."""
    names = leaf_names(want.params)
    parts = {"params": (got.params, want.params),
             "mu": (got.opt.mu, want.opt.mu), "nu": (got.opt.nu, want.opt.nu)}
    if want.ef is not None:
        parts["ef"] = (got.ef.residual, want.ef.residual)
    flips = [np.zeros(tuple(p.shape), bool) for p in tree_lib.leaves(want.params)]
    scales = [0.0] * len(flips)
    margin = 0.0
    if want.ef is not None:
        for i, (rg, rw) in enumerate(zip(_np(tree_lib.leaves(got.ef.residual)),
                                         _np(tree_lib.leaves(want.ef.residual)))):
            scales[i] = 2.0 * np.abs(rw).max()
            if scales[i] == 0.0:
                continue
            flips[i] = np.abs(rg - rw) > 0.5 * scales[i]
            if flips[i].any():
                step = np.abs(rg - rw)[flips[i]]
                margin = max(margin, float(
                    np.abs(0.5 - np.abs(rw[flips[i]]) / step).max()))

    def part_tols(part):
        tol = (grad_tol.get(part, GRAD_TOL) if isinstance(grad_tol, dict)
               else grad_tol)
        return leaf_tols(tol, len(flips))

    out = {"flips": int(sum(f.sum() for f in flips)), "flip_margin": margin,
           "allowed": 0, "excess": 0.0, "worst": None}
    worst = -1.0
    for part, (g_tree, w_tree) in parts.items():
        err, tols = 0.0, part_tols(part)
        for i, (g, w) in enumerate(zip(_np(tree_lib.leaves(g_tree)),
                                       _np(tree_lib.leaves(w_tree)))):
            denom = max(127.0 * scales[i] if part == "ef" else np.abs(w).max(),
                        1e-30)
            d = np.abs(g - w)[~flips[i]]
            if part == "params" and allowance is not None:
                out["allowed"] += int((d > tols[i] * denom).sum())
                d = np.maximum(d - allowance[i][~flips[i]], 0.0)
            e = float(d.max(initial=0.0) / denom)
            err = max(err, e)
            out["excess"] = max(out["excess"], e / tols[i])
            if e > worst:
                worst, out["worst"] = e, f"{part} {names[i]}"
        out[part] = err
    return out


def rel(got, want) -> float:
    """``max |got - want| / max |want|`` of two scalars or arrays."""
    g, w = _np([got])[0], _np([want])[0]
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


__all__ = ["FLIP_MARGIN", "GRAD_TOL", "adam_allowance", "compare_states", "leaf_names",
           "leaf_tols", "rel"]
