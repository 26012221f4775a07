"""The split of the compute over the mesh's ``model`` axis: the port's
counterpart of the collectives GSPMD inserts when it partitions the JAX
step by `sharding.param_specs`.

A `TensorParallel` (the mesh context) goes to the model functions as
``tp``. None means one process; then, and on a ``model`` axis of one rank
(`active` is false), every function here is the identity (`local` the
whole tensor, `cols` / `rows` / `row` a plain GEMM), so one body of each
model function runs the one-process compute op for op. Under an active context each rank holds
its pieces of the parameters and computes what its device computes in
GSPMD's partition:

- a GEMM against a column piece gives a column piece of the product;
- a GEMM against a row piece gives a partial sum, all-reduced over
  ``model`` (`row`);
- a packed projection whose column pieces mix fields (Mamba2's
  ``in_proj``, the mLSTM's ``w_up``, the sLSTM's ``w_gates``) and a K/V
  piece smaller than one KV head are all-gathered (`gather_cols`) before
  the fields are sliced;
- the vocab-split embedding sums its masked lookups (`embed`), and the
  cross entropy over vocab pieces of the logits reduces a max, a sum of
  exponentials and the target logit (`cross_entropy`): the (B, S, V)
  logits are never whole.

The collectives are autograd functions, each with the conjugate backward:

=============  =======================  ==============================
function       forward                  backward
=============  =======================  ==============================
`copy_in`      identity                 all-reduce of the gradient
`reduce`       all-reduce (sum)         identity
`all_sum`      all-reduce (sum)         all-reduce of the gradient
`gather_cols`  all-gather of columns    sum over ``model``, this rank's
                                        columns kept (reduce-scatter)
=============  =======================  ==============================

The invariant they keep: a tensor whose value is the same on every rank has
its whole gradient on every rank. Where such a tensor (an activation, or a
replicated leaf such as a norm weight) enters compute that differs between
ranks (a column GEMM, this rank's heads or experts), `copy_in` sums the
ranks' partial gradients; a row GEMM's `reduce` ends that compute. What a
gather produces is consumed differently on each rank (each takes its heads,
or its rows of a row-parallel GEMM), so each rank holds a partial gradient
of it and the backward of `gather_cols` sums them. A sum over ``model``
whose result feeds such compute (the Mamba2 gated norm's sum of squares
over heads split across ranks) is `all_sum`. Gradients then arrive in each
leaf's `param_specs` piece with no gather of a parameter.

One reduction goes over the data axes instead (`data_mean`): the MoE
load-balance loss is a product of two batch means, which GSPMD takes over
the whole (micro)batch, so each rank's share of the batch must see the
whole batch's means (on any mesh with data axes, a ``model`` axis of one
too). The decode step under context parallelism gathers the attention of
each rank's piece of the sequence over the data axes
(`models.attention.merge_pieces`); it runs under ``torch.no_grad`` and
takes the mesh's collectives directly.

``sync_s`` adds up the host seconds spent in these collectives (the
forward's, a remat recompute's and the backward's), fenced by a device
sync before each: `train.loop` reports it as ``tp_sync_s``.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

AXIS = "model"


class TensorParallel:
    """The mesh context of the model functions: ``mesh`` (a
    `launch.mesh.Mesh`, its recording variant too) and this rank's place
    on its ``model`` axis."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.size = mesh.axis_size(AXIS) if AXIS in mesh.axis_names else 1
        self.rank = mesh.index(AXIS) if self.size > 1 else 0
        self.data_axes = tuple(a for a in mesh.axis_names if a != AXIS)
        self.data_size = mesh.axis_size(self.data_axes)
        self.sync_s = 0.0

    def __repr__(self):
        return f"TensorParallel(model {self.rank} of {self.size})"

    def part(self, n: int) -> slice:
        """This rank's slice of ``n`` items cut into one equal piece a
        rank of the ``model`` axis."""
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def _timed(self, tensors, fn):
        for t in tensors:
            if t.device.type == "cuda":
                torch.cuda.synchronize(t.device)
                break
        t0 = time.perf_counter()
        out = fn()
        self.sync_s += time.perf_counter() - t0
        return out

    def all_reduce(self, tensors, op: str = "sum", axes=AXIS) -> None:
        """Each of ``tensors`` summed (or maxed) in place over ``model`` (or
        ``axes``)."""
        self._timed(tensors, lambda: self.mesh.all_reduce_many(
            list(tensors), axes, op))

    def all_gather(self, t: torch.Tensor, dim: int, axes=AXIS) -> torch.Tensor:
        """The pieces ``t`` of the ranks along ``model`` (or ``axes``)
        joined along ``dim`` in their order."""
        return self._timed([t], lambda: self.mesh.all_gather(t, axes, dim))

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """``t`` summed over ``model``, this rank's piece of ``dim`` kept."""
        def run():
            n = self.size
            dim_ = dim % t.dim()
            chunks = t.chunk(n, dim_)
            order = [self.mesh.index(AXIS, c) for c in self.mesh.members(AXIS)]
            flat = torch.cat([chunks[i].reshape(-1) for i in order])
            out = self.mesh.reduce_scatter_many([flat], AXIS)[0]
            return out.view(chunks[0].shape)
        return self._timed([t], run)


def context(mesh) -> Optional[TensorParallel]:
    """The mesh context of ``mesh``: None without a mesh or on a mesh of
    one rank."""
    if mesh is None or mesh.size == 1:
        return None
    return TensorParallel(mesh)


def active(tp) -> bool:
    return tp is not None and tp.size > 1


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tp, *xs):
        ctx.tp = tp
        return xs if len(xs) > 1 else xs[0]

    @staticmethod
    def backward(ctx, *grads):
        grads = [g.contiguous().clone() for g in grads]
        ctx.tp.all_reduce(grads)
        return (None, *grads)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tp, x):
        out = x.contiguous().clone()
        tp.all_reduce([out])
        return out

    @staticmethod
    def backward(ctx, g):
        return None, g


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tp, x):
        ctx.tp = tp
        out = x.contiguous().clone()
        tp.all_reduce([out])
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        ctx.tp.all_reduce([g])
        return None, g


class _DataSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tp, x):
        ctx.tp = tp
        out = x.contiguous().clone()
        tp.all_reduce([out], axes=tp.data_axes)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        ctx.tp.all_reduce([g], axes=ctx.tp.data_axes)
        return None, g


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tp, y):
        ctx.tp = tp
        return tp.all_gather(y.contiguous(), -1)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.tp.reduce_scatter(g.contiguous(), -1)


def copy_in(tp, *xs):
    """``xs`` unchanged; in the backward each gradient is summed over
    ``model`` (one collective with every tensor in flight). Returns one
    tensor for one argument, else a tuple."""
    if not active(tp):
        return xs if len(xs) > 1 else xs[0]
    return _CopyIn.apply(tp, *xs)


def reduce(tp, x):
    """``x`` summed over ``model`` (a row-parallel GEMM's partial sums)."""
    return _Reduce.apply(tp, x) if active(tp) else x


def all_sum(tp, x):
    """``x`` summed over ``model``, its gradient summed too."""
    return _AllSum.apply(tp, x) if active(tp) else x


def data_mean(tp, x):
    """``x``, a mean over this rank's rows of the batch, as the mean over
    the whole batch split over the data axes (equal rows a rank): summed
    over them both ways and divided by their number. The train step
    averages the ranks' gradients, so each rank's gradient of the whole
    batch's mean is the sum of theirs."""
    if tp is None or tp.data_size == 1:
        return x
    return _DataSum.apply(tp, x) / tp.data_size


def gather_cols(tp, y):
    """Every rank's column piece ``y`` (..., N / model) joined along the
    last dim in rank order: (..., N)."""
    return _GatherCols.apply(tp, y) if active(tp) else y


def row(tp, x, w):
    """``x`` (..., K / model) @ ``w`` (K / model, N), summed over
    ``model``: a row-parallel GEMM (the one-process ``x @ w`` without a
    context)."""
    return reduce(tp, x @ w)


def cols(tp, x, w, n: int):
    """``x @ w`` whole, (..., n) on every rank: the column pieces gathered,
    or the product of a leaf that is whole on every rank."""
    if split(tp, w.shape[-1], n):
        return gather_cols(tp, x @ w)
    return x @ copy_in(tp, w)


def rows(tp, y, w, n: int):
    """``y`` (..., n), whole on every rank, @ ``w`` (n, d) row-parallel:
    this rank's columns of ``y`` against its rows of ``w`` (its slice of a
    ``w`` whole on every rank), summed over ``model``."""
    if not split(tp, w.shape[0], n):
        w = local(tp, copy_in(tp, w), 0)
    return row(tp, local(tp, y, -1), w)


def split(tp, n_local: int, n: int) -> bool:
    """Whether a dim of ``n`` arrives as this rank's piece of ``n_local``."""
    if n_local == n:
        return False
    if not active(tp) or n_local * tp.size != n:
        raise ValueError(f"a piece of {n_local} of {n} under {tp}")
    return True


def local(tp, t: torch.Tensor, dim: int):
    """This rank's piece of ``t`` along ``dim`` (`TensorParallel.part`): a
    view; ``t`` itself without an active context."""
    if not active(tp):
        return t
    index = [slice(None)] * t.dim()
    index[dim] = tp.part(t.shape[dim])
    return t[tuple(index)]


# ---------------------------------------------------------------- the vocab

def embed(tp, tokens, table, rows: int):
    """`F.embedding` of ``tokens`` in ``table``: the whole table of ``rows``
    rows, or this rank's piece of its rows (then the rows other ranks hold
    are masked and the lookups summed over ``model``)."""
    import torch.nn.functional as F
    if not split(tp, table.shape[0], rows):
        return F.embedding(tokens, table)
    lo = tp.rank * table.shape[0]
    mine = (tokens >= lo) & (tokens < lo + table.shape[0])
    out = F.embedding(torch.where(mine, tokens - lo, torch.zeros_like(tokens)),
                      table)
    out = out * mine[..., None].to(out.dtype)
    return reduce(tp, out)


class _VocabCE(torch.autograd.Function):
    """Cross entropy over this rank's vocab columns [lo, lo + V / model) of
    the (N, V / model) f32 logits: label -1 ignored, the mean over the
    valid labels, as `transformer.cross_entropy`."""

    @staticmethod
    def forward(ctx, tp, logits, labels, lo):
        m = logits.amax(dim=-1)
        tp.all_reduce([m], "max")
        e = torch.exp(logits - m[:, None])
        sumexp = e.sum(dim=-1)
        valid = labels >= 0
        col = labels.long() - lo
        mine = valid & (col >= 0) & (col < logits.shape[-1])
        idx = torch.where(mine, col, torch.zeros_like(col))
        target = torch.where(mine, torch.gather(logits, -1, idx[:, None])[:, 0],
                             torch.zeros_like(m))
        tp.all_reduce([sumexp, target])
        lse = m + torch.log(sumexp)
        nll = torch.where(valid, lse - target, torch.zeros_like(lse))
        count = torch.clamp(valid.sum(), min=1)
        ctx.save_for_backward(e, sumexp, valid, mine, idx, count)
        return nll.sum() / count

    @staticmethod
    def backward(ctx, g):
        e, sumexp, valid, mine, idx, count = ctx.saved_tensors
        scale = (g / count) * valid.to(e.dtype)
        d = e / sumexp[:, None] * scale[:, None]
        d = d.scatter_add(-1, idx[:, None],
                          -(scale * mine.to(e.dtype))[:, None])
        return None, d, None, None


def cross_entropy(tp, logits, labels, lo: int):
    """The mean cross entropy of (..., V / model) logit pieces whose first
    column is vocab row ``lo``, labels (...,) with -1 ignored."""
    v = logits.shape[-1]
    return _VocabCE.apply(tp, logits.reshape(-1, v), labels.reshape(-1), lo)


__all__ = ["AXIS", "TensorParallel", "active", "all_sum", "cols", "context",
           "copy_in", "cross_entropy", "data_mean", "embed", "gather_cols",
           "local", "reduce", "row", "rows", "split"]
