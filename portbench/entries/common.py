"""What the entry points share: the kernel library, the index's shapes and
freeing the port's state."""
from __future__ import annotations

import gc

import torch


def prepare(device) -> None:
    """Load (and, in a fresh checkout, build) the port's kernel library, so
    that its build is timed apart from the index build."""
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import build
        build.library()


def index_meta(meta) -> dict:
    """The shapes of a built index the per-layer metrics need."""
    return {"n": meta.n, "d": meta.d, "m": meta.m, "page_rows": meta.page_rows,
            "n_blocks": meta.n_blocks, "n_groups": meta.n_groups,
            "n_subparts": meta.n_subparts, "sk_subspaces": meta.sk_subspaces,
            "sk_codewords": meta.sk_codewords}


def free(device) -> None:
    """Release the port's search graphs and cached device memory."""
    from repro_torch.core import search_graph
    search_graph.clear_graphs()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
