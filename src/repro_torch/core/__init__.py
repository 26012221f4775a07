# The paper's primary contribution: probability-guaranteed c-AMIP search
# with a lightweight (iDistance) index -- ProMIPS, in PyTorch (the exports
# of `repro.core` that the port has; the facade is `repro_torch.api`).
from .chi2 import chi2_cdf, chi2_ppf, chi2_ppf_host
from .conditions import (
    compensation_radius,
    condition_a,
    condition_b,
    condition_b_threshold,
)
from .dim_opt import optimized_projected_dimension, quick_probe_cost
from .index import IndexArrays, IndexMeta, ProMIPSIndex, build_index
from .metrics import overall_ratio, recall_at_k
from .projections import make_projection, project
from .promips import ProMIPS
from .quick_probe import (
    GroupTable,
    build_group_table,
    group_lower_bounds,
    pack_codes,
    pack_codes_np,
    quick_probe,
    quick_probe_batch,
    unpack_bits,
)
from .runtime import RuntimeConfig, search_segments
from .runtime import search as runtime_search
from .search_device import SearchStats, search_batch, search_batch_progressive
from .search_host import HostSearcher, HostStats

__all__ = [
    "ProMIPS", "ProMIPSIndex", "IndexArrays", "IndexMeta", "build_index",
    "chi2_cdf", "chi2_ppf", "chi2_ppf_host",
    "condition_a", "condition_b", "condition_b_threshold", "compensation_radius",
    "optimized_projected_dimension", "quick_probe_cost",
    "overall_ratio", "recall_at_k",
    "make_projection", "project",
    "GroupTable", "build_group_table", "group_lower_bounds", "pack_codes",
    "pack_codes_np", "quick_probe", "quick_probe_batch", "unpack_bits",
    "RuntimeConfig", "runtime_search", "search_segments",
    "SearchStats", "search_batch", "search_batch_progressive",
    "HostSearcher", "HostStats",
]
