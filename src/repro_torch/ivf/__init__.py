"""IVF-over-BQ coarse routing.

Training-free inverted lists in 2-bit Sign-Magnitude space: majority
centroids, a contiguous list layout and kernel-dispatched list scans,
behind the IVF-seeded build (``BuildParams(ivf_candidates=True)``) and
``QuIVerIndex.search(nav="ivf")``.  Counterpart of ``repro/ivf``.
"""

from repro_torch.ivf.partition import (
    IVFPartition,
    build_partition,
    default_n_lists,
)
from repro_torch.ivf.search import (
    ivf_probes,
    list_candidates,
    record_routes,
    scan_search,
    top_lists,
)

__all__ = [
    "IVFPartition",
    "build_partition",
    "default_n_lists",
    "ivf_probes",
    "list_candidates",
    "record_routes",
    "scan_search",
    "top_lists",
]
