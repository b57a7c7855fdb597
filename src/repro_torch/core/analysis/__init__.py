"""EvalNet analysis on torch: APSP, path multiplicities, spectral bounds,
histograms, the device wavefront and squaring engines, and the
single-device out-of-core engine and sampled-sources estimator."""
from .apsp import (  # noqa: F401
    apsp_dense, apsp_from_lengths, bfs_distances, sampled_distances,
)
from .metrics import AnalysisEngine, analyze, path_diversity  # noqa: F401
from .paths import (  # noqa: F401
    brute_force_path_counts, edge_interference, path_counts_with_slack,
    shortest_path_multiplicity, tropical_count_relaxation,
)
from .wavefront import (  # noqa: F401
    dist_mult_device, ecmp_loads_device, squaring_apsp_device,
    wavefront_dist_mult,
)
from .distributed import (  # noqa: F401
    tiled_dist_mult, tiled_dist_mult_tiles, tiled_summary,
)
from .engine_select import EnginePlan, resolve_engine  # noqa: F401
from .estimator import bootstrap_ci, sampled_sources_summary  # noqa: F401
from .spectral import fiedler_value, spectral_bounds  # noqa: F401
from .histograms import path_length_histogram  # noqa: F401
