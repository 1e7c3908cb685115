"""NAS search of the port (port of ``leastereo_tpu/search``): the searchable
cell, the trellis supernets, the bilevel steps and the numpy decoder.

Counterparts of the JAX package's names: ``make_weight_tx`` /
``make_arch_tx`` -> :func:`make_weight_optimizer` / :func:`make_arch_optimizer`,
``make_search_steps`` -> :func:`weight_step` / :func:`arch_step`,
``arch_label_tree`` -> ``AutoStereoSupernet.arch_parameters()`` /
``weight_parameters()``. ``SearchState`` has none: the modules and the
optimizers hold the state.
"""

from .bilevel import arch_step, cosine_iter_schedule, make_arch_optimizer, make_weight_optimizer, search_loss, weight_step
from .cells import SearchCell, num_edges, s0_edge_indices
from .decode import decode_arch, genotype_decode, normalize_betas_np, save_decoded, viterbi_decode
from .supernet import AutoStereoSupernet, FeatureSupernet, MatchingSupernet, SupernetConfig, normalize_betas

__all__ = [
    "arch_step",
    "cosine_iter_schedule",
    "make_arch_optimizer",
    "make_weight_optimizer",
    "search_loss",
    "weight_step",
    "SearchCell",
    "num_edges",
    "s0_edge_indices",
    "decode_arch",
    "genotype_decode",
    "normalize_betas_np",
    "save_decoded",
    "viterbi_decode",
    "AutoStereoSupernet",
    "FeatureSupernet",
    "MatchingSupernet",
    "SupernetConfig",
    "normalize_betas",
]
