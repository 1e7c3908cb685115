"""Genotype / architecture encoding shared by search, decode and retrain.

Mirrors reference ``models/genotypes_2d.py`` / ``genotypes_3d.py`` (PRIMITIVES
lists) and ``models/decoding_formulas.py:6-30`` (``network_layer_to_space``).

An architecture is fully described by:
  * ``network_path``: per-layer resolution level (0 -> 1/3 ... 3 -> 1/24),
    shape ``(num_layers,)``.
  * ``cell_genotype``: ``(2*steps, 2)`` int array of ``[edge_idx, op_idx]``
    rows — which DAG edges are active and which primitive each runs.

A copy of ``leastereo_tpu/models/genotypes.py`` (numpy only): importing the
JAX package's module would run its ``models/__init__.py``, which imports flax.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

__all__ = [
    "PRIMITIVES",
    "OP_SKIP",
    "OP_CONV",
    "Architecture",
    "network_layer_to_space",
    "load_architecture",
    "BEST_SCENEFLOW",
]

# Exactly two primitives in the reference search space
# (models/genotypes_2d.py:5-7, genotypes_3d.py:5-8).
PRIMITIVES = ("skip_connect", "conv_3x3")
OP_SKIP = 0
OP_CONV = 1

# level -> filter-multiplier scale (reference retrain/new_model_2d.py:97).
FILTER_SCALE = {0: 1, 1: 2, 2: 4, 3: 8}


@dataclasses.dataclass(frozen=True)
class Architecture:
    """A decoded (network_path, cell_genotype) pair for one sub-network."""

    network_path: tuple[int, ...]
    cell_genotype: tuple[tuple[int, int], ...]  # ((edge, op), ...)

    @property
    def num_layers(self) -> int:
        return len(self.network_path)

    def downup(self, layer: int) -> int:
        """-1 = downsample, 0 = same, +1 = upsample entering ``layer``.

        Matches reference derivation via one-hot space argmax
        (retrain/new_model_2d.py:107-117): layer 0 compares against the stem
        level 0.
        """
        prev = 0 if layer == 0 else self.network_path[layer - 1]
        return prev - self.network_path[layer]

    def active_edges(self) -> list[tuple[int, int]]:
        """Edges in *forward traversal order* paired with their ops.

        The reference pairs ops with edges positionally: ``_ops`` is built in
        genotype row order but consumed in ascending-edge order
        (retrain/new_model_2d.py:33-36 vs :58-68). We replicate that exactly.
        """
        edges_sorted = sorted(r[0] for r in self.cell_genotype)
        ops_in_row_order = [r[1] for r in self.cell_genotype]
        return list(zip(edges_sorted, ops_in_row_order))


def network_layer_to_space(net_arch: np.ndarray) -> np.ndarray:
    """Path -> one-hot (L, 4, 3) trellis space (reference decoding_formulas.py:6-30).

    space[layer][level][sample]; sample 0: down, 1: same, 2: up.
    """
    net_arch = np.asarray(net_arch, dtype=np.int64)
    space = np.zeros((len(net_arch), 4, 3))
    prev = None
    for i, layer in enumerate(net_arch):
        if i == 0:
            space[0, layer, 0] = 1
        else:
            sample = {prev + 1: 0, prev: 1, prev - 1: 2}[int(layer)]
            space[i, layer, sample] = 1
        prev = int(layer)
    return space


def space_to_network_path(space: np.ndarray) -> tuple[int, ...]:
    """Inverse of network_layer_to_space: argmax level per layer."""
    return tuple(int(np.argmax(space[i].sum(axis=1))) for i in range(space.shape[0]))


def load_architecture(net_path_file: str | pathlib.Path, genotype_file: str | pathlib.Path) -> Architecture:
    """Load the reference's ``.npy`` architecture artifacts
    (retrain/LEAStereo.py:16-21 input format)."""
    path = np.load(net_path_file)
    geno = np.load(genotype_file)
    return Architecture(
        network_path=tuple(int(v) for v in path),
        cell_genotype=tuple((int(r[0]), int(r[1])) for r in geno),
    )


# The best searched architecture shipped in the reference
# (run/sceneflow/best/architecture/*.npy; SURVEY.md §2.1).
BEST_SCENEFLOW = {
    "feature": Architecture(
        network_path=(1, 0, 1, 0, 0, 0),
        cell_genotype=((0, 1), (1, 0), (3, 1), (4, 1), (8, 1), (5, 1)),
    ),
    "matching": Architecture(
        network_path=(1, 1, 2, 2, 1, 2, 2, 2, 1, 1, 0, 1),
        cell_genotype=((1, 1), (0, 1), (3, 1), (4, 1), (8, 1), (6, 1)),
    ),
}
