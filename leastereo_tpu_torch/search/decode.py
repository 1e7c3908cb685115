"""Architecture decoding: searched (alphas, betas) -> discrete genotype.

A copy of ``leastereo_tpu/search/decode.py`` (numpy only), itself a port of
reference ``models/decoding_formulas.py:33-112`` and the ``decode.py``
driver: beta re-normalization (same formulas as the supernet forward),
max-product Viterbi over layer transitions with up/down legality
constraints, and top-2-edges-per-node genotype extraction. Emits the same
four ``.npy`` artifacts the fixed-model loader consumes
(``leastereo_tpu_torch.models.genotypes.load_architecture``).
"""

from __future__ import annotations

import os

import numpy as np

from ..models.genotypes import network_layer_to_space

__all__ = ["normalize_betas_np", "viterbi_decode", "genotype_decode", "decode_arch", "save_decoded"]


def _softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def normalize_betas_np(betas: np.ndarray) -> np.ndarray:
    """Exact parity with reference ``Decoder.__init__``
    (decoding_formulas.py:40-58): per-layer row normalization with edge
    corrections; rows for not-yet-existing levels stay zero."""
    num_layers = betas.shape[0]
    out = np.zeros_like(betas, dtype=np.float64)
    for layer in range(num_layers):
        out[layer, 0, 1:] = _softmax(betas[layer, 0, 1:]) * (2 / 3)
        if layer >= 1:
            out[layer, 1] = _softmax(betas[layer, 1])
        if layer >= 2:
            out[layer, 2] = _softmax(betas[layer, 2])
        if layer >= 3:
            out[layer, 3, :2] = _softmax(betas[layer, 3, :2]) * (2 / 3)
    return out


def viterbi_decode(betas: np.ndarray) -> np.ndarray:
    """Max-product DP over the (layer, level) trellis -> best level path.

    Parity with reference ``Decoder.viterbi_decode``
    (decoding_formulas.py:60-92). ``network[l][u][k]`` is the probability of
    leaving level ``u`` at layer ``l`` in direction ``k`` (0 up, 1 same,
    2 down); a target level ``s`` at layer ``l`` is reachable from source
    ``s+1-k`` with weight ``network[l][s+1-k][k]``.
    """
    network = normalize_betas_np(betas)
    num_layers = network.shape[0]
    prob = np.zeros((num_layers, 4))
    # back[l][s]: level delta (source - target) chosen entering (l, s).
    back = np.zeros((num_layers, 4), dtype=np.int8)

    prob[0][0] = network[0][0][1]
    prob[0][1] = network[0][0][2]
    back[0][0] = 0
    back[0][1] = -1

    for layer in range(1, num_layers):
        for s in range(4):
            if layer - s < -1:
                continue
            candidates = []  # (prob, rate)
            for rate in range(3):
                if (s == 0 and rate == 2) or (s == 3 and rate == 0):
                    continue
                src = s + 1 - rate
                candidates.append((prob[layer - 1][src] * network[layer][src][rate], rate))
            best = max(range(len(candidates)), key=lambda i: candidates[i][0])
            prob[layer][s] = candidates[best][0]
            rate = candidates[best][1]
            back[layer][s] = 1 - rate  # level delta: source - target

    path = np.zeros(num_layers, dtype=np.uint8)
    path[-1] = int(np.argmax(prob[-1]))
    for i in range(1, num_layers):
        path[-i - 1] = path[-i] + back[num_layers - i, path[-i]]
    return path


def genotype_decode(alphas: np.ndarray, steps: int) -> np.ndarray:
    """Top-2 incoming edges per DAG node ranked by the strongest non-skip op
    weight, argmax op per chosen edge -> (2*steps, 2) [edge, op] rows.
    Parity with reference ``Decoder.genotype_decode``
    (decoding_formulas.py:94-112)."""
    a = _softmax(alphas)
    gene = []
    start, n = 0, 2
    for _ in range(steps):
        end = start + n
        edges = sorted(range(start, end), key=lambda x: -np.max(a[x, 1:]))
        for j in edges[:2]:
            gene.append([j, int(np.argmax(a[j]))])
        start = end
        n += 1
    return np.array(gene)


def decode_arch(alphas: np.ndarray, betas: np.ndarray, steps: int = 3):
    """-> (network_path, one-hot network space, cell genotype)."""
    path = viterbi_decode(betas)
    return path, network_layer_to_space(path), genotype_decode(alphas, steps)


def save_decoded(out_dir: str, feature: tuple, matching: tuple) -> dict:
    """Write the four reference-format artifacts
    (reference decode.py:54-63) and return their paths."""
    os.makedirs(out_dir, exist_ok=True)
    fea_path, _, fea_gene = feature
    mat_path, _, mat_gene = matching
    paths = {
        "net_arch_fea": os.path.join(out_dir, "feature_network_path.npy"),
        "cell_arch_fea": os.path.join(out_dir, "feature_genotype.npy"),
        "net_arch_mat": os.path.join(out_dir, "matching_network_path.npy"),
        "cell_arch_mat": os.path.join(out_dir, "matching_genotype.npy"),
    }
    np.save(paths["net_arch_fea"], fea_path)
    np.save(paths["cell_arch_fea"], fea_gene)
    np.save(paths["net_arch_mat"], mat_path)
    np.save(paths["cell_arch_mat"], mat_gene)
    return paths
