"""Decoded LEAStereo model of the port (feature net, matching net, heads)."""

from .genotypes import BEST_SCENEFLOW, Architecture
from .leastereo import LEAStereo, LEAStereoConfig, best_sceneflow_model

__all__ = ["Architecture", "BEST_SCENEFLOW", "LEAStereo", "LEAStereoConfig", "best_sceneflow_model"]
