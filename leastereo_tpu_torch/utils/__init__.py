"""Utilities of the port (the names ``leastereo_tpu/utils`` exports, for the
modules the port has; checkpoints are torch ``.pth`` files, so
``load_state_dict_file`` and ``latest_checkpoint`` stand where the JAX
package has ``restore_checkpoint``, ``tolerant_merge`` and ``latest_step``)."""

from .checkpoint import latest_checkpoint, load_state_dict_file, save_checkpoint
from .classic_eval import midd_eval_average, midd_eval_sample
from .colorize import colorize_disparity, turbo_colormap
from .experiment import EarlyStopping, ExperimentSaver
from .profiling import (
    cost_analysis,
    count_params,
    device_peak_hbm_gb,
    model_flops,
    param_size_mb,
    peak_hbm_gb,
)

__all__ = [
    "midd_eval_average",
    "midd_eval_sample",
    "latest_checkpoint",
    "load_state_dict_file",
    "save_checkpoint",
    "colorize_disparity",
    "turbo_colormap",
    "EarlyStopping",
    "ExperimentSaver",
    "cost_analysis",
    "count_params",
    "model_flops",
    "param_size_mb",
]
