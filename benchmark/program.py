"""The system under test, built from a configuration file: the port's
``LEAStereo`` holding the benchmark's weights. The harness's only other
contact with the program is the cell drivers' calls into its entry points."""

from __future__ import annotations

import torch

__all__ = ["build_model", "launch_counts"]


def build_model(cfg: dict, state: dict, device, train: bool = False):
    """``leastereo_tpu_torch``'s model of configuration ``cfg`` with a copy of
    ``state``, in eval (or train) mode on ``device``."""
    from leastereo_tpu_torch.models import LEAStereo, LEAStereoConfig
    from leastereo_tpu_torch.models.genotypes import Architecture

    def arch(net: dict) -> Architecture:
        return Architecture(tuple(net["network_path"]), tuple(tuple(r) for r in net["cell_genotype"]))

    f, m = cfg["feature"], cfg["matching"]
    config = LEAStereoConfig(
        maxdisp=cfg["maxdisp"],
        fea_filter_multiplier=f["filter_multiplier"],
        fea_block_multiplier=f["block_multiplier"],
        fea_steps=f["steps"],
        mat_filter_multiplier=m["filter_multiplier"],
        mat_block_multiplier=m["block_multiplier"],
        mat_steps=m["steps"],
        compute_dtype=cfg["compute_dtype"],
    )
    with torch.device("meta"):  # no init on the host: the weights are the benchmark's
        model = LEAStereo(arch(f), arch(m), config)
    model = model.to_empty(device=device)
    model.load_state_dict(state)
    return model.train(train)


def launch_counts() -> dict:
    """The launches each of the program's hand-written head wrappers has
    counted in this process."""
    from leastereo_tpu_torch.ops.fused_head import ROUTE_WRAPPERS
    from leastereo_tpu_torch.ops.fused_softargmin import soft_argmin_cuda

    counts = {fn.__name__: fn.launches for fn in ROUTE_WRAPPERS.values()}
    counts[soft_argmin_cuda.__name__] = soft_argmin_cuda.launches
    return counts
