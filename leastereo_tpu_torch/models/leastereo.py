"""Full decoded stereo model (port of ``leastereo_tpu/models/leastereo.py``;
reference ``retrain/LEAStereo.py:12-52``).

``disparity = LEAStereo(left, right)``: the shared-weight Feature Net on both
views, the fused cost-volume stem and the 3-D Matching Net, then the head:

* eval, not ``fast_head``, not ``return_entropy``, and a fused-head gate
  admits the shape: the ``last_3`` conv and the soft-argmin run as one CUDA
  kernel (``ops/fused_head.py``: the sm90 head of the volume's type, bf16
  or fp32, read in place by TMA or, for rows TMA cannot describe, copied to
  padded rows first);
* otherwise the ``last_3`` conv (cuDNN), then ``soft_argmin_fast`` when
  ``fast_head`` is set, else the band kernel (``ops/fused_softargmin.py``).
  ``pallas_head=False`` selects the plain ``soft_argmin`` instead of either
  kernel.

Both kernels are reached through the custom ops ``torch.ops.leastereo.*``
(``conv_soft_argmin_fused``, ``soft_argmin_fused``), so ``torch.export``
traces the model with them in its graph. The routing above reads only
shapes, dtypes and the config, and so traces; the op itself picks the
route from the volume it is given (its width and address).

A refused fused head is logged once per reason and falls to the band kernel;
a CUDA cost the band kernel refuses (``maxdisp != 3 * D``, or ``D > 569``)
raises rather than run the plain version on the card. On a CPU tensor each
kernel wrapper runs its plain version. Inputs are NHWC
``(B, H, W, 3)`` with H, W divisible by 3 (and by 12 at 1/3 resolution for
the deepest matching level), as in the JAX model; the output is ``(B, H, W)``
fp32, or ``(disp, entropy)`` with ``return_entropy``.

With ``cost_volume_pspec`` naming the ``disp`` axis, the matching net runs
on this rank's slab of the volume's D planes over the ``disp`` group of
``self.mesh`` (``parallel/mesh.py``; ``None`` is a 1x1 mesh), and the head
is the plain distributed soft-argmin (``soft_argmin_sharded``, or
``soft_argmin_fast_sharded`` with ``fast_head``): neither CUDA head runs
there, as the JAX package gates its kernels off under a pspec
(``leastereo_tpu/models/leastereo.py:126,171``). In eval and in training:
every piece of the sharded path has its backward, and ``train/step.py``
sets the BatchNorm groups and sums the gradients over the mesh.
"""

from __future__ import annotations

import dataclasses
import logging

import torch
import torch.nn as nn

from ..ops.fused_head import conv_soft_argmin_fused, fused_head_route, fused_head_sm90_gate_reason
from ..ops.fused_softargmin import soft_argmin_fused
from ..ops.softargmin import (
    disparity_entropy,
    disparity_entropy_sharded,
    soft_argmin,
    soft_argmin_fast,
    soft_argmin_fast_sharded,
    soft_argmin_sharded,
)
from ..parallel.halo import DispPartition
from ..parallel.mesh import DATA_AXIS, DISP_AXIS
from .feature_net import FeatureNet
from .genotypes import BEST_SCENEFLOW, Architecture
from .matching_net import MatchingNet

__all__ = ["LEAStereoConfig", "LEAStereo", "best_sceneflow_model", "require_cuda"]

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class LEAStereoConfig:
    """Shape hyper-parameters (reference ``config_utils/leastereo_args.py:4-13``);
    field names as in the JAX ``LEAStereoConfig``."""

    maxdisp: int = 192
    fea_filter_multiplier: int = 8
    fea_block_multiplier: int = 4
    fea_steps: int = 3
    mat_filter_multiplier: int = 8
    mat_block_multiplier: int = 4
    mat_steps: int = 3
    compute_dtype: str = "bfloat16"
    fast_head: bool = False  # soft_argmin_fast serving head
    # Fuse the cost volume into the matching stem0 (ops/fused_stem.py);
    # False builds the explicit volume.
    fused_stem: bool = True
    # Use the CUDA heads (fused head, else band kernel); False runs the
    # plain soft_argmin after the last_3 conv.
    pallas_head: bool = True
    # Also return the disparity-entropy confidence map (predict --confidence).
    return_entropy: bool = False
    # Axis names constraining the (B, D, H, W, C) cost volume, as in the JAX
    # config: ("data", "disp") shards the disparity axis over the mesh's disp
    # ranks (the CP analog for maxdisp-408 Middlebury frames). Set, it gates
    # both CUDA heads off, as in JAX; the model's ``mesh`` names the ranks.
    cost_volume_pspec: tuple | None = None

    def __post_init__(self):
        pspec = self.cost_volume_pspec
        if pspec is not None and any(a not in (None, DATA_AXIS, DISP_AXIS) for a in pspec):
            raise ValueError(f"cost_volume_pspec {pspec}: axes are {DATA_AXIS!r}, {DISP_AXIS!r} or None")

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


class LEAStereo(nn.Module):
    def __init__(
        self,
        feature_arch: Architecture,
        matching_arch: Architecture,
        config: LEAStereoConfig = LEAStereoConfig(),
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        cfg = config
        self.config = cfg
        self.feature = FeatureNet(
            feature_arch, cfg.fea_filter_multiplier, cfg.fea_block_multiplier, cfg.fea_steps, generator
        )
        self.matching = MatchingNet(
            matching_arch,
            cfg.fea_filter_multiplier * cfg.fea_block_multiplier,
            cfg.mat_filter_multiplier,
            cfg.mat_block_multiplier,
            cfg.mat_steps,
            generator=generator,
        )
        self._gate_warned: set[str] = set()
        self.mesh = None  # parallel.Mesh of a cost_volume_pspec run; None: 1x1

    def _warn_once(self, msg: str) -> None:
        if msg not in self._gate_warned:
            self._gate_warned.add(msg)
            logger.warning(msg)

    def forward(self, left: torch.Tensor, right: torch.Tensor):
        """NHWC ``(B, H, W, 3)`` images -> ``(B, H, W)`` fp32 disparity."""
        cfg = self.config
        dtype = cfg.dtype
        b, h, w = left.shape[:3]
        if h % 3 or w % 3:
            # The stride-3 stem would round up and return a larger map; sizes
            # that divide by 3 but not by the deeper levels fail in the nets.
            raise ValueError(f"input {h}x{w}: height and width must be divisible by 3")
        # Shared weights across views (reference retrain/LEAStereo.py:31-32).
        if self.training:
            # One call per view, as the reference and the JAX model
            # (leastereo_tpu/models/leastereo.py:97-99): each BN normalises
            # with one view's statistics and updates its running stats per view.
            f_left = self.feature(left.permute(0, 3, 1, 2).to(dtype))
            f_right = self.feature(right.permute(0, 3, 1, 2).to(dtype))
        else:
            # Eval BN reads running stats, so both views run as one batch.
            feats = self.feature(torch.cat([left, right]).permute(0, 3, 1, 2).to(dtype))
            f_left, f_right = feats[:b], feats[b:]
        if cfg.cost_volume_pspec is not None:
            return self._sharded_head(f_left, f_right)
        vol = self.matching(f_left, f_right, cfg.maxdisp // 3, fused_stem=cfg.fused_stem)

        last_3 = self.matching.last_3
        kernel = last_3.conv.weight.to(dtype)
        if cfg.pallas_head and not self.training and not cfg.fast_head and not cfg.return_entropy:
            _, c, d, _, w = vol.shape
            if fused_head_route(c, d, w, cfg.maxdisp, vol.dtype) is not None:
                return conv_soft_argmin_fused(vol, kernel, cfg.maxdisp)
            self._warn_once(f"fused head disabled: {fused_head_sm90_gate_reason(c, d, cfg.maxdisp, vol.dtype)}")
        cost = last_3(vol)[:, 0]  # (B, D, h, w)
        if cfg.fast_head:
            disp = soft_argmin_fast(cost, cfg.maxdisp)
        elif cfg.pallas_head:
            # No plain fallback here: a CUDA cost the band kernel refuses
            # raises in the wrapper with its reason.
            disp = soft_argmin_fused(cost, cfg.maxdisp)
        else:
            disp = soft_argmin(cost, cfg.maxdisp)
        if cfg.return_entropy:
            return disp, disparity_entropy(cost, cfg.maxdisp)
        return disp

    def disp_partition(self) -> DispPartition:
        """The partition of the volume's ``maxdisp // 3`` planes over this
        rank's ``disp`` group (one shard when the pspec leaves D whole or
        there is no mesh)."""
        pspec, mesh = self.config.cost_volume_pspec, self.mesh
        depth = self.config.maxdisp // 3
        if mesh is None or pspec is None or len(pspec) < 2 or pspec[1] != DISP_AXIS or mesh.disp == 1:
            return DispPartition(depth)
        return DispPartition(depth, mesh.disp, mesh.disp_index, mesh.disp_group)

    def _sharded_head(self, f_left: torch.Tensor, f_right: torch.Tensor):
        """The matching net on this rank's slab and the plain distributed head."""
        cfg = self.config
        part = self.disp_partition()
        vol = self.matching(f_left, f_right, part.depth, fused_stem=cfg.fused_stem, part=part)
        cost = self.matching.last_3(vol, part)[:, 0]
        head = soft_argmin_fast_sharded if cfg.fast_head else soft_argmin_sharded
        disp = head(cost, part, cfg.maxdisp)
        if cfg.return_entropy:
            return disp, disparity_entropy_sharded(cost, part, cfg.maxdisp)
        return disp


def require_cuda() -> None:
    """Raise unless a CUDA card is present: the port never moves to the CPU
    unasked."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run the model on the CPU")


def best_sceneflow_model(
    config: LEAStereoConfig = LEAStereoConfig(), device: str | torch.device | None = None, seed: int = 0
) -> LEAStereo:
    """The shipped best-searched architecture (reference
    ``run/sceneflow/best/architecture/*.npy``), initialised from ``seed``, in
    eval mode, on ``device``. ``None`` means the CUDA card; without one this
    raises rather than run on the CPU unasked."""
    if device is None:
        require_cuda()
        device = "cuda"
    gen = torch.Generator().manual_seed(seed)
    model = LEAStereo(BEST_SCENEFLOW["feature"], BEST_SCENEFLOW["matching"], config, gen)
    return model.to(device).eval()
