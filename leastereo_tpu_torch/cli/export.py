"""Model export driver (port of ``leastereo_tpu/cli/export.py``; reference
``make_onnx.py``): ``torch.export`` of the eval forward, saved as a ``.pt2``
file, with a numeric round-trip check against the eager model.

    python -m leastereo_tpu_torch.cli.export --checkpoint w.pth --height 384 --width 1248 --out kitti.pt2

The heads are the custom ops ``torch.ops.leastereo.conv_soft_argmin`` and
``torch.ops.leastereo.band_soft_argmin``, so the program carries them: on the
card it launches the hand-written kernels, on the CPU their plain versions.
A program exported on the card carries the matching net's NDHWC resizes
and fused convolutions as ``torch.ops.leastereo.resize3d_ndhwc``,
``torch.ops.leastereo.conv_bias_relu`` and
``torch.ops.leastereo.conv3d_bias_relu_sm90`` too, the calls the eager
model makes.
Shapes are static (``(1, H, W, 3)`` fp32 NHWC, as the JAX export), and
``torch.export`` fixes the device: a program exported with ``--device cuda``
(the default) runs on the card only. Import the package before loading, so
the ops are registered::

    import leastereo_tpu_torch  # noqa: F401
    prog = torch.export.load("kitti.pt2").module()
    disp = prog(left, right)  # (1, H, W) fp32
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..utils.checkpoint import load_state_dict_file
from .common import build_model
from .config import export_parser

__all__ = ["main", "export_pt2"]


def export_pt2(model: torch.nn.Module, height: int, width: int, device) -> torch.export.ExportedProgram:
    """``torch.export`` of ``model``'s eval forward for one ``(1, height,
    width, 3)`` fp32 NHWC pair on ``device``."""
    # Two tensors: export traces one tensor passed twice as one input.
    left, right = (torch.zeros((1, height, width, 3), dtype=torch.float32, device=device) for _ in range(2))
    with torch.no_grad():
        return torch.export.export(model.eval(), (left, right))


def main(argv=None) -> int:
    args = export_parser().parse_args(argv)
    model = build_model(args)
    if args.checkpoint:
        load_state_dict_file(args.checkpoint, model)
    torch.export.save(export_pt2(model, args.height, args.width, args.device), args.out)

    # Numeric self-check, as the JAX driver's (and the reference's
    # onnxruntime validation, make_onnx.py:63-81): load and compare outputs.
    rng = np.random.RandomState(0)
    left = torch.from_numpy(rng.randn(1, args.height, args.width, 3).astype(np.float32)).to(args.device)
    right = torch.from_numpy(rng.randn(1, args.height, args.width, 3).astype(np.float32)).to(args.device)
    with torch.no_grad():
        want = model(left, right).float().cpu().numpy()
        got = torch.export.load(args.out).module()(left, right).float().cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    print(f"exported .pt2 to {args.out} ({os.path.getsize(args.out)} bytes); round-trip check passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
