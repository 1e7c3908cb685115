"""PyTorch + CUDA port of ``leastereo_tpu`` for one NVIDIA H100.

The JAX package stays the reference; this package mirrors its module paths
(``ops/``, ``models/``, ``utils/``) and is tested against it on the same
numpy-seeded inputs (``tests/test_torch_*.py``). Layouts at the public
boundary follow the JAX package (``LEAStereo.forward`` takes NHWC images and
returns ``(B, H, W)``); inside, tensors are NCHW and NCDHW, the eval matching
net's volumes NDHWC (``ops/layout.py``), so convolutions go to cuDNN. The two Pallas TPU kernels are hand-written CUDA kernels in ``csrc/``
(the fused head in ``fused_head_sm90.cu``, the band kernel in
``soft_argmin_heads.cu``), built with
``nvcc`` at first use (``ops/_build.py``), beside the kernels of the eval
matching net's NDHWC volumes (``ndhwc.cu``) and its 3x3x3 convolutions
(``conv3d_sm90.cu``). Importing the package registers the heads as the
custom ops ``torch.ops.leastereo.conv_soft_argmin`` and
``torch.ops.leastereo.band_soft_argmin``, and the NDHWC resize and the two
fused convolutions as ``torch.ops.leastereo.resize3d_ndhwc``,
``torch.ops.leastereo.conv_bias_relu`` and
``torch.ops.leastereo.conv3d_bias_relu_sm90``, so import it before
``torch.export.load`` of a program it exported (``cli/export.py``).
"""

from .models import LEAStereo, LEAStereoConfig, best_sceneflow_model
from .ops import fused_head, fused_softargmin  # noqa: F401  (register torch.ops.leastereo.*)

__all__ = ["LEAStereo", "LEAStereoConfig", "best_sceneflow_model"]
