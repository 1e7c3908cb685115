"""Decode driver: search checkpoint -> genotype ``.npy`` artifacts (port of
``leastereo_tpu/cli/decode.py``; reference ``decode.py``).

    python -m leastereo_tpu_torch.cli.decode \
        --checkpoint run/sceneflow_part-search/default/checkpoints/best

``--checkpoint`` is a torch file written by ``cli.search`` (or a reference
search ``.pth``), or a checkpoint kind directory: its latest epoch, or the
epoch ``--step``. Writes the four files ``load_architecture`` reads into
``--out_dir`` (default ``<checkpoint dir>/architecture``).
"""

from __future__ import annotations

import os
import sys

import torch

from ..search import decode_arch, save_decoded
from ..utils.checkpoint import latest_checkpoint
from .config import decode_parser

__all__ = ["main"]


def main(argv=None) -> int:
    args = decode_parser().parse_args(argv)
    if os.path.isfile(args.checkpoint):
        path, ckpt_dir = args.checkpoint, os.path.dirname(args.checkpoint)
    else:
        ckpt_dir = args.checkpoint
        path = (os.path.join(ckpt_dir, f"{args.step}.pth") if args.step is not None
                else latest_checkpoint(ckpt_dir))
        if path is None or not os.path.isfile(path):
            raise FileNotFoundError(f"no checkpoint {path or ''} under {args.checkpoint}")
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("state_dict", obj)
    sd = {k.removeprefix("module."): v for k, v in sd.items()}

    def arch(net: str, steps: int):
        return decode_arch(sd[f"{net}.alphas"].float().numpy(), sd[f"{net}.betas"].float().numpy(), steps=steps)

    fea = arch("feature", args.fea_step)
    mat = arch("matching", args.mat_step)
    out_dir = args.out_dir or os.path.join(ckpt_dir, "architecture")
    paths = save_decoded(out_dir, fea, mat)
    print(f"feature path:  {fea[0].tolist()}")
    print(f"matching path: {mat[0].tolist()}")
    for k, v in paths.items():
        print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
