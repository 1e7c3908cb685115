"""CLI drivers of the port: ``python -m leastereo_tpu_torch.cli.<driver>``.

Driver map (reference -> JAX package -> here):
  predict.py    -> leastereo_tpu.cli.predict  -> leastereo_tpu_torch.cli.predict
  evaluation.py -> leastereo_tpu.cli.evaluate -> leastereo_tpu_torch.cli.evaluate
  train.py      -> leastereo_tpu.cli.train    -> leastereo_tpu_torch.cli.train
  search.py     -> leastereo_tpu.cli.search   -> leastereo_tpu_torch.cli.search
  decode.py     -> leastereo_tpu.cli.decode   -> leastereo_tpu_torch.cli.decode
  make_onnx.py  -> leastereo_tpu.cli.export   -> leastereo_tpu_torch.cli.export (.pt2)

``--checkpoint`` and ``--resume`` read torch state_dict files, so a
reference ``.pth`` needs no conversion (the JAX package's ``cli.convert``).
"""
