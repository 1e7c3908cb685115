"""The card's kernel-parity script (``leastereo_tpu_torch/utils/kernel_parity.py``)
on the CPU: it refuses to run without a card (its checks are of compiled
kernels), and its checks and JSON document, built here on the kernels'
plain versions (each wrapper's path for a CPU tensor) at small shapes: every
check named, within its 2e-3 px, and ``all_ok`` false when one is not.
"""

import json

import numpy as np
import pytest
import torch

from leastereo_tpu_torch import LEAStereoConfig, best_sceneflow_model
from leastereo_tpu_torch.utils import kernel_parity as kp

# Small stand-ins for the KITTI shapes: a (1, 16, 8, 6, 16) volume, maxdisp 24.
B, C, D, H, W, MAXDISP = 1, 16, 8, 6, 16, 24


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def checks():
    gen = torch.Generator().manual_seed(0)
    out = kp.head_checks(gen, B, C, D, H, W, MAXDISP, "cpu") + kp.band_checks(gen, B, D, H, W, MAXDISP, "cpu")
    model = best_sceneflow_model(LEAStereoConfig(maxdisp=48, compute_dtype="float32"), device="cpu")
    left, right = (torch.randn(1, 48, 96, 3, generator=gen) for _ in range(2))
    kp.calibrate_head(model, left, right)
    before = model.matching.last_3.conv.weight.clone()
    out += kp.in_model_checks(model, left, right)
    assert torch.equal(model.matching.last_3.conv.weight, before)  # the scales are undone
    return out


def test_kernel_parity_refuses_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "parity.json"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kp.main(["--out", str(out)])
    assert not out.exists()


def test_parity_report_of_plain_versions(checks):
    kernels = ("fused_head_sm90", "fused_head_sm90_f32", "fused_head", "band_soft_argmin", "in_model_fused")
    assert {c["kernel"] for c in checks} == set(kernels)
    assert {c["input"] for c in checks} == set(kp.KINDS)
    assert len(checks) == 3 * (4 + 1 + 1)  # per kind: 4 head checks, the band kernel, the model
    doc = json.loads(json.dumps(kp.report(checks, "cpu", dict(b=B, c=C, d=D, h=H, w=W, maxdisp=MAXDISP))))
    assert doc["device"] == "cpu" and doc["shape"]["maxdisp"] == MAXDISP and doc["all_ok"] is True
    assert len(doc["kernels"]) == len(checks)
    for name, r in doc["kernels"].items():
        assert r["atol"] == kp.ATOL_PX and r["ok"] is True, name
        assert 0.0 <= r["max_abs_err"] < 1e-3, (name, r)  # fp32 plain code against float64
    in_model = [doc["kernels"][f"in_model_fused_{k}_vs_f64"] for k in kp.KINDS]
    assert [r["last_3_scale"] for r in in_model] == [1.0, kp.WIDE, 0.1]
    assert all(r["route"] == "sm90_f32" and r["shape"] == [1, 32, 16, 16, 32] for r in in_model)
    bad = [dict(checks[0], max_abs_err=1.0, ok=False)] + checks[1:]
    assert kp.report(bad, "cpu", {})["all_ok"] is False
    with pytest.raises(ValueError, match="not unique"):
        kp.report(checks + checks[:1], "cpu", {})
    assert np.isfinite([r["max_abs_err"] for r in doc["kernels"].values()]).all()
