"""The reference's FLOPs of the window's work over its seconds, as a share (%) of the dense bf16 peak."""

from benchmark.reference.flops import PEAK_BF16_FLOPS


def read(r):
    flops = r.facts.get("flops_per_unit")
    return None if not flops else 100.0 * flops * r.units / (r.window_s * PEAK_BF16_FLOPS)
