"""The fused head's least time (bytes or FLOPs of its volume at the peak) over the device time of the
kernels launched under `leastereo::conv_soft_argmin`, a call, as a share (%)."""

OPERATOR = "leastereo::conv_soft_argmin"


def read(r):
    op = r.trace.get("ops", {}).get(OPERATOR)
    least = r.facts.get("head_least_s")
    if not op or not op["calls"] or op["device_s"] <= 0 or not least:
        return None
    return 100.0 * least / (op["device_s"] / op["calls"])
