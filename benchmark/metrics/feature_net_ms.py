"""Mean device ms a frame of the feature net (both views as one batch), by CUDA events at its hooks."""


def read(r):
    return r.mean_ms("feature")
