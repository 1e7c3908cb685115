"""Mean device ms a frame of the matching net with the fused stem, by CUDA events at its hooks."""


def read(r):
    return r.mean_ms("matching")
