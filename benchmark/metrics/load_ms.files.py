"""Mean host ms a frame of `StereoListDataset.load_stack` (PNG decode, standardisation)."""


def read(r):
    return r.mean_ms("load")
