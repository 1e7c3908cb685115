"""Mean host ms a frame of `cli.predict.save_frame` (Turbo render, PNG and .npy writes)."""


def read(r):
    return r.mean_ms("save")
