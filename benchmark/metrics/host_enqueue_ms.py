"""Mean host ms a frame from the model's forward pre-hook to its post-hook: the kernels enqueued, not waited for."""


def read(r):
    return r.mean_ms("host_enqueue")
