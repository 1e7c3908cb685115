"""Share (%) of the profiled stretch in which no kernel, copy or set ran on the card."""


def read(r):
    return r.idle_pct()
