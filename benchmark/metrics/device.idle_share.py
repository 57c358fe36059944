"""The share of the profiled frames' time (host clock, from the profiler's
start to its stop) in which no operation ran on the card: 100 (1 - busy /
elapsed), busy being the union of the device operations' intervals."""


def read(w):
    if w.device is None or w.busy_s is None:
        return None
    return 100.0 * (1.0 - w.busy_s / (w.device.t1 - w.device.t0))
