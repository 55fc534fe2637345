"""The share of the traced window in which no operation ran on the
device (1 - union of the device intervals / window), in %."""


def read(obs):
    if obs.trace is None or not obs.trace.window_s:
        return None
    return 100.0 * (1.0 - obs.trace.busy_s / obs.trace.window_s)
