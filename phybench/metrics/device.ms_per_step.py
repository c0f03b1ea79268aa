"""Device milliseconds a step: every device event's time in the traced
window, summed, over the traced steps."""


def read(t):
    if not t.device:
        return None
    return t.device_s() / t.steps * 1e3
