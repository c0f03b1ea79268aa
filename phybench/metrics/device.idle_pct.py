"""The device's idle share of the traced window: 100 (1 - the union of
its busy intervals / the window's wall time), both from one trace."""


def read(t):
    if not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
