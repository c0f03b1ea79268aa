"""Device operations a step: the kernels, memcpys and memsets in the
trace, over the traced steps. Every launch costs the host its call and
the device a gap; the count is exact where the profiler kept every
event."""


def read(t):
    return len(t.device) / t.steps if t.device else None
