"""Host waits on the device a step: the synchronize calls and blocking
copies among the trace's runtime calls made inside the steps, over the
traced steps. The benchmark's own read of each step's counts is one of
them; the sync that closes the traced window, outside every step, is
not counted."""

WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


def read(t):
    if not t.runtime:
        return None
    steps = [(a, b) for label, a, b in t.spans if label == "step"]
    return sum(name in WAITS and any(a <= t0 < b for a, b in steps)
               for name, t0, _ in t.runtime) / t.steps
