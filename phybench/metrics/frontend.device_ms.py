"""Device milliseconds a step of the operations launched inside the
program's oai4g:frontend spans: the channel and AWGN, OFDM or SC-FDMA,
the channel estimate, the equalisation and the data LLRs
(phybench/spans.py)."""
from phybench import spans

HOOKS = spans.HOOKS


def read(t):
    s = spans.of(t, "frontend.device_ms", "frontend", device=True)
    return None if s is None else s.device_ms("frontend")
