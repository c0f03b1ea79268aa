"""Host milliseconds a step inside the program's oai4g:control.uci spans:
the uplink's round-0 UCI decode (the CQI Viterbi, RI and ACK) and its
error counts (phybench/spans.py)."""
from phybench import spans

HOOKS = spans.HOOKS


def read(t):
    s = spans.of(t, "control.uci_ms", "control.uci")
    return None if s is None else s.host_ms("control.uci")
