"""Device milliseconds a step of the operations launched inside the
program's oai4g:estimate.dd spans: the decision-directed channel estimate
(the joint estimate, the ZF decisions and their confidence weights, the
refinement over the data REs and the pilots), phybench/spans.py."""
from phybench import spans

HOOKS = spans.HOOKS


def read(t):
    s = spans.of(t, "frontend.dd_device_ms", "estimate.dd", device=True)
    return None if s is None else s.device_ms("estimate.dd")
