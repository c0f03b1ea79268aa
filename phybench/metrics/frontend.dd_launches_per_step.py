"""Kernels, copies and fills a step launched inside the program's
oai4g:estimate.dd spans (the decision-directed channel estimate), tied
to their launching calls by the trace's correlation ids
(phybench/spans.py)."""
from phybench import spans

HOOKS = spans.HOOKS


def read(t):
    s = spans.of(t, "frontend.dd_launches_per_step", "estimate.dd",
                 device=True)
    return None if s is None else s.launches("estimate.dd")
