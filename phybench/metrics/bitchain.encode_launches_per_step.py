"""Kernels, copies and fills a step launched inside the program's
oai4g:bitchain.encode spans, tied to their launching calls by the
trace's correlation ids (phybench/spans.py)."""
from phybench import spans

HOOKS = spans.HOOKS


def read(t):
    s = spans.of(t, "bitchain.encode_launches_per_step", "bitchain.encode",
                 device=True)
    return None if s is None else s.launches("bitchain.encode")
