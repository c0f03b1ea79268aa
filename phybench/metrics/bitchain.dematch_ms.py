"""Host milliseconds a step inside the program's oai4g:decode.dematch
spans: DlschCodec.decode's rate de-matching with the HARQ combining over
the code blocks, ahead of the turbo decode (phybench/spans.py)."""
from phybench import spans

HOOKS = spans.HOOKS


def read(t):
    s = spans.of(t, "bitchain.dematch_ms", "decode.dematch")
    return None if s is None else s.host_ms("decode.dematch")
