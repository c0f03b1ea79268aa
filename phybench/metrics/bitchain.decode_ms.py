"""Host milliseconds a step inside DlschCodec.decode: the rate
de-matching with the HARQ combining, the turbo decode kernel's launch and
the TB CRC."""

_SITES = ["openair4g_tpu_torch.phy.pdsch:DlschCodec.decode"]
SITES = {"DlsimFading": {"bitchain.decode": _SITES},
         "Ulsim": {"bitchain.decode": _SITES}}


def read(t):
    if not t.has_span("bitchain.decode"):
        return None
    return t.span_s("bitchain.decode") / t.steps * 1e3
