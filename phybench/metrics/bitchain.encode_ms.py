"""Host milliseconds a step inside DlschCodec.encode_to_d (CRC24A,
segmentation, CRC24B, the turbo encoder) and DlschCodec.select_e (the
rate matching of a round), the encoder's launches included."""

_SITES = ["openair4g_tpu_torch.phy.pdsch:DlschCodec.encode_to_d",
          "openair4g_tpu_torch.phy.pdsch:DlschCodec.select_e"]
SITES = {"DlsimFading": {"bitchain.encode": _SITES},
         "Ulsim": {"bitchain.encode": _SITES}}


def read(t):
    if not t.has_span("bitchain.encode"):
        return None
    return t.span_s("bitchain.encode") / t.steps * 1e3
