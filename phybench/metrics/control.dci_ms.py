"""Host milliseconds a step inside the DCI blind decode (phy/pdcch's
dci_blind_decode as sim/dlsim calls it: the search kernel, the CRC and
RNTI checks)."""

SITES = {"DlsimFading": {"control.dci": [
    "openair4g_tpu_torch.sim.dlsim:dci_blind_decode"]}}


def read(t):
    if not t.has_span("control.dci"):
        return None
    return t.span_s("control.dci") / t.steps * 1e3
