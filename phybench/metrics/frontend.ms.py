"""Host milliseconds a step inside the front end and detection: the
channel, OFDM or SC-FDMA, the channel estimate, the equalisation and the
LLRs, at the sites where each simulator looks them up."""

SITES = {
    "DlsimFading": {"frontend": [
        "openair4g_tpu_torch.sim.dlsim:DlsimFading._channel",
        "openair4g_tpu_torch.sim.dlsim:extract_data_res",
        "openair4g_tpu_torch.sim.dlsim:estimate_channel_joint",
        "openair4g_tpu_torch.sim.dlsim:mrc_llr"]},
    "Ulsim": {"frontend": [
        "openair4g_tpu_torch.sim.ulsim:Ulsim._channel",
        "openair4g_tpu_torch.sim.ulsim:pusch_fill_grid_x",
        "openair4g_tpu_torch.sim.ulsim:pusch_extract",
        "openair4g_tpu_torch.sim.ulsim:ul_estimate_channel",
        "openair4g_tpu_torch.sim.ulsim:scfdma_mmse_equalize",
        "openair4g_tpu_torch.sim.ulsim:transform_deprecode",
        "openair4g_tpu_torch.sim.ulsim:demap_llr"]},
}


def read(t):
    if not t.has_span("frontend"):
        return None
    return t.span_s("frontend") / t.steps * 1e3
