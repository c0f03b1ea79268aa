"""DlsimFading, the fading-channel downlink simulator: a
step is one `trial(tb_bits, tap_normals, noise_normals, n0, W, ev)` of
[batch] TB trials through every HARQ round, its counts read on the host.

The comparison, on the steps kept: the reference computes each row's
soft buffers from the same draws with its own estimator matrices (the
channel, OFDM, the estimate, MRC and the LLRs, the DCI blind decode, whose
miss zeroes a round's LLRs, and the rate de-matching with the HARQ
combining), against the program's `RoundResult.w_soft`: `soft_gap`. Then
it decodes the program's own soft buffers with its plain turbo decoder and
CRCs, and counts the rows whose decode flag, DCI flag or bit errors differ
from the program's: `decode_mismatch`, exact.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import judge
from ..reference.config import FrameParms
from ..reference.sim.channels import _RICEAN, PROFILES
from ..reference.tables.tbs import get_TBS_DL

# Rows a call of the reference takes.
CHUNK = 256


def plan(params: dict, traffic: dict) -> list:
    """One step's draws: the TB bits, then per round the channel normals
    in ChannelModel.draw_normals' shape and the noise normals."""
    B, R = traffic["batch"], params["n_harq_rounds"]
    A = params.get("n_rx", 1)
    tbs = get_TBS_DL(params["mcs"], params["n_rb"])
    S = FrameParms(n_rb=params["n_rb"]).samples_per_tti
    ch = params.get("channel", "EVA")
    T = len(PROFILES[ch][0])
    if params.get("intra_doppler_hz", 0) or _RICEAN.get(ch, (0, 0, 0))[2]:
        raise ValueError("DlsimFading: no intra-subframe Doppler, no "
                         "random-AoA channel")
    out = [("tb", "bits", (B, tbs))]
    for r in range(R):
        if ch != "AWGN":
            out.append((f"taps/{r}", "normal", (B, A, 1, T, 2)))
        out.append((f"noise/{r}", "normal", (B, A, S, 2)))
    return out


class Program:
    """DlsimFading of the port (impl "port") or of the reference (impl
    "reference": the control, or the judge's own chain), at the
    configuration and the traffic's batch and SNR, with its estimator
    matrices worked out from its own plans."""

    def __init__(self, params: dict, traffic: dict, device, impl: str):
        if impl == "port":
            from openair4g_tpu_torch.sim import dlsim
            from openair4g_tpu_torch.utils import profiler
            profiler.enable(False)   # the stage timers wait for the device
        else:
            from ..reference.sim import dlsim
        self.R = params["n_harq_rounds"]
        self.sim = dlsim.DlsimFading(dlsim.DlsimFadingConfig(
            **params, batch=traffic["batch"]), device=device)
        snr = float(traffic["snr_db"])
        if params.get("snr_convention") == "dlsim":
            snr += dlsim.dlsim_snr_offset_db(self.sim.gm)
        self.n0 = np.float32(10.0 ** (-snr / 10.0))
        self.W, self.ev = self.sim.wiener(snr), self.sim.err_var(snr)

    def trial(self, x: dict, keep: bool = False):
        return self.sim.trial(
            x["tb"], [x["taps"][r] if "taps" in x else None
                      for r in range(self.R)],
            [x["noise"][r] for r in range(self.R)], self.n0, self.W, self.ev)

    @staticmethod
    def counts(out) -> torch.Tensor:
        """[2 R]: the trials that reached each round and failed it, then
        those that reached it."""
        return torch.cat([out.errs, out.reach])

    @staticmethod
    def record(x: dict, out) -> dict:
        return {"x": x,
                "ok": [r.ok for r in out.rounds],
                "dci_ok": [r.dci_ok for r in out.rounds],
                "bit_errs": [r.bit_errs for r in out.rounds],
                "w": [r.w_soft for r in out.rounds]}


def compare(records: list, params: dict, traffic: dict, device,
            ref: Program | None = None) -> dict:
    """The numbers compared, over every row of the records; `ref`, the
    reference's Program, is built here unless given."""
    ref = ref or Program(params, traffic, device, "reference")
    sim, codec, R = ref.sim, ref.sim.dlsch, ref.R
    tb_all = judge.cat_rows(records, lambda r: r["x"]["tb"])
    gaps, mismatch = [], 0
    for s, e in judge.chunks(tb_all.shape[0], CHUNK):
        def rows(get):
            return judge.cat_rows(records, get)[s:e]
        tb = tb_all[s:e]
        d = codec.encode_to_d(tb)
        w_prev = taps_prev = None
        for r in range(R):
            taps = rows(lambda q: q["x"]["taps"][r]) \
                if "taps" in records[0]["x"] else None
            noise = rows(lambda q: q["x"]["noise"][r])
            llr, dci_ok, taps_prev = sim.round_llrs(
                r, d, taps, noise, ref.n0, ref.W, ref.ev, taps_prev)
            w_ref = codec.soft_buffers(llr, w_prev, rv=r & 3)
            w_port = [b[s:e] for b in
                      judge.cat_blocks(records, lambda q: q["w"][r])]
            gaps.append(judge.row_gap(w_port, w_ref))
            tb_hat, ok_dec = codec.decode_buffers(w_port, rv=r & 3)
            bad = (rows(lambda q: q["ok"][r]) != (ok_dec & dci_ok)) \
                | (rows(lambda q: q["dci_ok"][r]) != dci_ok) \
                | (rows(lambda q: q["bit_errs"][r])
                   != (tb_hat != tb).sum(dim=1))
            mismatch += int(bad.sum())
            w_prev = w_ref
    gap = torch.cat(gaps)
    return {"soft_gap": float(gap.max()), "decode_mismatch": mismatch,
            "rows": int(tb_all.shape[0]) * R,
            "soft_gap_median": float(gap.median())}
