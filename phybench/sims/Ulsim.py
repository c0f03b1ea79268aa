"""Ulsim, the PUSCH simulator with HARQ and UCI: a step is
one `trial(tb_bits, uci_bits, tap_normals, noise_normals, n0, W)` of
[batch] TB trials through every HARQ round, its counts read on the host.

`Ulsim.trial` returns no soft values, so on the steps kept the program's
`DlschCodec.decode` calls are recorded (its inputs and outputs, kept by
reference; nothing is computed or synchronised). The comparison: the
reference computes each round's data LLRs from the same draws with its own
estimator matrix (the channel, OFDM, the DMRS estimate, SC-FDMA MMSE, the
despread, the demap and the UCI demultiplex), against the LLRs the
program's decode received, and rate-de-matches the program's LLRs into
the program's HARQ buffers, against the buffers its decode returned (the
HARQ state each round hands on): `soft_gap`, the wider of the two. Then it
decodes those buffers with its plain turbo decoder and CRCs, and counts
the rows whose decode flag or decoded bits differ from the program's, and the difference of each step's round-0 UCI
error counts (CQI, RI, ACK) from its own: `decode_mismatch`, exact.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import judge
from ..reference.config import FrameParms
from ..reference.sim.channels import _RICEAN, PROFILES
from ..reference.tables.tbs import get_TBS_UL

# Rows a call of the reference takes.
CHUNK = 256
UCI_KEYS = ("cqi", "ri", "ack")


def plan(params: dict, traffic: dict) -> list:
    """One step's draws: the TB bits, the UCI bits, then per round the
    channel normals in ChannelModel.draw_normals' shape and the noise
    normals."""
    B, R = traffic["batch"], params["n_harq_rounds"]
    tbs = get_TBS_UL(params["mcs"], params["n_rb_alloc"])
    S = FrameParms(n_rb=params["n_rb"]).samples_per_tti
    ch = params.get("channel", "AWGN")
    if _RICEAN.get(ch, (0, 0, 0))[2]:
        raise ValueError("Ulsim: no random-AoA channel here")
    T = len(PROFILES[ch][0])
    u = params.get("uci", {})
    out = [("tb", "bits", (B, tbs))]
    out += [(f"uci/{k}", "bits", (B, u[f"o_{k}"])) for k in UCI_KEYS
            if u.get(f"o_{k}", 0)]
    for r in range(R):
        if ch != "AWGN":
            out.append((f"taps/{r}", "normal", (B, 1, 1, T, 2)))
        out.append((f"noise/{r}", "normal", (B, S, 2)))
    return out


class Program:
    """Ulsim of the port (impl "port") or of the reference (impl
    "reference"), at the configuration and the traffic's batch and SNR,
    with its estimator matrix worked out from its own plans; its codec's
    decode calls recorded on the steps kept."""

    def __init__(self, params: dict, traffic: dict, device, impl: str):
        if impl == "port":
            from openair4g_tpu_torch.ops.uci import UciConfig
            from openair4g_tpu_torch.sim import ulsim
        else:
            from ..reference.ops.uci import UciConfig
            from ..reference.sim import ulsim
        p = dict(params, uci=UciConfig(**params.get("uci", {})))
        self.R = params["n_harq_rounds"]
        self.sim = ulsim.Ulsim(ulsim.UlsimConfig(
            **p, batch=traffic["batch"]), device=device)
        snr = float(traffic["snr_db"])
        self.n0 = np.float32(10.0 ** (-snr / 10.0))
        self.W = self.sim.wiener(snr)
        self.calls: list = []
        self._on = False
        codec = self.sim.codec

        def recorded(e_llr, w_soft=None, rv=None, **kw):
            # looked up on the class at each call, so that the traced
            # run's spans and hooks there still see it
            out = type(codec).decode(codec, e_llr, w_soft=w_soft, rv=rv,
                                     **kw)
            if self._on:
                self.calls.append((e_llr, w_soft, rv) + tuple(out))
            return out

        codec.decode = recorded

    def trial(self, x: dict, keep: bool = False):
        self._on = keep
        self.calls = []
        try:
            return self.sim.trial(
                x["tb"], x.get("uci", {}),
                [x["taps"][r] if "taps" in x else None
                 for r in range(self.R)],
                [x["noise"][r] for r in range(self.R)], self.n0, self.W)
        finally:
            self._on = False

    @staticmethod
    def counts(out) -> torch.Tensor:
        """[2 R + 3]: the trials that reached each round and failed it,
        those that reached it, and the round-0 UCI errors."""
        return torch.cat([out.errs, out.reach, out.uci_errs])

    def record(self, x: dict, out) -> dict:
        if len(self.calls) != self.R:
            raise RuntimeError(f"Ulsim: {len(self.calls)} decode calls "
                               f"recorded in a trial of {self.R} rounds")
        return {"x": x, "ok": out.ok, "uci_errs": out.uci_errs,
                "calls": self.calls}


def compare(records: list, params: dict, traffic: dict, device,
            ref: Program | None = None) -> dict:
    """The numbers compared, over every row and round of the records;
    `ref`, the reference's Program, is built here unless given."""
    ref = ref or Program(params, traffic, device, "reference")
    sim, codec, R = ref.sim, ref.sim.codec, ref.R
    tb_all = judge.cat_rows(records, lambda q: q["x"]["tb"])
    step_of = torch.cat([torch.full((q["x"]["tb"].shape[0],), i,
                                    dtype=torch.long, device=tb_all.device)
                         for i, q in enumerate(records)])
    uci_ref = torch.zeros(len(records), 3, dtype=torch.int64,
                          device=tb_all.device)
    gaps, mismatch = [], 0
    for s, e in judge.chunks(tb_all.shape[0], CHUNK):
        def rows(get):
            return judge.cat_rows(records, get)[s:e]
        tb = tb_all[s:e]
        uci = {k: rows(lambda q: q["x"]["uci"][k])
               for k in records[0]["x"].get("uci", {})}
        d = codec.encode_to_d(tb)
        for r in range(R):
            taps = rows(lambda q: q["x"]["taps"][r]) \
                if "taps" in records[0]["x"] else None
            noise = rows(lambda q: q["x"]["noise"][r])
            llr_ref, streams = sim.round_llrs(r, d, uci, taps, noise,
                                              ref.n0, ref.W)
            llr_port = rows(lambda q: q["calls"][r][0])
            gaps.append(judge.row_gap([llr_port], [llr_ref]))
            if r == 0 and uci:
                uci_ref.index_add_(0, step_of[s:e],
                                   sim.uci_row_errors(streams, uci).T)
            w_prev = None if r == 0 else \
                [b[s:e] for b in judge.cat_blocks(
                    records, lambda q: q["calls"][r][1])]
            w_ref = codec.soft_buffers(llr_port, w_prev, rv=r & 3)
            w_port = [b[s:e] for b in judge.cat_blocks(
                records, lambda q: q["calls"][r][5])]
            gaps.append(judge.row_gap(w_port, w_ref))
            tb_hat, ok = codec.decode_buffers(w_ref, rv=r & 3)
            bad = (rows(lambda q: q["ok"][r]) != ok) \
                | (rows(lambda q: q["calls"][r][4]) != ok) \
                | torch.any(rows(lambda q: q["calls"][r][3]) != tb_hat,
                            dim=1)
            mismatch += int(bad.sum())
    uci_port = torch.stack([q["uci_errs"] for q in records])
    mismatch += int((uci_port - uci_ref).abs().sum())
    gap = torch.cat(gaps)
    return {"soft_gap": float(gap.max()), "decode_mismatch": mismatch,
            "rows": int(tb_all.shape[0]) * R,
            "soft_gap_median": float(gap.median())}
