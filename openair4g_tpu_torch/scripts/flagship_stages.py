"""Cumulative stage times of the 20 MHz flagship's round 0 (counterpart
of scripts/flagship_stages.py).

For each stage k (encode, map, fill, ofdm_tx, ofdm_rx, ce, llr, decode),
a step runs the chain from fresh draws up to stage k and reduces its last
tensor to a number on the device; successive differences are the stages'
costs. The chain is the flagship's (100 PRB, MCS 26, EVA, 1 RX, joint
CE, mrc_llr, 8 iterations, batch 64, 24 dB) without the PDCCH. Each
stage: the best of 3 windows of 8 steps on the host clock between device
syncs, after one warm-up step.

    python3 -m openair4g_tpu_torch.scripts.flagship_stages
        [--device cuda] [--out-dir DIR]

Writes DIR/flagship_stages.json (resume: an existing file is not run
again).
"""
from __future__ import annotations

import numpy as np
import torch

from ..bench import time_windows
from ..ops.equalize_llr import mrc_llr
from ..ops.llr import map_symbols
from ..phy import ofdm
from ..phy.channel_est import estimate_channel_joint
from ..phy.resource_grid import extract_data_res, fill_grid
from ..sim.channels import apply_channel_grid
from ..sim.dlsim import DlsimFading, DlsimFadingConfig
from . import common

BATCH = 64
SNR = 24.0
N_REP, WINDOWS = 8, 3
STAGES = ["encode", "map", "fill", "ofdm_tx", "ofdm_rx", "ce", "llr",
          "decode"]


def upto(sim: DlsimFading, stage: str, W, ev):
    """One step of the chain to `stage`, from a generator's draws."""
    codec, gm, fp, dev = sim.dlsch, sim.gm, sim.fp, sim.device
    Qm, B = codec.cfg.Qm, BATCH
    n0 = float(np.float32(10.0 ** (-SNR / 10.0)))
    ds = torch.as_tensor(np.asarray(gm.data_sym), device=dev)
    dc = torch.as_tensor(np.asarray(gm.data_sc), device=dev)

    def f(gen):
        tb = torch.randint(0, 2, (B, codec.cfg.tbs), generator=gen,
                           device=dev, dtype=torch.int32)
        d_flats = codec.encode_to_d(tb)
        if stage == "encode":
            return sum(d.sum() for d in d_flats)
        e = torch.bitwise_xor(codec.select_e(d_flats, 0), sim._scr)
        sym = map_symbols(e, Qm)
        if stage == "map":
            return sym.abs().sum()
        grid = fill_grid(sym, gm)
        if stage == "fill":
            return grid.abs().sum()
        taps = sim.chan.draw_taps(B, generator=gen, device=dev)
        t = ofdm.ofdm_modulate(
            apply_channel_grid(grid, sim.chan.freq_response(taps), fp), fp)
        if stage == "ofdm_tx":
            return t.abs().sum()
        nr = torch.randn(B, t.shape[1], 2, generator=gen, device=dev)
        sigma = float(np.sqrt(np.float32(n0) / np.float32(2.0)))
        rgrid = ofdm.ofdm_demodulate(
            t + sigma * torch.complex(nr[..., 0], nr[..., 1]), fp)
        if stage == "ofdm_rx":
            return rgrid.abs().sum()
        H = estimate_channel_joint(rgrid, gm, W)
        if stage == "ce":
            return H.abs().sum()
        y = extract_data_res(rgrid, gm)
        llr = mrc_llr(y[..., None], H[:, ds, dc][..., None], n0 + ev,
                      Qm).reshape(B, -1)
        if stage == "llr":
            return llr.abs().sum()
        _, ok, _ = codec.decode(llr * sim._scr_sgn)
        return ok.sum()

    return f


def run(dev) -> dict:
    sim = DlsimFading(DlsimFadingConfig(
        mcs=26, n_rb=100, channel="EVA", n_rx=1, n_harq_rounds=1,
        batch=BATCH, est_mode="joint", n_turbo_iter=8, with_pdcch=False),
        device=dev)
    W, ev = sim.wiener(SNR), sim.err_var(SNR)
    rows, prev = [], 0.0
    for stage in STAGES:
        f = upto(sim, stage, W, ev)
        gen = torch.Generator(device=dev).manual_seed(0)
        secs, _ = time_windows(lambda: f(gen), dev, N_REP, WINDOWS)
        ms = min(secs) / N_REP * 1e3
        rows.append({"stage": stage, "ms": ms, "delta_ms": ms - prev})
        print(f"upto {stage:10s}: {ms:7.2f} ms  (delta {ms - prev:+6.2f})",
              flush=True)
        prev = ms
    return {"batch": BATCH, "snr_db": SNR, "stages": rows}


def main(argv=None) -> dict:
    p = common.parser("flagship_stages", __doc__)
    a = p.parse_args(argv)
    dev, out, card = common.setup("flagship_stages", a)
    return common.run_each(["flagship_stages"], out, lambda _: run(dev),
                           card)["flagship_stages"]


if __name__ == "__main__":
    main()
