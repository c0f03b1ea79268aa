"""Phase split and device busy share of one step of each multi-antenna
path, of the SISO 1x2 HARQ path, of the SISO flagship, of the full-width
uplink, of the full chain at the flagship load, of the full-PHY system
emulator at full width and of a capstone DL PHY TTI on a GPU.

    python3 -m openair4g_tpu_torch.sim.phase_split [--out DIR]
        [--only tm2|tm3|dd|flagship|ul|full|oaisim|capstone ...]

For each of the flagship (100 PRB, MCS 26, EVA, 1 RX, joint estimation,
round 0, 8 turbo iterations, batch 128, 24 dB), TM2 (50 PRB, MCS 25, EVA
2x2, batch 128, 14 dB), TM3 (100 PRB, MCS 26/26, 2x2, batch 64, 40 dB)
and the decision-directed 1x2 receiver over 4 HARQ rounds (100 PRB, MCS
26, EVA, CFI 2, batch 128, 14.6 dB in the dlsim SNR convention), and the
uplink (Ulsim 100 PRB, MCS 20, EVA, 4 HARQ rounds, batch 128, UCI of 30
CQI bits, RI and 2 ACK bits, 16 dB), and the full chain (FullChainSim
100 PRB, MCS 26, EVA, CFI 3, 4 HARQ rounds, batch 128, 22 dB, what
`fullsim_main -B 100 -m 26 -g EVA -b 128` runs), and the full-PHY
Oaisim (3 eNBs 500 m apart, 128 static UEs, 100 PRB, MCS 16, EPA, 4 HARQ
rounds, 6 turbo iterations, full buffer, round robin, TX power 60 dB; a
step is a frame of 10 TTIs, each reported a TTI), and the capstone at
100 PRB (FullStackSim's attach ladder at 12 dB, seed 0, then a step is one
DL PHY TTI of the dedicated 1A subframe: transmit, the UE's noise, the
blind receive with the SI-RNTI and the C-RNTI searches, the PDSCH
decode): the unwrapped step
time over 5 steps (10 for the flagship, 2 frames for Oaisim); then the
same steps with each
phase function wrapped in torch.cuda.synchronize()-bracketed host
timers (the names the sim modules imported are patched, so the sync
adds to the total and nested phases are reported inside their parent);
the Viterbi decoder (the kernel on a card: for the DCI, the search entry
with the candidates' de-rate-matching) is reported inside the DCI blind
decode and the CQI decode that call it, and the turbo decode kernel (one
launch a (K, F) group on a card) inside turbo_decode; then
torch.profiler over 3 unwrapped steps for the device time and busy
share. With the dd path, the time-domain FIR channel of one round at the
same shape against the per-subcarrier multiply, by CUDA events. With
--out, each profiler table is written to DIR/prof_<label>.txt.
"""
from __future__ import annotations

import argparse
import collections
import functools
import os
import subprocess
import time

import torch

from ..ops import turbo as turbo_mod
from ..ops import turbo_cuda
from ..ops import uci
from ..phy import ofdm, pdcch, pdsch
from ..ops.uci import UciConfig
from ..sched import enb_tx, ue_rx
from . import (capstone, channels, dlsim, dlsim_mimo, dlsim_sm, fullsim,
               oaisim, ulsim)

ACC: dict = collections.defaultdict(float)
CNT: collections.Counter = collections.Counter()


def timed(name, fn):
    """fn, bracketed by device syncs, its host time added to ACC[name]."""
    @functools.wraps(fn)
    def w(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn(*a, **k)
        torch.cuda.synchronize()
        ACC[name] += time.perf_counter() - t0
        CNT[name] += 1
        return r
    return w


def patch() -> list:
    """Wrap each phase function where the sims look it up; returns what
    unpatch needs to put the originals back."""
    saved = []

    def p(obj, attr, name):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, timed(name, getattr(obj, attr)))
    p(pdsch.DlschCodec, "encode", "encode (CRC, turbo encode, rate match)")
    p(pdsch.DlschCodec, "decode", "decode (de-rate-match, turbo, CRC)")
    p(turbo_mod, "turbo_decode", "  turbo_decode")
    p(turbo_cuda, "decode", "    decode (kernel; the whole decode)")
    p(turbo_mod, "half_iteration", "    half_iteration (kernel)")
    p(dlsim_mimo.SfbcPdcch, "tx", "PDCCH tx")
    p(dlsim_mimo.SfbcPdcch, "rx", "PDCCH rx (combine, demap, blind decode)")
    p(dlsim_mimo, "dci_blind_decode", "  dci_blind_decode")
    p(pdcch, "viterbi_search", "    viterbi_search (kernel; DCI)")
    p(ofdm, "ofdm_modulate", "OFDM modulate")
    p(ofdm, "ofdm_demodulate", "OFDM demodulate")
    for m in (dlsim_mimo, dlsim_sm):
        p(m, "fill_grid_port", "fill_grid_port")
        p(m, "estimate_ports", "channel estimation")
        p(m, "demap_llr_fused", "demap_llr (kernel; data and PDCCH)")
        p(m, "unscramble_llrs", "unscramble")
    p(dlsim_mimo, "apply_channel_grid", "channel on the grid")
    p(dlsim_mimo, "sfbc_combine", "sfbc_combine (data and PDCCH)")
    p(dlsim_sm, "mmse_detect", "mmse_detect")
    p(dlsim_sm, "effective_channel", "effective_channel")
    p(dlsim_sm, "precode", "precode")
    p(pdsch.DlschCodec, "encode_to_d", "encode to d (CRC, turbo encode)")
    p(pdsch.DlschCodec, "select_e", "rate match (select_e)")
    p(dlsim.DlsimFading, "round", "HARQ round (DlsimFading.round)")
    p(dlsim.DlsimFading, "_channel", "  channel, AWGN and OFDM")
    p(dlsim.DlsimFading, "_dd_estimate", "  dd estimate")
    p(dlsim, "estimate_channel_joint", "    estimate_channel_joint")
    p(dlsim, "dd_refine", "    dd_refine")
    p(dlsim, "mrc_llr", "  mrc_llr (kernel; data and PDCCH)")
    p(dlsim, "dci_blind_decode", "  dci_blind_decode")
    p(dlsim, "fill_grid", "  fill_grid")
    p(dlsim, "apply_channel_grid", "    channel on the grid")
    p(ulsim.Ulsim, "round_llrs", "HARQ round to the LLRs (Ulsim)")
    p(ulsim.Ulsim, "_tx_symbols", "  data and UCI symbols (uci_multiplex)")
    p(ulsim, "pusch_fill_grid_x", "  pusch_fill_grid_x (DFT spread)")
    p(ulsim.Ulsim, "_channel", "  channel, AWGN and OFDM")
    p(ulsim, "ul_estimate_channel", "  ul_estimate_channel")
    p(ulsim, "scfdma_mmse_equalize", "  scfdma_mmse_equalize")
    p(ulsim, "transform_deprecode", "  transform_deprecode (DFT)")
    p(ulsim, "demap_llr", "  demap_llr (plain)")
    p(ulsim.Ulsim, "_uci_errors", "UCI decode and count (round 0)")
    p(ulsim, "cqi_decode", "  cqi_decode (CC rate dematch, Viterbi)")
    p(uci, "viterbi_decode", "    viterbi_decode (kernel; CQI)")
    p(enb_tx.EnbTx, "data_subframe", "EnbTx.data_subframe")
    p(fullsim, "apply_channel_bins", "channel on the grid (fullsim)")
    p(fullsim.FullChainSim, "_ue_round", "UE round (FullChainSim)")
    p(ue_rx.UeRx, "channel", "  estimate_channel")
    p(ue_rx, "mrc_llr", "  mrc_llr (kernel; PDCCH and PDSCH)")
    p(fullsim, "dci_blind_decode", "  dci_blind_decode")
    p(ue_rx.UeRx, "phich", "  PHICH")
    p(oaisim.Oaisim, "_couple", "coupling of every eNB to every UE (oaisim)")
    p(oaisim, "estimate_channel", "estimate_channel (oaisim, an eNB's)")
    p(oaisim, "demap_llr", "demap_llr (plain; oaisim, an eNB's)")
    p(capstone.DlAir, "transmit", "DL transmit, UE noise, OFDM (capstone)")
    p(capstone.DlAir, "receive", "DL blind receive (capstone)")
    p(capstone, "dci_blind_decode", "  dci_blind_decode")
    return saved


def unpatch(saved: list) -> None:
    for obj, attr, f in reversed(saved):
        setattr(obj, attr, f)


def profile_steps(step, n: int = 3) -> tuple:
    """torch.profiler over n calls of `step` (an unwrapped step): (the
    events by key, the summed device time of all device-side events in µs,
    the host's seconds a profiled call)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events
                 if e.self_device_time_total > 0 and e.device_type ==
                 torch.autograd.DeviceType.CUDA)
    return events, dev_us, wall


def run(label: str, sim, snr: float, state: tuple, n_steps: int = 5,
        out: str | None = None) -> None:
    """`state`: the estimator arguments `step` takes after n0."""
    dev = sim.device
    gen = torch.Generator(device=dev).manual_seed(5)
    n0 = 10.0 ** (-snr / 10.0)
    for _ in range(2):
        sim.step(gen, n0, *state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        sim.step(gen, n0, *state)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) / n_steps
    ACC.clear()
    CNT.clear()
    saved = patch()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            sim.step(gen, n0, *state)
        torch.cuda.synchronize()
        synced = (time.perf_counter() - t0) / n_steps
    finally:
        unpatch(saved)
    rounds = getattr(sim.cfg, "n_harq_rounds", 1)
    per_round = (f", {sim.cfg.batch * rounds / plain:.1f} processed "
                 f"subframes/s over {rounds} HARQ rounds" if rounds > 1
                 else "")
    print(f"== {label}: unwrapped step {plain * 1e3:.1f} ms "
          f"({sim.cfg.batch / plain:.1f} subframes/s{per_round}), synced "
          f"step {synced * 1e3:.1f} ms")
    _print_split(n_steps, synced, "step")
    events, dev_us, wall = profile_steps(lambda: sim.step(gen, n0, *state))
    print(f"  profiler: {dev_us / 3 / 1e3:.1f} ms device time per step, "
          f"{wall * 1e3:.1f} ms profiled step; busy "
          f"{dev_us / 3 / 1e6 / plain * 100:.1f} % of the unwrapped step")
    _print_profile(label, events, 3, out)


def _print_split(n: int, synced: float, unit: str) -> None:
    """ACC's phases over n steps (or TTIs) of `synced` seconds each."""
    for k, v in sorted(ACC.items(), key=lambda kv: -kv[1]):
        print(f"  {k:45s} {v / n * 1e3:8.2f} ms  "
              f"{v / n / synced * 100:5.1f} %  ({CNT[k] / n:.0f}"
              f" calls/{unit})")


def _print_profile(label: str, events, n: int, out: str | None) -> None:
    """The 8 kernels with the most device time over n steps (or TTIs),
    and with `out` the profiler's table in out/prof_<label>.txt."""
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, f"prof_{label}.txt"), "w") as f:
            f.write(events.table(sort_by="self_device_time_total",
                                 row_limit=25))
    top = sorted((e for e in events if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        print(f"    {e.key[:60]:60s} "
              f"{e.self_device_time_total / n / 1e3:7.2f} ms"
              f"  x{e.count / n:.0f}")


# The full-width full-PHY system emulator (chip_smoke.py phase 36).
OAISIM_FULL = dict(n_enb=3, n_ue=128, n_rb=100, mcs=16, channel="EPA",
                   mode="phy", n_harq_rounds=4, n_turbo_iter=6,
                   mobility="static", traffic="full", mac="rr",
                   tx_power_db=60.0)


def run_oaisim(n_frames: int = 2, out: str | None = None) -> None:
    """run() for the full-PHY Oaisim: a step is run_frames(1), 10 TTIs,
    and each figure is given a TTI; the decode rows count one call an eNB
    a TTI."""
    sim = oaisim.Oaisim(oaisim.OaisimConfig(**OAISIM_FULL), device="cuda")
    sim.run_frames(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run_frames(n_frames)
    torch.cuda.synchronize()
    n_tti = 10 * n_frames
    plain = (time.perf_counter() - t0) / n_tti
    ACC.clear()
    CNT.clear()
    saved = patch()
    try:
        t0 = time.perf_counter()
        sim.run_frames(n_frames)
        torch.cuda.synchronize()
        synced = (time.perf_counter() - t0) / n_tti
    finally:
        unpatch(saved)
    print(f"== oaisim full PHY: unwrapped {plain * 1e3:.1f} ms a TTI, "
          f"synced {synced * 1e3:.1f} ms a TTI")
    _print_split(n_tti, synced, "TTI")
    events, dev_us, wall = profile_steps(lambda: sim.run_frames(1))
    print(f"  profiler: {dev_us / 30 / 1e3:.1f} ms device time a TTI, "
          f"{wall / 10 * 1e3:.1f} ms a profiled TTI; busy "
          f"{dev_us / 30 / 1e6 / plain * 100:.1f} % of the unwrapped TTI")
    _print_profile("oaisim", events, 30, out)


def run_capstone(n_tti: int = 10, out: str | None = None) -> None:
    """run() for one capstone DL PHY TTI at 100 PRB, after the attach
    ladder that gives the UE its C-RNTI."""
    sim = capstone.FullStackSim(capstone.CapstoneConfig(n_rb=100),
                                device="cuda")
    sim.run()
    dl, crnti, pdu = sim.dl, sim.ue.crnti, bytes(range(64))

    def tti():
        rgrid = dl.transmit(2, ("ded", crnti, pdu))
        return dl.receive(rgrid, 2, [capstone.SI_RNTI], crnti)

    if tti()["pdsch"] is None:
        raise SystemExit("phase_split: the capstone DL TTI lost its PDSCH")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_tti):
        tti()
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) / n_tti
    ACC.clear()
    CNT.clear()
    saved = patch()
    try:
        t0 = time.perf_counter()
        for _ in range(n_tti):
            tti()
        torch.cuda.synchronize()
        synced = (time.perf_counter() - t0) / n_tti
    finally:
        unpatch(saved)
    print(f"== capstone 100 PRB DL PHY TTI: unwrapped {plain * 1e3:.1f} ms, "
          f"synced {synced * 1e3:.1f} ms")
    _print_split(n_tti, synced, "TTI")
    events, dev_us, wall = profile_steps(tti)
    print(f"  profiler: {dev_us / 3 / 1e3:.2f} ms device time a TTI, "
          f"{wall * 1e3:.1f} ms a profiled TTI; busy "
          f"{dev_us / 3 / 1e6 / plain * 100:.1f} % of the unwrapped TTI")
    _print_profile("capstone", events, 3, out)


def _event_ms(fn, n: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def fir_cost(sim) -> None:
    """One round's channel at the sim's shape ([B * n_rx] subframes):
    the time-domain FIR path (OFDM modulate, then the linear convolution
    by FFTs of length S + L) against the per-subcarrier multiply (then
    OFDM modulate), device time by CUDA events."""
    cfg, fp, dev = sim.cfg, sim.fp, sim.device
    n = cfg.batch * cfg.n_rx
    gen = torch.Generator(device=dev).manual_seed(6)
    grid = torch.view_as_complex(torch.randn(
        n, fp.symbols_per_subframe, fp.n_fft, 2, generator=gen, device=dev))
    taps = sim.chan.draw_taps(cfg.batch, generator=gen,
                              device=dev)[:, :, 0].reshape(n, -1)
    L = channels._fir_sinc_matrix(sim.chan).shape[0]

    def time_domain():
        return channels.apply_channel_time(ofdm.ofdm_modulate(grid, fp),
                                           sim.chan, taps)

    def per_subcarrier():
        return ofdm.ofdm_modulate(channels.apply_channel_grid(
            grid, sim.chan.freq_response(taps), fp), fp)

    fir, freq = _event_ms(time_domain), _event_ms(per_subcarrier)
    print(f"== FIR: {n} subframes of S = {fp.samples_per_tti}, L = {L}, "
          f"FFT length {fp.samples_per_tti + L}: time-domain channel "
          f"{fir:.3f} ms, per-subcarrier multiply {freq:.3f} ms "
          f"(OFDM modulation in both)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for the profiler tables")
    ap.add_argument("--only", action="append",
                    choices=("tm2", "tm3", "dd", "flagship", "ul", "full",
                             "oaisim", "capstone"),
                    help="run this path (repeat for more; default: all)")
    args = ap.parse_args()
    only = set(args.only or ("tm2", "tm3", "dd", "flagship", "ul", "full",
                             "oaisim", "capstone"))
    if not torch.cuda.is_available():
        raise SystemExit("phase_split: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if "flagship" in only:
        sim = dlsim.DlsimFading(dlsim.DlsimFadingConfig(
            mcs=26, n_rb=100, channel="EVA", n_rx=1, n_harq_rounds=1,
            batch=128, est_mode="joint", n_turbo_iter=8), "cuda")
        run("flagship", sim, 24.0, (sim.wiener(24.0), sim.err_var(24.0)),
            n_steps=10, out=args.out)
    if "tm2" in only:
        sim = dlsim_mimo.DlsimTxDiv(dlsim_mimo.DlsimTxDivConfig(
            mcs=25, n_rb=50, n_rx=2, channel="EVA", batch=128), "cuda")
        run("TM2", sim, 14.0, sim.wiener(14.0), out=args.out)
    if "tm3" in only:
        sim = dlsim_sm.DlsimSm(dlsim_sm.DlsimSmConfig(
            tm=3, mcs=26, mcs2=26, n_rb=100, n_rx=2, batch=64), "cuda")
        run("TM3", sim, 40.0, sim.wiener(40.0), out=args.out)
    if "dd" in only:
        sim = dlsim.DlsimFading(dlsim.DlsimFadingConfig(
            mcs=26, n_rb=100, channel="EVA", n_rx=2, est_mode="dd",
            n_pdcch_symbols=2, n_harq_rounds=4, snr_convention="dlsim",
            batch=128), "cuda")
        snr = 14.6 + dlsim.dlsim_snr_offset_db(sim.gm)
        run("dd_1x2_harq", sim, snr, (sim.wiener(snr), sim.err_var(snr)),
            out=args.out)
        fir_cost(sim)
    if "ul" in only:
        sim = ulsim.Ulsim(ulsim.UlsimConfig(
            mcs=20, n_rb=100, n_rb_alloc=100, channel="EVA",
            n_harq_rounds=4, batch=128,
            uci=UciConfig(o_cqi=30, o_ri=1, o_ack=2)), "cuda")
        run("uplink", sim, 16.0, (sim.wiener(16.0),), out=args.out)
    if "full" in only:
        sim = fullsim.FullChainSim(fullsim.FullsimConfig(
            n_rb=100, mcs=26, channel="EVA", n_harq_rounds=4, batch=128),
            "cuda")
        run("fullsim", sim, 22.0, (sim.ue.make_wiener(10.0 ** -2.2),),
            out=args.out)
    if "oaisim" in only:
        run_oaisim(out=args.out)
    if "capstone" in only:
        run_capstone(out=args.out)


if __name__ == "__main__":
    main()
