"""Phase split and device busy share of one TM2 and one TM3 step on a GPU.

    python3 -m openair4g_tpu_torch.sim.phase_split [--out DIR]

For each of TM2 (50 PRB, MCS 25, EVA 2x2, batch 128, 14 dB) and TM3
(100 PRB, MCS 26/26, 2x2, batch 64, 40 dB): the unwrapped step time over 5
steps; then the same 5 steps with each phase function wrapped in
torch.cuda.synchronize()-bracketed host timers (the names the sim modules
imported are patched, so the sync adds to the total and nested phases are
reported inside their parent); then torch.profiler over 3 unwrapped steps
for the device time and busy share. With --out, each profiler table is
written to DIR/prof_<label>.txt.
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
from ..phy import ofdm, pdsch
from . import dlsim_mimo, dlsim_sm

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
    p(turbo_mod, "half_iteration", "    half_iteration (kernel)")
    p(dlsim_mimo.SfbcPdcch, "tx", "PDCCH tx")
    p(dlsim_mimo.SfbcPdcch, "rx", "PDCCH rx (combine, demap, blind decode)")
    p(dlsim_mimo, "dci_blind_decode", "  dci_blind_decode")
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
    return saved


def unpatch(saved: list) -> None:
    for obj, attr, f in reversed(saved):
        setattr(obj, attr, f)


def run(label: str, sim, snr: float, n_steps: int = 5,
        out: str | None = None) -> None:
    dev = sim.device
    gen = torch.Generator(device=dev).manual_seed(5)
    n0 = 10.0 ** (-snr / 10.0)
    W0, W1 = sim.wiener(snr)
    for _ in range(2):
        sim.step(gen, n0, W0, W1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        sim.step(gen, n0, W0, W1)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) / n_steps
    ACC.clear()
    CNT.clear()
    saved = patch()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            sim.step(gen, n0, W0, W1)
        torch.cuda.synchronize()
        synced = (time.perf_counter() - t0) / n_steps
    finally:
        unpatch(saved)
    print(f"== {label}: unwrapped step {plain * 1e3:.1f} ms "
          f"({sim.cfg.batch / plain:.1f} subframes/s), synced step "
          f"{synced * 1e3:.1f} ms")
    for k, v in sorted(ACC.items(), key=lambda kv: -kv[1]):
        print(f"  {k:45s} {v / n_steps * 1e3:8.2f} ms  "
              f"{v / n_steps / synced * 100:5.1f} %  ({CNT[k] / n_steps:.0f}"
              f" calls/step)")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            sim.step(gen, n0, W0, W1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 3
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events
                 if e.self_device_time_total > 0 and e.device_type ==
                 torch.autograd.DeviceType.CUDA)
    print(f"  profiler: {dev_us / 3 / 1e3:.1f} ms device time per step, "
          f"{wall * 1e3:.1f} ms profiled step; busy "
          f"{dev_us / 3 / 1e6 / plain * 100:.1f} % of the unwrapped step")
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, f"prof_{label}.txt"), "w") as f:
            f.write(events.table(sort_by="self_device_time_total",
                                 row_limit=25))
    top = sorted((e for e in events if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        print(f"    {e.key[:60]:60s} "
              f"{e.self_device_time_total / 3 / 1e3:7.2f} ms"
              f"  x{e.count / 3:.0f}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for the profiler tables")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("phase_split: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    run("TM2", dlsim_mimo.DlsimTxDiv(dlsim_mimo.DlsimTxDivConfig(
        mcs=25, n_rb=50, n_rx=2, channel="EVA", batch=128), "cuda"), 14.0,
        out=args.out)
    run("TM3", dlsim_sm.DlsimSm(dlsim_sm.DlsimSmConfig(
        tm=3, mcs=26, mcs2=26, n_rb=100, n_rx=2, batch=64), "cuda"), 40.0,
        out=args.out)


if __name__ == "__main__":
    main()
