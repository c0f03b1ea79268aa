"""The DCI blind decode's time and the Viterbi kernel's device time at the
shapes the paths give them, on a GPU:

    python3 -m openair4g_tpu_torch.scripts.dci_times [--out FILE]

Shapes: the blind searches of the flagship (DlsimFading 100 PRB, batch
128: common and UE spaces, format 1A), of the full chain at the flagship
load (FullChainSim 100 PRB CFI 3, batch 128: its 1A search, run four
times a step), of UlGrantSim (100 PRB, batch 128: every (L, CCE offset),
format 0) and of the capstone's 100 PRB DL PHY TTI (batch 1: the common
space at format 1C, the UE space at 1A); and `viterbi_decode` at [R, 3,
43] for R = 1, 2,304, 2,816 and 21,120 (one row; the flagship's 18
candidates x 128; the full chain's 22 x 128; UlGrantSim's 165 x 128).
Control-region LLRs are Gaussian from a seed. For each: the call's host
time between synchronizes (median of 20), and by torch.profiler over 20
calls each device kernel's time a call and their sum. Prints a line a
shape and the card's name and power limit; --out writes them as JSON.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from ..device import card_name
from ..ops.convcode import viterbi_decode
from ..phy.pdcch import (common_search_candidates, dci_blind_decode,
                         ue_search_candidates)
from ..sim.capstone import SI_RNTI, CapstoneConfig, DlAir
from ..sim.dlsim import DlsimFading, DlsimFadingConfig
from ..sim.fullsim import FullChainSim, FullsimConfig
from ..sim.ulgrantsim import UlGrantConfig, UlGrantSim

N_CALLS = 20
BATCH = 128
# The capstone's C-RNTI in the DL TTI timed (its UE search space).
CAPSTONE_CRNTI = 0x1234


def searches(dev) -> list:
    """[(label, B, n_cce, payload_len, rnti, candidates)] of each path's
    search."""
    flag = DlsimFading(DlsimFadingConfig(
        mcs=26, n_rb=100, channel="EVA", n_rx=1, n_harq_rounds=1,
        batch=BATCH, est_mode="joint", n_turbo_iter=8), device=dev)
    full = FullChainSim(FullsimConfig(n_rb=100, mcs=26, channel="EVA",
                                      n_harq_rounds=4, n_turbo_iter=8,
                                      batch=BATCH), device=dev)
    grant = UlGrantSim(UlGrantConfig(n_rb=100, rb_offset=2, n_prb=96,
                                     mcs_ul=20, n_harq_rounds=4,
                                     batch=BATCH), device=dev)
    dl = DlAir(CapstoneConfig(n_rb=100), np.random.default_rng(0), dev)
    n_cce = dl.enb_tx(2, dl.cfg.common).crm.n_cce
    return [
        ("flagship", BATCH, flag.crm.n_cce, len(flag.dci_payload),
         flag.cfg.rnti, flag.dci_cands),
        ("full chain", BATCH, full.ue.crm.n_cce, full.ue.dci_len,
         full.ue.cfg.rnti, full.ue.candidates),
        ("UlGrantSim", BATCH, grant.crm.n_cce, grant.dci_len, grant.cfg.rnti,
         grant.candidates),
        ("capstone common 1C", 1, n_cce, dl.size_1c, SI_RNTI,
         common_search_candidates(n_cce)),
        ("capstone UE 1A", 1, n_cce, dl.size_1a, CAPSTONE_CRNTI,
         ue_search_candidates(n_cce, CAPSTONE_CRNTI, 2)),
    ]


def timed(fn) -> dict:
    """fn's host ms between synchronizes (median of N_CALLS) and, by
    torch.profiler over N_CALLS calls, {device kernel: ms a call} and their
    sum."""
    fn()
    host = []
    for _ in range(N_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(N_CALLS):
            fn()
        torch.cuda.synchronize()
    kernels = {e.key: e.self_device_time_total / 1e3 / N_CALLS
               for e in prof.key_averages()
               if e.self_device_time_total > 0
               and e.device_type == torch.autograd.DeviceType.CUDA}
    return {"host_ms": statistics.median(host), "host_ms_all": host,
            "device_ms": sum(kernels.values()), "kernels": kernels}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="dci_times")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dci_times: no CUDA device")
    dev = torch.device("cuda")
    card = card_name(dev)
    print(card, flush=True)
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for label, B, n_cce, A, rnti, cands in searches(dev):
        llr = 3.0 * torch.randn(B, n_cce * 72, generator=gen, device=dev)
        res = timed(lambda: dci_blind_decode(llr, A, rnti, cands))
        vit = sum(ms for k, ms in res["kernels"].items() if "viterbi" in k)
        rows.append(dict(what="dci_blind_decode", label=label, B=B,
                         n_cand=len(cands), K=A + 16, viterbi_device_ms=vit,
                         **res))
        print(f"dci_blind_decode {label}: B {B}, {len(cands)} candidates, "
              f"K {A + 16}: synced {res['host_ms']:.4f} ms, device "
              f"{res['device_ms']:.4f} ms a call, the Viterbi's "
              f"{vit:.4f} ms; {len(res['kernels'])} kernels", flush=True)
    for R in (1, 2304, 2816, 21120):
        x = 3.0 * torch.randn(R, 3, 43, generator=gen, device=dev)
        res = timed(lambda: viterbi_decode(x, 43))
        rows.append(dict(what="viterbi_decode", R=R, K=43, **res))
        print(f"viterbi_decode {R} x 3 x 43: synced {res['host_ms']:.4f} "
              f"ms, device {res['device_ms']:.4f} ms a call", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
