#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (openair4g_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. the card's name and power limit, torch and CUDA versions;
  2. build the hand-written kernels from openair4g_tpu_torch/csrc/ for
     sm_90a into build/kernels/ (one nvcc call), with ptxas's register
     report;
  3. the v2 turbo kernel and mrc_llr against their plain PyTorch versions
     on the card at the 20 MHz flagship shapes (max |diff| against the
     stated tolerance, time of each by CUDA events);
  4. the small-input check: 25 PRB round 0 on the card (kernels) and on
     the CPU (plain versions) with the same injected draws must agree;
  5. the flagship: DlsimFading round 0, 100 PRB MCS 26, EVA, joint
     estimation, batch 128, 8 turbo iterations, drawn on the card. At
     26 dB every TB and every DCI must decode; at 24 dB TBs must decode
     and BLER and subframes/s are printed. Both its kernels' launch counts
     over these runs must be non-zero;
  6. demap_llr against its plain version on the card at the multi-antenna
     paths' shapes, one layer of an MMSE output read in place;
  7. the v1 turbo kernel against its plain version and the v2 kernel at
     the flagship shapes; no path runs v1, so its launch count is that of
     its timed run;
  8. small inputs of the multi-antenna simulators (TM2, TM3, TM4, TM5 IA,
     TM6; 25 PRB, batch 4, 30 dB), card against CPU on the same injected
     draws: TB flags, DCI flags and bit errors must be equal;
  9. TM2 at the fidelity corpus configuration (50 PRB, MCS 25, EVA, 2x2,
     estimated channel, batch 128), 2048 trials at 14 and 15 dB, held to
     the corpus anchor fidelity_campaign.json "txdiv64";
 10. TM3 at full width (100 PRB, MCS 26/26, 2x2, batch 64): at 40 dB every
     DCI decodes and each codeword's BLER over 10 steps is at most 0.2.
Each path is driven with the launch counts set to 0 just before it and
read just after; every kernel must have launched on its path (v1, which
no path runs, in its own timed run). Ends with a
JSON line of the kernels, then the device JSON line. It needs a CUDA
device and imports nothing of JAX.
"""
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from openair4g_tpu_torch import kernels
from openair4g_tpu_torch.device import launch_counts, reset_launch_counts
from openair4g_tpu_torch.ops.equalize_llr import (demap_llr_fused,
                                                  demap_llr_fused_ref,
                                                  mrc_llr, mrc_llr_ref)
from openair4g_tpu_torch.ops.turbo_cuda import (half_iteration,
                                                half_iteration_prepped,
                                                half_iteration_prepped_ref,
                                                half_iteration_ref,
                                                prep_parity)
from openair4g_tpu_torch.phy.control_region import make_control_region_map
from openair4g_tpu_torch.sim.dlsim import DlsimFading, DlsimFadingConfig
from openair4g_tpu_torch.sim.dlsim_mimo import DlsimTxDiv, DlsimTxDivConfig
from openair4g_tpu_torch.sim.dlsim_sm import DlsimSm, DlsimSmConfig

# Flagship shapes: 128 subframes x 11 code blocks of K = 5632 decode as
# 1,408 rows of N = 5760 (24 windows of W = 240); 15,000 data REs and
# 756 PDCCH REs per subframe.
BATCH = 128
TURBO_ROWS, TURBO_W, TURBO_U, TURBO_NW = BATCH * 11, 240, 24, 24
N_DATA, N_PDCCH_RE = 15000, 756
# The turbo kernel and its plain version run the same float32 operations
# in the same order; the bound allows for nothing but that.
TURBO_ATOL = 1e-4
# mrc_llr: the kernel forms -(num - l h2)^2 / (h2 n0), the plain version
# (num/h2 - l)^2 / (n0/h2): same value, other rounding (as the reference's
# tests/test_equalize_llr.py tolerates).
MRC_RTOL = MRC_ATOL = 3e-4


def _time_ms(fn, n: int) -> float:
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


def check_turbo(dev, gen) -> dict:
    N = TURBO_W * TURBO_NW
    lin = 3.0 * torch.randn(TURBO_ROWS, N, generator=gen, device=dev)
    lp = 3.0 * torch.randn(TURBO_ROWS, N, generator=gen, device=dev)
    lin[:, -TURBO_W // 2:] = 1e4       # the forced pad region after the tail
    lp[:, -TURBO_W // 2:] = 1e4
    got = half_iteration(lin, lp, TURBO_W, TURBO_U)
    want = half_iteration_ref(lin, lp, TURBO_W, TURBO_U)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    print(f"turbo_half_iter [{TURBO_ROWS}, {N}] W={TURBO_W} U={TURBO_U} "
          f"lanes={TURBO_ROWS * TURBO_NW}: max|diff| {err:.3g} "
          f"(tol {TURBO_ATOL})", flush=True)
    if not err <= TURBO_ATOL:
        raise AssertionError(f"turbo kernel disagrees: {err}")
    ms = _time_ms(lambda: half_iteration(lin, lp, TURBO_W, TURBO_U), 20)
    plain = _time_ms(lambda: half_iteration_ref(lin, lp, TURBO_W, TURBO_U), 3)
    print(f"  kernel {ms:.4f} ms, plain {plain:.4f} ms", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain}


def check_mrc(dev, gen) -> dict:
    cases = [("PDSCH", 1, 6, (BATCH, N_DATA), "per-RE"),
             ("PDCCH", 1, 2, (BATCH, N_PDCCH_RE), "scalar"),
             ("2RX", 2, 4, (BATCH, N_DATA), "per-RE")]
    out = {}
    worst = 0.0
    for name, A, Qm, lead, kind in cases:
        def cplx():
            return torch.view_as_complex(
                torch.randn(*lead, A, 2, generator=gen, device=dev))
        y, H = cplx(), cplx()
        n0 = 0.37 if kind == "scalar" else \
            0.01 + torch.rand(lead[-1], generator=gen, device=dev)
        got = mrc_llr(y, H, n0, Qm)
        want = mrc_llr_ref(y, H, n0, Qm)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        err = diff.max().item()
        ratio = (diff / (MRC_ATOL + MRC_RTOL * want.abs())).max().item()
        ms = _time_ms(lambda: mrc_llr(y, H, n0, Qm), 50)
        plain = _time_ms(lambda: mrc_llr_ref(y, H, n0, Qm), 5)
        print(f"mrc_llr {name} A={A} Qm={Qm} REs={lead[0] * lead[1]} "
              f"n0 {kind}: max|diff| {err:.3g}, max |diff|/(atol+rtol|ref|)"
              f" {ratio:.3g} (must be <= 1); kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms", flush=True)
        if not ratio <= 1.0:
            raise AssertionError(f"mrc_llr {name} disagrees: {ratio}")
        worst = max(worst, err)
        if name == "PDSCH":
            out = {"ms": ms, "plain_ms": plain}
    out["max_abs_err"] = worst
    return out


def check_small_input(dev) -> None:
    """25 PRB MCS 26 round 0: the card's path (kernels) against the CPU's
    (plain versions) on the same injected draws."""
    cfg = DlsimFadingConfig(mcs=26, n_rb=25, channel="EVA", n_rx=1,
                            n_harq_rounds=1, batch=4, est_mode="joint",
                            n_turbo_iter=4, est_prior="exp")
    snr = 30.0
    n0 = 10.0 ** (-snr / 10.0)
    gen = torch.Generator().manual_seed(7)
    sims = {d: DlsimFading(cfg, device=d) for d in ("cpu", dev)}
    tb = torch.randint(0, 2, (4, sims["cpu"].dlsch.cfg.tbs), generator=gen,
                       dtype=torch.int32)
    taps = torch.randn(4, 1, 1, sims["cpu"].chan.n_taps, 2, generator=gen)
    noise = torch.randn(4, 1, sims["cpu"].fp.samples_per_tti, 2,
                        generator=gen)
    res = {d: s.round0(tb, taps, noise, n0, s.wiener(snr), s.err_var(snr))
           for d, s in sims.items()}
    cpu, gpu = res["cpu"], res[dev]
    for field in ("ok", "dci_ok", "bit_errs"):
        a, b = getattr(cpu, field), getattr(gpu, field).cpu()
        if not torch.equal(a, b):
            raise AssertionError(f"small input: {field} {a} (CPU) vs {b}")
    if not bool(cpu.ok.all()):
        raise AssertionError(f"small input: not every TB decoded {cpu.ok}")
    worst = 0.0
    for a, b in zip(cpu.w_soft, gpu.w_soft):
        b = b.cpu()
        worst = max(worst, ((a - b).abs() / (1e-3 + 1e-3 * a.abs())).max()
                    .item())
    print(f"small input 25 PRB MCS 26 B=4 at {snr} dB: ok/dci_ok/bit_errs "
          f"equal on card and CPU; soft buffers max |diff|/(1e-3+1e-3|cpu|)"
          f" {worst:.3g} (must be <= 1)", flush=True)
    if not worst <= 1.0:
        raise AssertionError(f"small input soft buffers disagree: {worst}")


def flagship(dev) -> dict:
    cfg = DlsimFadingConfig(mcs=26, n_rb=100, channel="EVA", n_rx=1,
                            n_harq_rounds=1, batch=BATCH, est_mode="joint",
                            n_turbo_iter=8)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    reset_launch_counts()

    sim = DlsimFading(cfg, device=dev)
    n0 = 10.0 ** (-26.0 / 10.0)
    r = sim.step(gen, n0, sim.wiener(26.0), sim.err_var(26.0))
    torch.cuda.synchronize()
    n_ok, n_dci = int(r.ok.sum()), int(r.dci_ok.sum())
    print(f"flagship 26 dB: {n_ok}/{BATCH} TBs, {n_dci}/{BATCH} DCIs, "
          f"{int(r.bit_errs.sum())} bit errors", flush=True)
    if n_ok != BATCH or n_dci != BATCH or int(r.bit_errs.sum()) != 0:
        raise AssertionError("flagship at 26 dB must decode every TB and DCI")

    sim = DlsimFading(cfg, device=dev)            # bench SNR, fresh prior
    n0 = 10.0 ** (-24.0 / 10.0)
    W, ev = sim.wiener(24.0), sim.err_var(24.0)
    sim.step(gen, n0, W, ev)                      # settle the allocator
    torch.cuda.synchronize()
    n_rep = 10
    errs = trials = 0
    t0 = time.perf_counter()
    oks = [sim.step(gen, n0, W, ev).ok for _ in range(n_rep)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for ok in oks:
        errs += int((~ok).sum())
        trials += ok.numel()
    sf_per_s = n_rep * BATCH / dt
    counts = launch_counts()
    print(f"flagship 24 dB: BLER {errs / trials:.4f} ({errs}/{trials}), "
          f"{sf_per_s:.1f} subframes/s ({n_rep} steps of {BATCH}, "
          f"{dt:.3f} s)", flush=True)
    print(f"launches over the flagship runs: {counts}", flush=True)
    if errs == trials:
        raise AssertionError("flagship at 24 dB decodes no TB")
    if min(counts["turbo_half_iter"], counts["mrc_llr"]) == 0:
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    return counts


def _worst_ratio(got, want, rtol, atol) -> tuple:
    diff = (got - want).abs()
    return diff.max().item(), (diff / (atol + rtol * want.abs())).max().item()


def check_demap(dev, gen) -> dict:
    """demap_llr at the multi-antenna paths' shapes: one layer of TM3's
    MMSE output [64, 14,400, 2] at 100 PRB (read in place at stride 2),
    TM2's SFBC output at 50 PRB batch 128, the SFBC PDCCH."""
    n_pdcch = make_control_region_map(50, 1).n_cce * 36
    cases = [("TM3 layer 0", 6, (64, 14400), 0),
             ("TM3 layer 1", 4, (64, 14400), 1),
             ("TM2", 6, (128, 7200), None),
             ("SFBC PDCCH", 2, (128, n_pdcch), None)]
    out = {}
    worst = 0.0
    for name, Qm, lead, layer in cases:
        shape = lead + ((2,) if layer is not None else ())
        x = torch.view_as_complex(torch.randn(*shape, 2, generator=gen,
                                              device=dev)) * 0.7
        n0 = 0.01 + torch.rand(*shape, generator=gen, device=dev)
        if layer is not None:
            x, n0 = x[..., layer], n0[..., layer]
        got = demap_llr_fused(x, n0, Qm)
        want = demap_llr_fused_ref(x, n0, Qm)
        torch.cuda.synchronize()
        err, ratio = _worst_ratio(got, want, MRC_RTOL, MRC_ATOL)
        ms = _time_ms(lambda: demap_llr_fused(x, n0, Qm), 50)
        plain = _time_ms(lambda: demap_llr_fused_ref(x, n0, Qm), 5)
        print(f"demap_llr {name} Qm={Qm} REs={lead[0] * lead[1]} "
              f"{'stride 2' if layer is not None else 'contiguous'}: "
              f"max|diff| {err:.3g}, max |diff|/(atol+rtol|ref|) {ratio:.3g}"
              f" (must be <= 1); kernel {ms:.4f} ms, plain {plain:.4f} ms",
              flush=True)
        if not ratio <= 1.0:
            raise AssertionError(f"demap_llr {name} disagrees: {ratio}")
        worst = max(worst, err)
        if name == "TM3 layer 0":
            out = {"ms": ms, "plain_ms": plain}
    out["max_abs_err"] = worst
    return out


def check_turbo_v1(dev, gen) -> tuple:
    """The v1 kernel at the flagship shapes against its plain version and
    the v2 kernel. No path of the system runs v1, so its launch count is
    that of its own timed run (counts reset just before it)."""
    N = TURBO_W * TURBO_NW
    lin = 3.0 * torch.randn(TURBO_ROWS, N, generator=gen, device=dev)
    lp = 3.0 * torch.randn(TURBO_ROWS, N, generator=gen, device=dev)
    lin[:, -TURBO_W // 2:] = 1e4
    lp[:, -TURBO_W // 2:] = 1e4
    gpf, gpb = prep_parity(lp, TURBO_W, TURBO_U)
    got = half_iteration_prepped(lin, gpf, gpb, TURBO_W, TURBO_U)
    want = half_iteration_prepped_ref(lin, gpf, gpb, TURBO_W, TURBO_U)
    v2 = half_iteration(lin, lp, TURBO_W, TURBO_U)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    interior = torch.ones(N, dtype=torch.bool, device=dev)
    interior[TURBO_W - 1::TURBO_W] = False
    d_v2 = (got - v2)[:, interior].abs().max().item()
    reset_launch_counts()
    ms = _time_ms(lambda: half_iteration_prepped(lin, gpf, gpb, TURBO_W,
                                                 TURBO_U), 20)
    n_v1 = launch_counts()["turbo_half_iter_v1"]
    plain = _time_ms(lambda: half_iteration_prepped_ref(lin, gpf, gpb,
                                                        TURBO_W, TURBO_U), 3)
    print(f"turbo_half_iter_v1 [{TURBO_ROWS}, {N}] W={TURBO_W} U={TURBO_U}: "
          f"max|diff| {err:.3g} (tol {TURBO_ATOL}); max|diff| to the v2 "
          f"kernel on interior nodes {d_v2:.3g} (bound 0.05); kernel "
          f"{ms:.4f} ms over {n_v1} launches, plain {plain:.4f} ms",
          flush=True)
    if not err <= TURBO_ATOL:
        raise AssertionError(f"turbo v1 kernel disagrees: {err}")
    if not d_v2 <= 0.05:
        raise AssertionError(f"turbo v1 and v2 disagree inside windows: {d_v2}")
    if n_v1 == 0:
        raise AssertionError("the timed v1 run never launched the v1 kernel")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain}, n_v1


_SMALL_MIMO = [("TM2", dict(mcs=25, channel="EVA")),
               ("TM3", dict(tm=3, mcs=16, mcs2=9)),
               ("TM4", dict(tm=4, mcs=11, mcs2=11, pmi=2)),
               ("TM5 IA", dict(tm=5, mcs=12, pmi=0, pmi_interferer=1)),
               ("TM6", dict(tm=6, mcs=20, pmi=3))]


def check_small_mimo(dev) -> None:
    """25 PRB, batch 4, 30 dB, decoder window 240 on both sides: the card's
    path (kernels) against the CPU's (plain versions) on the same draws."""
    B, snr = 4, 30.0
    n0 = 10.0 ** (-snr / 10.0)
    for name, case in _SMALL_MIMO:
        common = dict(n_rb=25, batch=B, n_turbo_iter=4, decoder_window=240,
                      **case)
        gen = torch.Generator().manual_seed(11)
        if name == "TM2":
            sims = {d: DlsimTxDiv(DlsimTxDivConfig(**common), device=d)
                    for d in ("cpu", dev)}
            s = sims["cpu"]
            draws = (torch.randint(0, 2, (B, s.dlsch.cfg.tbs), generator=gen,
                                   dtype=torch.int32),
                     torch.randn(B, 2, 2, s.chan.n_taps, 2, generator=gen),
                     torch.randn(B, 2, s.fp.samples_per_tti, 2,
                                 generator=gen))
            extra = ()
        else:
            sims = {d: DlsimSm(DlsimSmConfig(**common), device=d)
                    for d in ("cpu", dev)}
            s = sims["cpu"]
            draws = ([torch.randint(0, 2, (B, c.cfg.tbs), generator=gen,
                                    dtype=torch.int32) for c in s.codecs],
                     torch.randn(B, 2, 2, 2, generator=gen),
                     torch.randn(B, 2, s.fp.samples_per_tti, 2,
                                 generator=gen))
            extra = (torch.randint(0, 4, (B, s.gm.n_data_re),
                                   generator=gen),) if case["tm"] == 5 else ()
        res = {d: sim.trial(*draws, n0, *sim.wiener(snr), *extra)
               for d, sim in sims.items()}
        cpu, gpu = res["cpu"], res[dev]
        for field in ("ok", "dci_ok", "bit_errs"):
            a, b = getattr(cpu, field), getattr(gpu, field).cpu()
            if not torch.equal(a, b):
                raise AssertionError(f"small {name}: {field} {a} (CPU) vs {b}")
        if not bool(cpu.dci_ok.all()):
            raise AssertionError(f"small {name}: a DCI was missed at {snr} dB")
        worst = max(_worst_ratio(g.cpu(), c, 1e-3, 1e-3)[1]
                    for c, g in zip(cpu.llr, gpu.llr))
        print(f"small {name} 25 PRB B={B} at {snr} dB: ok {cpu.ok.tolist()}, "
              f"dci_ok and bit_errs equal on card and CPU; decoder-input "
              f"LLRs max |diff|/(1e-3+1e-3|cpu|) {worst:.3g}", flush=True)


def tm2_anchor(dev) -> int:
    """TM2 SFBC 50 PRB MCS 25 EVA 2x2, estimated channel, batch 128: 2048
    trials at 14 and 15 dB against fidelity_campaign.json "txdiv64"
    (0.0703 and 0.0107 over 2048 trials each, taken on a TPU); the bands
    are about 3.3 sigma of a two-sample binomial difference."""
    sim = DlsimTxDiv(DlsimTxDivConfig(mcs=25, n_rb=50, n_rx=2, channel="EVA",
                                      batch=128), device=dev)
    W0, W1 = sim.wiener(14.0)
    sim.step(torch.Generator(device=dev).manual_seed(99), 10 ** -1.4, W0, W1)
    torch.cuda.synchronize()
    reset_launch_counts()
    bler = {}
    for snr in (14.0, 15.0):
        t0 = time.perf_counter()
        errs, trials = sim.run_snr(snr, 2048, seed=int(snr))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        bler[snr] = errs / trials
        print(f"TM2 50 PRB MCS 25 EVA 2x2 {snr} dB: BLER {bler[snr]:.4f} "
              f"({errs}/{trials}), DCI misses {sim.dci_miss}, "
              f"{trials / dt:.1f} subframes/s ({trials // 128} steps of 128,"
              f" {dt:.3f} s)", flush=True)
    counts = launch_counts()
    print(f"launches over the TM2 runs: {counts}", flush=True)
    if not 0.044 <= bler[14.0] <= 0.097:
        raise AssertionError(f"TM2 BLER at 14 dB {bler[14.0]} outside "
                             "[0.044, 0.097]")
    if not bler[15.0] <= 0.021:
        raise AssertionError(f"TM2 BLER at 15 dB {bler[15.0]} above 0.021")
    if sim.dci_miss:
        raise AssertionError(f"TM2: {sim.dci_miss} DCI misses at 15 dB")
    if min(counts["demap_llr"], counts["turbo_half_iter"]) == 0:
        raise AssertionError(f"a kernel of the TM2 path never launched: "
                             f"{counts}")
    return counts["demap_llr"]


def tm3_full_width(dev) -> int:
    """TM3 CDD 100 PRB MCS 26/26 2x2 flat Rayleigh, estimated channel,
    batch 64, 8 turbo iterations, 10 steps at 40 dB."""
    B, n_rep = 64, 10
    sim = DlsimSm(DlsimSmConfig(tm=3, mcs=26, mcs2=26, n_rb=100, n_rx=2,
                                batch=B), device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    n0 = 10.0 ** (-40.0 / 10.0)
    W0, W1 = sim.wiener(40.0)
    sim.step(gen, n0, W0, W1)                     # settle the allocator
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = [sim.step(gen, n0, W0, W1) for _ in range(n_rep)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    errs = sum((~r.ok).sum(dim=1) for r in res).tolist()
    dci_miss = sum(int((~r.dci_ok).sum()) for r in res)
    bler = [e / (n_rep * B) for e in errs]
    print(f"TM3 100 PRB MCS 26/26 2x2 40 dB: BLER cw0 {bler[0]:.4f} "
          f"({errs[0]}/{n_rep * B}), cw1 {bler[1]:.4f} ({errs[1]}/"
          f"{n_rep * B}), DCI misses {dci_miss}, {n_rep * B / dt:.1f} "
          f"subframes/s ({n_rep} steps of {B}, {dt:.3f} s)", flush=True)
    print(f"launches over the TM3 runs: {counts}", flush=True)
    if dci_miss:
        raise AssertionError(f"TM3: {dci_miss} DCI misses at 40 dB")
    if max(bler) > 0.2:
        raise AssertionError(f"TM3 codeword BLER {bler} above 0.2")
    if min(counts["demap_llr"], counts["turbo_half_iter"]) == 0:
        raise AssertionError(f"a kernel of the TM3 path never launched: "
                             f"{counts}")
    return counts["demap_llr"]


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's check needs one")
    dev = "cuda"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    kernels.load()
    info = kernels.build_info
    print(f"built {', '.join(kernels.SOURCES)} from openair4g_tpu_torch/csrc "
          f"with nvcc {info['flags']} in {info['seconds']:.1f} s -> "
          f"{info['path']}", flush=True)
    name = None
    for line in info["ptxas"].splitlines():
        m = re.search(r"(turbo_half_iter_kernel|turbo_half_iter_v1_kernel|"
                      r"mrc_llr_kernel|demap_llr_kernel)I((?:Li\d+E)+)", line)
        if m:
            name = f"{m[1]}<{','.join(re.findall(r'Li(\d+)E', m[2]))}>"
        elif "registers" in line and name:
            print(f"  ptxas {name}: {line.split(':', 1)[-1].strip()}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    turbo = check_turbo(dev, gen)
    mrc = check_mrc(dev, gen)
    check_small_input(dev)
    counts = flagship(dev)
    demap = check_demap(dev, gen)
    turbo_v1, n_v1 = check_turbo_v1(dev, gen)
    check_small_mimo(dev)
    n_demap = tm2_anchor(dev) + tm3_full_width(dev)

    rows = [
        dict(name="turbo_half_iter", route="cuda",
             source="openair4g_tpu_torch/csrc/turbo_half_iter.cu",
             replaces="openair4g_tpu/ops/turbo_pallas.py:219",
             launches=counts["turbo_half_iter"], **turbo),
        dict(name="turbo_half_iter_v1", route="cuda",
             source="openair4g_tpu_torch/csrc/turbo_half_iter.cu",
             replaces="openair4g_tpu/ops/turbo_pallas.py:70",
             launches=n_v1, **turbo_v1),
        dict(name="mrc_llr", route="cuda",
             source="openair4g_tpu_torch/csrc/mrc_llr.cu",
             replaces="openair4g_tpu/ops/equalize_llr.py:40",
             launches=counts["mrc_llr"], **mrc),
        dict(name="demap_llr", route="cuda",
             source="openair4g_tpu_torch/csrc/mrc_llr.cu",
             replaces="openair4g_tpu/ops/equalize_llr.py:138",
             launches=n_demap, **demap),
    ]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
