#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (openair4g_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. the card's name and power limit, torch and CUDA versions;
  2. build the hand-written kernels from openair4g_tpu_torch/csrc/ for
     sm_90a into build/kernels/ (one nvcc call), with ptxas's register
     report;
  3. the v2 turbo kernel and mrc_llr against their plain PyTorch versions
     on the card at the 20 MHz flagship shapes (the PDCCH's n0 a number,
     which goes in as a kernel argument; max |diff| against the
     stated tolerance, time of each by CUDA events over back-to-back
     calls; the device time comes in phase 16). The v2 kernel keeps
     one beta checkpoint per 8 trellis nodes in an L2-sized scratch and
     recomputes each block's betas from it, with float4 loads and stores;
     it must equal its plain version bit for bit. The phase prints that
     scratch's bytes and the peak device memory of the kernel's call and
     of the phase;
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
     its timed run. It keeps beta checkpoints as v2 does and reads lin
     where it lies: the phase prints the call's measured scratch, fails
     above 45 MB, and checks that each call adds one to the wrapper's
     launch count (phase 16 counts the device kernels of one call);
  8. small inputs of the multi-antenna simulators (TM2, TM3, TM4, TM5 IA,
     TM6; 25 PRB, batch 4, 30 dB), card against CPU on the same injected
     draws: TB flags, DCI flags and bit errors must be equal;
  9. TM2 at the fidelity corpus configuration (50 PRB, MCS 25, EVA, 2x2,
     estimated channel, batch 128), 2048 trials at 14 and 15 dB, held to
     the corpus anchor fidelity_campaign.json "txdiv64";
 10. TM3 at full width (100 PRB, MCS 26/26, 2x2, batch 64): at 40 dB every
     DCI decodes and each codeword's BLER over 10 steps is at most 0.2;
 11. mrc_llr at A = 2 against its plain version at the 1x2 path's shapes
     (100 PRB, CFI 2, batch 128: data Qm = 6 with per-RE n0, PDCCH Qm = 2
     with n0 a number), interleaved [B, N, 2] and as the path gives them,
     [B, 2, N] antenna planes passed as transposed views and read where
     they lie: the two must be equal;
 12. small inputs of DlsimFading (25 PRB, batch 4, 30 dB: dd 1x2 over 4
     HARQ rounds, interp on AWGN, the time-domain ETU channel, EVA at
     200 Hz, the AR(1) fade over 2 rounds, perfect CE 1x2) and DlsimAwgn,
     card against CPU on the same draws: every round's TB flags, DCI flags
     and bit errors must be equal;
 13. the corpus receiver at full width: DlsimFading 100 PRB, MCS 26, EVA,
     1x2 MRC, dd, CFI 2, 4 HARQ rounds, dlsim SNR convention, batch 128,
     8 steps at 14.6 dB: round-0 BLER in [0.02, 0.98], fewer errors in
     round 1 than 0, at most 1 % DCI misses, both kernels launched;
 14. the SISO fidelity anchors of tests/test_bler_anchor.py and
     tests/test_fading.py, fading corpus tests 6 and 11 and the Doppler
     corpus point, with the reference's configurations, trial counts and
     bands (the JAX anchors were taken on a TPU);
 15. DlsimAwgn at bench.py's second configuration (BLER at most 0.01 at
     1 dB) and the dlsim command line on the card (-g EVA -r 4, -x 2),
     each writing a reference-schema CSV under build/;
 16. the device time of every kernel at each shape phases 3, 6, 7 and 11
     timed, by torch.profiler's device-side events (the kernel alone,
     without the host's enqueue time that CUDA events around
     back-to-back calls of a few-µs kernel measure), each beside the
     launch floor, the device time of an empty <<<1, 32>>> kernel of the
     same library (kernels of different names share a profiler session);
     then the device kernels, copies and fills of one v1
     call, which must be its one kernel; then the device time a step of
     phase 13's path. It runs last: the profiler is started after every
     path has run, so no path is timed in a process that has held a
     profiling session.
Each path is driven with the launch counts set to 0 just before it and
read just after; every kernel must have launched on its path (v1, which
no path runs, in its own timed run). Each phase prints its seconds. Ends
with a JSON line of the kernels (launches on the paths, launches per
flagship step, error, times, and the bound: the least time the card could
take for the same work, from its bytes or operations), then the device
JSON line. It needs a CUDA device and imports nothing of JAX.
"""
import functools
import json
import os
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
                                                prep_parity, scratch_numel)
from openair4g_tpu_torch.phy.control_region import make_control_region_map
from openair4g_tpu_torch.phy.resource_grid import make_grid_map
from openair4g_tpu_torch.sim.dlsim import (DlsimAwgn, DlsimConfig,
                                           DlsimFading, DlsimFadingConfig,
                                           dlsim_snr_offset_db)
from openair4g_tpu_torch.sim.harness import dlsim_main
from openair4g_tpu_torch.sim.dlsim_mimo import DlsimTxDiv, DlsimTxDivConfig
from openair4g_tpu_torch.sim.dlsim_sm import DlsimSm, DlsimSmConfig
from openair4g_tpu_torch.sim.phase_split import profile_steps

# Flagship shapes: 128 subframes x 11 code blocks of K = 5632 decode as
# 1,408 rows of N = 5760 (24 windows of W = 240); 15,000 data REs and
# 756 PDCCH REs per subframe.
BATCH = 128
TURBO_ROWS, TURBO_W, TURBO_U, TURBO_NW = BATCH * 11, 240, 24, 24
N_DATA, N_PDCCH_RE = 15000, 756
# The turbo kernels and their plain versions run the same float32
# operations in the same order: they must be equal bit for bit.
TURBO_ATOL = 0.0
# mrc_llr: the kernel forms -(num - l h2)^2 / (h2 n0), the plain version
# (num/h2 - l)^2 / (n0/h2): same value, other rounding (as the reference's
# tests/test_equalize_llr.py tolerates).
MRC_RTOL = MRC_ATOL = 3e-4
# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM
# bytes/s, and float32 operations/s outside the tensor cores. The data
# sheet's 67 TFLOP/s counts an FMA as two; the kernels' add, sub, max and
# mul issue one a lane a cycle, so an operation counts at half that rate.
HBM_BYTES_S, FP32_OPS_S = 3.35e12, 67e12 / 2
# The v2 scratch's limit at the flagship: one beta checkpoint per block
# takes 32.4 MB; a per-node beta stack would take 260 MB.
TURBO_SCRATCH_MAX = 40e6
# The v1 kernel's limit: the same checkpoints (a per-node stack over its
# W + U rows would take 285 MB).
TURBO_V1_SCRATCH_MAX = 45e6


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


def _profiled(items: list, n: int) -> list:
    """[(launches seen, summed device µs)] for each (fn, kernel name) of
    items: n back-to-back calls of each fn in turn, recorded in the second
    of two profiler cycles (the first, the same calls, lets the device
    tracing start: a session that records from its first call can miss the
    launches made while it starts). A kernel name is matched with the
    spaces taken out, and no two items of one session may share one."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        for _ in range(2):
            for fn, _ in items:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
            prof.step()
    events = [(e.key.replace(" ", ""), e.count, e.self_device_time_total)
              for e in prof.key_averages() if e.self_device_time_total > 0]
    return [(sum(c for key, c, _ in events if kernel in key),
             sum(us for key, _, us in events if kernel in key))
            for _, kernel in items]


def _device_ms(items: list, n: int) -> list:
    """[(mean device time in ms, launches it is the mean of)] of each
    (fn, kernel name) of items, from torch.profiler's device-side events:
    the kernel alone, without the host's enqueue time that CUDA events
    around back-to-back calls of a short kernel measure. Items whose
    kernel names differ share a profiler session. The items whose device
    events miss some of their n launches are run again, up to three
    sessions in all; the mean is over every launch the best session saw,
    and no launch seen in any is an error."""
    for fn, _ in items:
        fn()
    torch.cuda.synchronize()
    best = [(0, 0.0)] * len(items)
    todo = list(range(len(items)))
    for _ in range(3):
        sessions = []            # indices, no kernel name twice in one
        for k in todo:
            for session in sessions:
                if all(items[j][1] != items[k][1] for j in session):
                    session.append(k)
                    break
            else:
                sessions.append([k])
        for session in sessions:
            seen = _profiled([items[k] for k in session], n)
            for k, got in zip(session, seen):
                best[k] = max(best[k], got)
                if got[0] != n:
                    print(f"  profiler saw {got[0]} of {n} launches of "
                          f"{items[k][1]}", flush=True)
        todo = [k for k in todo if best[k][0] != n]
        if not todo:
            break
    for k, (count, _) in enumerate(best):
        if count == 0:
            raise AssertionError("the profiler saw no launch of "
                                 f"{items[k][1]}")
    return [(us / count / 1e3, count) for count, us in best]


def _device_events(fn) -> list:
    """(name, count) of every device-side event (kernels, copies, fills)
    that one call of fn makes, by torch.profiler."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.key, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]


def device_times(timings: list, one_launch: tuple, dd: tuple) -> None:
    """Phase 16: the launch floor (an empty <<<1, 32>>> kernel of the
    library) and each (label, fn, kernel name, row) that the kernel checks
    queued, timed by _device_ms (the row, if any, takes it as device_ms);
    the device events of one call of one_launch = (label, fn, kernel name),
    which must be that kernel once and nothing else; the device time a step
    of dd = (sim, SNR)."""
    lib = kernels.load()
    stream = torch.cuda.current_stream().cuda_stream
    items = [(lambda: kernels.check(lib.empty_launch(stream), "empty"),
              "empty_kernel")] + [(fn, kernel) for _, fn, kernel, _ in timings]
    (floor, count), *times = _device_ms(items, 20)
    print(f"launch floor: an empty <<<1, 32>>> kernel takes {floor:.4f} ms "
          f"of device time (mean of {count} launches)", flush=True)
    for (label, _, _, row), (ms, count) in zip(timings, times):
        print(f"{label}: device time {ms:.4f} ms (mean of {count} "
              f"launches; launch floor {floor:.4f} ms)", flush=True)
        if row is not None:
            row["device_ms"] = ms
            row["launch_floor_ms"] = floor

    label, fn, kernel = one_launch
    fn()
    for _ in range(3):       # a session can miss events: none seen, again
        seen = _device_events(fn)
        if seen:
            break
    print(f"{label}: the device events of one call: {seen}", flush=True)
    if len(seen) != 1 or kernel not in seen[0][0] or seen[0][1] != 1:
        raise AssertionError(f"{label}: one call must be one launch of "
                             f"{kernel} and no other device work: {seen}")

    sim, snr = dd
    snr += dlsim_snr_offset_db(sim.gm)
    n0 = 10.0 ** (-snr / 10.0)
    gen = torch.Generator(device=sim.device).manual_seed(5)
    n_steps = 2
    _, dev_us, wall = profile_steps(sim, gen, n0,
                                    (sim.wiener(snr), sim.err_var(snr)),
                                    n=n_steps)
    print(f"dd 1x2 100 PRB, 4 rounds: {dev_us / n_steps / 1e3:.2f} ms device "
          f"time a step over {n_steps} profiled steps ({wall * 1e3:.1f} ms a "
          f"profiled step on the host)", flush=True)


def _bound(n_bytes: float, n_ops: float) -> dict:
    """The least time for moving n_bytes and doing n_ops float32
    operations on the card, and which of the two sets it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / FP32_OPS_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# Float32 operations a trellis position of one half-iteration takes: beta
# step 40, alpha step 32, LLR 51 (8 states), renormalizations and the two
# 0.5 scalings 5.
TURBO_OPS_PER_POS = 128


def check_turbo(dev, gen, timings) -> dict:
    N = TURBO_W * TURBO_NW
    lin = 3.0 * torch.randn(TURBO_ROWS, N, generator=gen, device=dev)
    lp = 3.0 * torch.randn(TURBO_ROWS, N, generator=gen, device=dev)
    lin[:, -TURBO_W // 2:] = 1e4       # the forced pad region after the tail
    lp[:, -TURBO_W // 2:] = 1e4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    got = half_iteration(lin, lp, TURBO_W, TURBO_U)
    torch.cuda.synchronize()
    call_peak = torch.cuda.max_memory_allocated() - held
    want = half_iteration_ref(lin, lp, TURBO_W, TURBO_U)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    lanes = TURBO_ROWS * TURBO_NW
    # measured: what the call allocated beyond its output
    scratch = call_peak - 4 * got.numel()
    print(f"turbo_half_iter [{TURBO_ROWS}, {N}] W={TURBO_W} U={TURBO_U} "
          f"lanes={lanes}: max|diff| {err:.3g} (tol {TURBO_ATOL}); "
          f"the call's peak {call_peak} bytes above the {held} held before "
          f"it, {scratch} of them scratch (the checkpoints' size "
          f"{4 * scratch_numel(lanes, TURBO_W, TURBO_U)})", flush=True)
    if not err <= TURBO_ATOL:
        raise AssertionError(f"turbo kernel disagrees: {err}")
    if scratch > TURBO_SCRATCH_MAX:
        raise AssertionError(f"turbo kernel scratch {scratch} bytes")
    kernel = functools.partial(half_iteration, lin, lp, TURBO_W, TURBO_U)
    ms = _time_ms(kernel, 20)
    plain = _time_ms(lambda: half_iteration_ref(lin, lp, TURBO_W, TURBO_U), 3)
    bound = _bound(3 * 4 * TURBO_ROWS * N, TURBO_OPS_PER_POS * TURBO_ROWS * N)
    print(f"  kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}); share of the "
          f"bound (bound / time) {bound['bound_ms'] / ms:.1%}", flush=True)
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
           "scratch_bytes": scratch, **bound}
    timings.append(("turbo_half_iter flagship", kernel,
                    "turbo_half_iter_kernel<", row))
    return row


def _mrc_bound(n_re: int, A: int, Qm: int, n0_numel: int) -> dict:
    """y and H complex64 [n, A] in, n0 float32, LLRs float32 [n, Qm] out;
    about 12 operations an antenna (MRC sums) and 10 a bit (max-log
    metrics) per RE."""
    return _bound(16 * n_re * A + 4 * n0_numel + 4 * n_re * Qm,
                  (12 * A + 10 * Qm) * n_re)


def check_mrc(dev, gen, timings) -> dict:
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
        n_re = lead[0] * lead[1]
        bound = _mrc_bound(n_re, A, Qm, 1 if kind == "scalar" else lead[1])
        print(f"mrc_llr {name} A={A} Qm={Qm} REs={n_re} "
              f"n0 {kind}: max|diff| {err:.3g}, max |diff|/(atol+rtol|ref|)"
              f" {ratio:.3g} (must be <= 1); kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']})", flush=True)
        if not ratio <= 1.0:
            raise AssertionError(f"mrc_llr {name} disagrees: {ratio}")
        worst = max(worst, err)
        row = None
        if name == "PDSCH":
            out = row = {"ms": ms, "plain_ms": plain, **bound}
        timings.append((f"mrc_llr {name} A={A} Qm={Qm} REs={n_re}",
                        functools.partial(mrc_llr, y, H, n0, Qm),
                        f"mrc_llr_kernel<{A},{Qm}>", row))
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
    res = {d: s.trial(tb, [taps], [noise], n0, s.wiener(snr),
                      s.err_var(snr)).rounds[0] for d, s in sims.items()}
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


def flagship(dev) -> tuple:
    cfg = DlsimFadingConfig(mcs=26, n_rb=100, channel="EVA", n_rx=1,
                            n_harq_rounds=1, batch=BATCH, est_mode="joint",
                            n_turbo_iter=8)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    reset_launch_counts()

    sim = DlsimFading(cfg, device=dev)
    n0 = 10.0 ** (-26.0 / 10.0)
    r = sim.step(gen, n0, sim.wiener(26.0), sim.err_var(26.0)).rounds[0]
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
    oks = [sim.step(gen, n0, W, ev).rounds[0].ok for _ in range(n_rep)]
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
    return counts, 2 + n_rep       # steps: 26 dB, settle, timed


def _worst_ratio(got, want, rtol, atol) -> tuple:
    diff = (got - want).abs()
    return diff.max().item(), (diff / (atol + rtol * want.abs())).max().item()


def check_demap(dev, gen, timings) -> dict:
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
        n_re = lead[0] * lead[1]
        # x complex64 and n0 float32 in, Qm LLRs out; about 10 operations
        # a bit
        bound = _bound((8 + 4 + 4 * Qm) * n_re, 10 * Qm * n_re)
        print(f"demap_llr {name} Qm={Qm} REs={n_re} "
              f"{'stride 2' if layer is not None else 'contiguous'}: "
              f"max|diff| {err:.3g}, max |diff|/(atol+rtol|ref|) {ratio:.3g}"
              f" (must be <= 1); kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})",
              flush=True)
        if not ratio <= 1.0:
            raise AssertionError(f"demap_llr {name} disagrees: {ratio}")
        worst = max(worst, err)
        row = None
        if name == "TM3 layer 0":
            out = row = {"ms": ms, "plain_ms": plain, **bound}
        timings.append((f"demap_llr {name} Qm={Qm} REs={n_re}",
                        functools.partial(demap_llr_fused, x, n0, Qm),
                        f"demap_llr_kernel<{Qm}>", row))
    out["max_abs_err"] = worst
    return out


def check_turbo_v1(dev, gen, timings) -> tuple:
    """The v1 kernel at the flagship shapes against its plain version and
    the v2 kernel, with the scratch one call allocates. No path of the
    system runs v1, so its launch count is that of its own timed run
    (counts reset just before it), one launch a call."""
    N = TURBO_W * TURBO_NW
    lin = 3.0 * torch.randn(TURBO_ROWS, N, generator=gen, device=dev)
    lp = 3.0 * torch.randn(TURBO_ROWS, N, generator=gen, device=dev)
    lin[:, -TURBO_W // 2:] = 1e4
    lp[:, -TURBO_W // 2:] = 1e4
    gpf, gpb = prep_parity(lp, TURBO_W, TURBO_U)
    half_iteration_prepped(lin, gpf, gpb, TURBO_W, TURBO_U)   # built, loaded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    got = half_iteration_prepped(lin, gpf, gpb, TURBO_W, TURBO_U)
    torch.cuda.synchronize()
    # measured: what the call allocated beyond its output
    scratch = torch.cuda.max_memory_allocated() - held - 4 * got.numel()
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
    if n_v1 != 21:           # _time_ms: one warm-up call and the 20 timed
        raise AssertionError(f"21 v1 calls made {n_v1} launches")
    plain = _time_ms(lambda: half_iteration_prepped_ref(lin, gpf, gpb,
                                                        TURBO_W, TURBO_U), 3)
    # lin [B, N] and the two parity frames [W+U, L] in, [B, N] out
    n_pos = TURBO_ROWS * N
    bound = _bound(4 * (2 * n_pos + gpf.numel() + gpb.numel()),
                   TURBO_OPS_PER_POS * n_pos)
    # the bytes the function needs: rows U.. of gpf repeat rows 0..W-1 of
    # gpb, so of gpf only the U warm-up rows
    needed = _bound(4 * (2 * n_pos + TURBO_U * gpf.shape[1] + gpb.numel()),
                    TURBO_OPS_PER_POS * n_pos)
    print(f"turbo_half_iter_v1 [{TURBO_ROWS}, {N}] W={TURBO_W} U={TURBO_U}: "
          f"max|diff| {err:.3g} (tol {TURBO_ATOL}); max|diff| to the v2 "
          f"kernel on interior nodes {d_v2:.3g} (bound 0.05); kernel "
          f"{ms:.4f} ms over {n_v1} launches in {n_v1} calls, plain "
          f"{plain:.4f} ms, bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}, every input once; with gpf's {TURBO_U} "
          f"warm-up rows only, the rest being in gpb, "
          f"{needed['bound_ms']:.4f} ms by {needed['bound_by']}); the "
          f"call's scratch {scratch} bytes (the "
          f"checkpoints' size "
          f"{4 * scratch_numel(TURBO_ROWS * TURBO_NW, TURBO_W, TURBO_U)}; "
          f"limit {TURBO_V1_SCRATCH_MAX:.0f})", flush=True)
    if not err <= TURBO_ATOL:
        raise AssertionError(f"turbo v1 kernel disagrees: {err}")
    if not d_v2 <= 0.05:
        raise AssertionError(f"turbo v1 and v2 disagree inside windows: {d_v2}")
    if scratch > TURBO_V1_SCRATCH_MAX:
        raise AssertionError(f"turbo v1 kernel scratch {scratch} bytes")
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
           "scratch_bytes": scratch, **bound,
           "needed_bound_ms": needed["bound_ms"],
           "needed_bound_by": needed["bound_by"]}
    call = functools.partial(half_iteration_prepped, lin, gpf, gpb, TURBO_W,
                             TURBO_U)
    timings.append(("turbo_half_iter_v1 flagship", call,
                    "turbo_half_iter_v1_kernel<", row))
    return row, n_v1, ("turbo_half_iter_v1 flagship", call,
                       "turbo_half_iter_v1_kernel")


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


def check_mrc_a2(dev, gen, timings) -> dict:
    """mrc_llr at A = 2 on the 1x2 path's full-width shapes: 100 PRB at
    CFI 2 (13,800 data REs, 1,980 PDCCH REs), batch 128; data Qm = 6 with
    per-RE n0, PDCCH Qm = 2 with n0 a number; interleaved [B, N, 2], and
    [B, 2, N] planes given as transposed views, which must give the same
    LLRs."""
    n_data = make_grid_map(100, 2).n_data_re
    n_pdcch = make_control_region_map(100, 2).n_cce * 36
    out, worst = {}, 0.0
    for name, Qm, n_re, per_re in (("1x2 PDSCH", 6, n_data, True),
                                   ("1x2 PDCCH", 2, n_pdcch, False)):
        y, H = (torch.view_as_complex(torch.randn(BATCH, n_re, 2, 2,
                                                  generator=gen, device=dev))
                for _ in range(2))
        n0 = 0.01 + torch.rand(n_re, generator=gen, device=dev) if per_re \
            else 0.05
        got = mrc_llr(y, H, n0, Qm)
        want = mrc_llr_ref(y, H, n0, Qm)
        # what the 1x2 receiver passes: [B, 2, N] planes as transposed views
        yp, Hp = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  for t in (y, H))
        planes = mrc_llr(yp, Hp, n0, Qm)
        torch.cuda.synchronize()
        err, ratio = _worst_ratio(got, want, MRC_RTOL, MRC_ATOL)
        ms = _time_ms(lambda: mrc_llr(y, H, n0, Qm), 50)
        planes_ms = _time_ms(lambda: mrc_llr(yp, Hp, n0, Qm), 50)
        plain = _time_ms(lambda: mrc_llr_ref(y, H, n0, Qm), 5)
        bound = _mrc_bound(BATCH * n_re, 2, Qm, n_re if per_re else 1)
        print(f"mrc_llr {name} A=2 Qm={Qm} REs={BATCH * n_re}: max|diff| "
              f"{err:.3g}, max |diff|/(atol+rtol|ref|) {ratio:.3g} (must be "
              f"<= 1); kernel {ms:.4f} ms interleaved, {planes_ms:.4f} ms on "
              f"[B, 2, N] planes (equal: {torch.equal(planes, got)}), plain "
              f"{plain:.4f} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']})", flush=True)
        timings.append((f"mrc_llr {name} A=2 Qm={Qm} REs={BATCH * n_re}",
                        functools.partial(mrc_llr, y, H, n0, Qm),
                        f"mrc_llr_kernel<2,{Qm}>", None))
        timings.append((f"mrc_llr {name} A=2 Qm={Qm} REs={BATCH * n_re} on "
                        "[B, 2, N] planes",
                        functools.partial(mrc_llr, yp, Hp, n0, Qm),
                        f"mrc_llr_kernel<2,{Qm}>", None))
        if yp.is_contiguous() or not torch.equal(planes, got):
            raise AssertionError(f"mrc_llr {name} on [B, 2, N] planes is not "
                                 "the interleaved call's result")
        if not ratio <= 1.0:
            raise AssertionError(f"mrc_llr {name} A=2 disagrees: {ratio}")
        worst = max(worst, err)
        if name == "1x2 PDSCH":
            out = {"a2_ms": ms, "a2_plain_ms": plain}
    out["a2_max_abs_err"] = worst
    return out


def _on(x, dev):
    """The estimator state (a tensor or a pair) on `dev`."""
    return tuple(t.to(dev) for t in x) if isinstance(x, tuple) else x.to(dev)


_SMALL_SISO = [("dd 1x2, 4 rounds", dict(mcs=16, channel="EVA", n_rx=2,
                                         est_mode="dd", n_harq_rounds=4)),
               ("interp AWGN", dict(mcs=16, channel="AWGN",
                                    n_harq_rounds=1)),
               ("time-domain ETU", dict(mcs=10, channel="ETU",
                                        time_domain_channel=True,
                                        n_harq_rounds=1)),
               ("EVA 200 Hz interp", dict(mcs=10, channel="EVA",
                                          intra_doppler_hz=200.0,
                                          n_harq_rounds=1)),
               ("harq_doppler 10 Hz, 2 rounds",
                dict(mcs=10, channel="EVA", harq_doppler_hz=10.0,
                     est_mode="joint", n_harq_rounds=2)),
               ("perfect CE 1x2", dict(mcs=16, channel="EVA", n_rx=2,
                                       perfect_ce=True, n_harq_rounds=1))]


def _equal_on_card_and_cpu(name, cpu, gpu) -> None:
    for field in ("ok", "dci_ok", "bit_errs"):
        a, b = getattr(cpu, field), getattr(gpu, field).cpu()
        if not torch.equal(a, b):
            raise AssertionError(f"small {name}: {field} {a} (CPU) vs {b}")


def check_small_siso(dev) -> None:
    """25 PRB, batch 4, 30 dB, decoder window 240 on both sides: each
    DlsimFading mode of this slice and DlsimAwgn, card (kernels) against
    CPU (plain versions) on the same draws and estimator state, every
    round's TB flags, DCI flags and bit errors."""
    B, snr = 4, 30.0
    n0 = 10.0 ** (-snr / 10.0)
    for name, case in _SMALL_SISO:
        cfg = DlsimFadingConfig(n_rb=25, batch=B, n_turbo_iter=4,
                                decoder_window=240, **case)
        cpu, gpu = DlsimFading(cfg, device="cpu"), DlsimFading(cfg, device=dev)
        draws = cpu.draw(torch.Generator().manual_seed(17))
        W, ev = cpu.wiener(snr), cpu.err_var(snr)
        a = cpu.trial(*draws, n0, W, ev)
        b = gpu.trial(*draws, n0, _on(W, dev), ev.to(dev))
        for r, (ra, rb) in enumerate(zip(a.rounds, b.rounds)):
            _equal_on_card_and_cpu(f"{name} round {r}", ra, rb)
        if not (torch.equal(a.errs, b.errs.cpu())
                and torch.equal(a.reach, b.reach.cpu())):
            raise AssertionError(f"small {name}: errs/reach {a.errs} "
                                 f"{a.reach} (CPU) vs {b.errs} {b.reach}")
        if not bool(a.rounds[0].dci_ok.all()):
            raise AssertionError(f"small {name}: a DCI was missed at {snr} dB")
        print(f"small {name} 25 PRB B={B} at {snr} dB: round flags "
              f"{[r.ok.tolist() for r in a.rounds]}, DCI flags and bit errors"
              f" equal on card and CPU in every round", flush=True)
    cfg = DlsimConfig(mcs=16, n_rb=25, batch=B, decoder_window=240)
    cpu, gpu = DlsimAwgn(cfg, device="cpu"), DlsimAwgn(cfg, device=dev)
    gen = torch.Generator().manual_seed(18)
    tb = torch.randint(0, 2, (B, cpu.dlsch.cfg.tbs), generator=gen,
                       dtype=torch.int32)
    noise = torch.randn(B, cpu.fp.samples_per_tti, 2, generator=gen)
    n0 = 10.0 ** (-11.0 / 10.0)
    a, b = cpu.trial(tb, noise, n0), gpu.trial(tb, noise, n0)
    _equal_on_card_and_cpu("DlsimAwgn", a, b)
    print(f"small DlsimAwgn 25 PRB MCS 16 B={B} at 11 dB: ok {a.ok.tolist()},"
          f" bit errors {a.bit_errs.tolist()} equal on card and CPU",
          flush=True)


def dd_full_width(dev) -> dict:
    """The corpus receiver at 20 MHz: 100 PRB, MCS 26, EVA, 1x2 MRC, dd,
    CFI 2, 4 HARQ rounds, dlsim SNR convention, batch 128, drawn on the
    card; 8 steps at 14.6 dB (corpus test 11's SNR), moved in 1 dB steps
    while round-0 BLER is outside [0.02, 0.98]."""
    cfg = DlsimFadingConfig(mcs=26, n_rb=100, channel="EVA", n_rx=2,
                            est_mode="dd", n_pdcch_symbols=2,
                            n_harq_rounds=4, snr_convention="dlsim",
                            batch=BATCH)
    sim = DlsimFading(cfg, device=dev)
    sim.run_snr(14.6, BATCH, seed=99)            # settle the allocator
    torch.cuda.synchronize()
    snr, tried = 14.6, []
    while True:
        reset_launch_counts()
        t0 = time.perf_counter()
        errs, reach = sim.run_snr(snr, 8 * BATCH, seed=1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_counts()
        bler = errs / np.maximum(reach, 1)
        tried.append(snr)
        if 0.02 <= bler[0] <= 0.98 or len(tried) == 4:
            break
        snr += 1.0 if bler[0] > 0.98 else -1.0
    steps = 8
    print(f"dd 1x2 100 PRB MCS 26 EVA CFI 2 4 rounds at {snr} dB (dlsim "
          f"convention; tried {tried}): per-round BLER "
          f"{[round(float(x), 4) for x in bler]} (errs {errs.tolist()}, "
          f"reached {reach.tolist()}), round-0 DCI misses {sim.dci_miss}, "
          f"{steps * BATCH / dt:.1f} TB trials/s, "
          f"{steps * BATCH * cfg.n_harq_rounds / dt:.1f} processed "
          f"subframes/s ({steps} steps of {BATCH} x {cfg.n_harq_rounds} "
          f"rounds, {dt:.3f} s)", flush=True)
    print(f"launches over the dd 1x2 runs: {counts}", flush=True)
    if not 0.02 <= bler[0] <= 0.98:
        raise AssertionError(f"dd 1x2 round-0 BLER {bler[0]} outside "
                             "[0.02, 0.98]")
    if not errs[1] < errs[0]:
        raise AssertionError(f"dd 1x2: no HARQ gain {errs}")
    if sim.dci_miss > 0.01 * reach[0]:
        raise AssertionError(f"dd 1x2: {sim.dci_miss} DCI misses")
    if min(counts["mrc_llr"], counts["turbo_half_iter"]) == 0:
        raise AssertionError(f"a kernel of the dd 1x2 path never launched: "
                             f"{counts}")
    return counts, (sim, snr)


# The SISO fidelity anchors (the JAX package's, taken on a TPU): name,
# config, [(SNR, trials, round-0 band as a fraction of the trials)], and
# the condition the later rounds' (errs, bler) must meet, if any.
_ANCHORS = [
    ("test_bler_anchor: MCS 4 estimated-CE waterfall",
     dict(mcs=4, n_rb=25, channel="AWGN", n_harq_rounds=1),
     [(-2.6, 256, (0.9, 1.0)), (-1.8, 256, (0.2, 0.8)),
      (-1.0, 256, (0.0, 0.1))], None),
    ("test_bler_anchor: MCS 4 perfect CE",
     dict(mcs=4, n_rb=25, channel="AWGN", n_harq_rounds=1, perfect_ce=True),
     [(0.6, 256, (0.0, 0.0))], None),
    ("test_bler_anchor: corpus test 5, 6 PRB MCS 4 EVA 1x2 joint",
     dict(mcs=4, n_rb=6, channel="EVA", n_pdcch_symbols=3, n_rx=2,
          n_harq_rounds=2, snr_convention="dlsim", est_mode="joint"),
     [(-1.6, 256, (0.05, 0.37))], lambda e, b: e[1] < e[0]),
    ("test_bler_anchor: ETU HARQ ordering, 6 PRB MCS 10 1x2 joint",
     dict(mcs=10, n_rb=6, channel="ETU", n_pdcch_symbols=3, n_rx=2,
          n_harq_rounds=4, snr_convention="dlsim", est_mode="joint"),
     [(-4.0, 256, (0.6, 1.0))],
     lambda e, b: b[1] < b[0] and b[2] < b[1] and e[3] <= e[2]),
] + [(f"test_bler_anchor: AWGN ladder MCS {m}",
      dict(mcs=m, n_rb=25, channel="AWGN", n_harq_rounds=1,
           est_mode="interp", snr_convention="dlsim"),
      [(lo, 256, (0.8, 1.0)), (mid, 256, (0.15, 0.85)),
       (hi, 256, (0.0, 0.12))], None)
     for m, lo, mid, hi in ((2, -4.4, -4.0, -3.4), (9, 1.7, 2.0, 2.3),
                            (13, 4.7, 5.0, 5.3), (17, 8.1, 8.4, 8.8),
                            (21, 10.9, 11.2, 11.6), (27, 15.5, 15.8, 16.3))
] + [
    ("test_fading: HARQ gain, 6 PRB MCS 10 EVA, 3 rounds",
     dict(mcs=10, n_rb=6, channel="EVA", batch=32, n_turbo_iter=4,
          n_harq_rounds=3),
     [(6.0, 64, (0.0, 1.0))],
     lambda e, b: b[1] < b[0] and (b[2] <= b[1] + 0.1 or e[-1] <= 1)),
    ("test_fading: dd corpus anchor, 50 PRB MCS 26 EVA 1x2 (ref 0.337)",
     dict(mcs=26, n_rb=50, channel="EVA", n_pdcch_symbols=2, n_rx=2,
          n_harq_rounds=1, snr_convention="dlsim", est_mode="dd"),
     [(14.6, 256, (0.0, 0.427))], None),
    ("fading corpus test 6, 50 PRB MCS 15 EVA 1x2 dd (JAX 942/2048)",
     dict(mcs=15, n_rb=50, channel="EVA", n_pdcch_symbols=2, n_rx=2,
          n_harq_rounds=4, snr_convention="dlsim", est_mode="dd"),
     [(4.6, 2048, (0.409, 0.511))], None),
    ("fading corpus test 11, 50 PRB MCS 26 EVA 1x2 dd (JAX 683/2048)",
     dict(mcs=26, n_rb=50, channel="EVA", n_pdcch_symbols=2, n_rx=2,
          n_harq_rounds=4, snr_convention="dlsim", est_mode="dd"),
     [(14.6, 2048, (0.285, 0.382))], None),
    ("Doppler corpus, 25 PRB MCS 10 EVA 200 Hz interp (JAX 524/4096)",
     dict(mcs=10, n_rb=25, channel="EVA", n_harq_rounds=1,
          intra_doppler_hz=200.0, n_turbo_iter=6, batch=256),
     [(8.0, 2048, (0.098, 0.158))], None),
]


def fidelity_anchors(dev) -> None:
    """Every SISO anchor of the JAX package's tests and corpus campaigns,
    with the same configurations, trial counts and bands, on the card
    (batch 128 unless the anchor's campaign used another)."""
    for name, case, points, later in _ANCHORS:
        cfg = DlsimFadingConfig(**{"batch": BATCH, **case})
        sim = DlsimFading(cfg, device=dev)
        t0 = time.perf_counter()
        txt = []
        for snr, n, (lo, hi) in points:
            errs, reach = sim.run_snr(snr, n, seed=0)
            b0 = errs[0] / reach[0]
            txt.append(f"{snr} dB r0 {b0:.4f} ({errs[0]}/{reach[0]}) in "
                       f"[{lo}, {hi}]")
            if not (reach[0] == n and lo <= b0 <= hi):
                raise AssertionError(f"{name} at {snr} dB: round-0 BLER "
                                     f"{b0} ({errs}/{reach}) outside "
                                     f"[{lo}, {hi}]")
            if cfg.n_harq_rounds > 1:
                bler = errs / np.maximum(reach, 1)
                txt[-1] += f", rounds {[round(float(x), 4) for x in bler]}"
                if later is not None and not later(errs, bler):
                    raise AssertionError(f"{name}: later rounds {errs} "
                                         f"of {reach}")
        print(f"anchor {name}: {'; '.join(txt)}; DCI misses {sim.dci_miss}"
              f" ({time.perf_counter() - t0:.1f} s)", flush=True)


def entry_point(dev) -> int:
    """DlsimAwgn at bench.py's second configuration (25 PRB, MCS 4, batch
    512, 8 iterations, 1 dB), then the dlsim command line on the card for
    -g EVA -r 4 and for -x 2, each writing its CSV under build/."""
    sim = DlsimAwgn(DlsimConfig(mcs=4, n_rb=25, batch=512, n_turbo_iter=8),
                    device=dev)
    sim.run_snr(1.0, 512, seed=9)                # settle the allocator
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    errs, trials = sim.run_snr(1.0, 4 * 512, seed=1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_turbo = launch_counts()["turbo_half_iter"]
    print(f"DlsimAwgn 25 PRB MCS 4 at 1 dB: BLER {errs / trials:.4f} "
          f"({errs}/{trials}), {trials / dt:.1f} subframes/s (4 steps of "
          f"512, {dt:.3f} s), turbo launches {n_turbo}", flush=True)
    if errs > 0.01 * trials or n_turbo == 0:
        raise AssertionError(f"DlsimAwgn: BLER {errs}/{trials}, turbo "
                             f"launches {n_turbo}")
    os.makedirs("build", exist_ok=True)
    for argv, n_pairs in ((["-g", "EVA", "-r", "4", "-m", "10", "-B", "25",
                            "-s", "6", "-S", "8", "-i", "2"], 4),
                          (["-x", "2", "-m", "10", "-B", "25", "-s", "8",
                            "-S", "8"], 1)):
        path = f"build/dlsim_{'x2' if '-x' in argv else 'eva'}.csv"
        rows = dlsim_main(argv + ["-n", "256", "-b", "128", "-o", path,
                                  "--device", "cuda"])
        with open(path) as f:
            lines = f.read().splitlines()
        for line in lines:
            cols = line.split(";")
            if len(cols) != 4 + 2 * n_pairs + 1 or cols[1] != "10" \
                    or int(cols[5]) != 256:
                raise AssertionError(f"{path}: row {line!r} is not "
                                     f"SNR;MCS;TBS;rate;(err;trials)x"
                                     f"{n_pairs};dci_err")
        if len(lines) != len(rows) or not lines:
            raise AssertionError(f"{path}: {len(lines)} rows for "
                                 f"{len(rows)} sweep points")
        print(f"dlsim {' '.join(argv)} --device cuda: {path} "
              f"{lines}", flush=True)
    return n_turbo


def _phase(n: int, title: str, fn, *args):
    """Run one phase, with its number, title and seconds printed."""
    print(f"== phase {n}: {title}", flush=True)
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"== phase {n} done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


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
        elif ("registers" in line or "spill" in line) and name:
            print(f"  ptxas {name}: {line.split(':', 1)[-1].strip()}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    timings = []          # device times, taken in phase 16
    torch.cuda.reset_peak_memory_stats()
    turbo = _phase(3, "turbo v2 kernel", check_turbo, dev, gen, timings)
    mrc = _phase(3, "mrc_llr kernel", check_mrc, dev, gen, timings)
    print(f"phase 3 peak device memory {torch.cuda.max_memory_allocated()} "
          "bytes (the plain versions' included)", flush=True)
    _phase(4, "small input, card against CPU", check_small_input, dev)
    counts, flagship_steps = _phase(5, "flagship", flagship, dev)
    demap = _phase(6, "demap_llr kernel", check_demap, dev, gen, timings)
    turbo_v1, n_v1, v1_call = _phase(7, "turbo v1 kernel", check_turbo_v1,
                                     dev, gen, timings)
    _phase(8, "small multi-antenna inputs", check_small_mimo, dev)
    n_demap = _phase(9, "TM2 anchor", tm2_anchor, dev) \
        + _phase(10, "TM3 full width", tm3_full_width, dev)
    mrc.update(_phase(11, "mrc_llr at A = 2", check_mrc_a2, dev, gen,
                      timings))
    _phase(12, "small SISO inputs, card against CPU", check_small_siso, dev)
    dd, dd_sim = _phase(13, "dd 1x2 HARQ full width", dd_full_width, dev)
    _phase(14, "SISO fidelity anchors", fidelity_anchors, dev)
    n_awgn_turbo = _phase(15, "DlsimAwgn and the dlsim command line",
                          entry_point, dev)
    _phase(16, "device time of each kernel", device_times, timings, v1_call,
           dd_sim)

    per_step = {k: v / flagship_steps for k, v in counts.items()}
    rows = [
        dict(name="turbo_half_iter", route="cuda",
             source="openair4g_tpu_torch/csrc/turbo_half_iter.cu",
             replaces="openair4g_tpu/ops/turbo_pallas.py:219",
             launches=counts["turbo_half_iter"] + dd["turbo_half_iter"]
             + n_awgn_turbo, launches_per_step=per_step["turbo_half_iter"],
             **turbo),
        dict(name="turbo_half_iter_v1", route="cuda",
             source="openair4g_tpu_torch/csrc/turbo_half_iter.cu",
             replaces="openair4g_tpu/ops/turbo_pallas.py:70",
             launches=n_v1, launches_per_step=per_step["turbo_half_iter_v1"],
             **turbo_v1),
        dict(name="mrc_llr", route="cuda",
             source="openair4g_tpu_torch/csrc/mrc_llr.cu",
             replaces="openair4g_tpu/ops/equalize_llr.py:40",
             launches=counts["mrc_llr"] + dd["mrc_llr"],
             launches_per_step=per_step["mrc_llr"], **mrc),
        dict(name="demap_llr", route="cuda",
             source="openair4g_tpu_torch/csrc/mrc_llr.cu",
             replaces="openair4g_tpu/ops/equalize_llr.py:138",
             launches=n_demap, launches_per_step=per_step["demap_llr"],
             **demap),
    ]
    for row in rows:        # no one PyTorch call computes any of these
        row["library_ms"] = None
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
