#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (openair4g_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. the card's name and power limit, torch and CUDA versions;
  2. build both hand-written kernels from openair4g_tpu_torch/csrc/ for
     sm_90a into build/kernels/;
  3. each kernel against its plain PyTorch version on the card at the
     20 MHz flagship shapes (max |diff| against the stated tolerance, time
     of each by CUDA events);
  4. the small-input check: 25 PRB round 0 on the card (kernels) and on
     the CPU (plain versions) with the same injected draws must agree;
  5. the flagship: DlsimFading round 0, 100 PRB MCS 26, EVA, joint
     estimation, batch 128, 8 turbo iterations, drawn on the card. At
     26 dB every TB and every DCI must decode; at 24 dB TBs must decode
     and BLER and subframes/s are printed. Both kernels' launch counts
     over these runs must be non-zero.
Ends with a JSON line of the kernels, then the device JSON line.
It needs a CUDA device and imports nothing of JAX.
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
from openair4g_tpu_torch.ops.equalize_llr import mrc_llr, mrc_llr_ref
from openair4g_tpu_torch.ops.turbo_cuda import (half_iteration,
                                                half_iteration_ref)
from openair4g_tpu_torch.sim.dlsim import DlsimFading, DlsimFadingConfig

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
    if min(counts.values()) == 0:
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    return counts


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
        m = re.search(r"(turbo_half_iter_kernel|mrc_llr_kernel)I((?:Li\d+E)+)",
                      line)
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

    rows = [
        dict(name="turbo_half_iter", route="cuda",
             source="openair4g_tpu_torch/csrc/turbo_half_iter.cu",
             replaces="openair4g_tpu/ops/turbo_pallas.py:219",
             launches=counts["turbo_half_iter"], **turbo),
        dict(name="mrc_llr", route="cuda",
             source="openair4g_tpu_torch/csrc/mrc_llr.cu",
             replaces="openair4g_tpu/ops/equalize_llr.py:40",
             launches=counts["mrc_llr"], **mrc),
    ]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
