"""The port's bench (counterpart of the repo's bench.py): its four cells on
one card.

    python3 -m openair4g_tpu_torch.bench [--device cuda]

Cells, at bench.py's sizes, window counts and best-of-windows:

- pdsch_20mhz_mcs26_fading_estce_subframes_per_s (bench.py:50-81): the
  flagship, DlsimFading 100 PRB, MCS 26, EVA, 1 RX, joint CE, 1 HARQ
  round, batch 128, 8 turbo iterations, 24 dB, the format-1A DCI
  blind-decoded every trial; 3 windows of 10 steps.
- pdsch_5mhz_mcs4_awgn_subframes_per_s (bench.py:85-106): DlsimAwgn 25
  PRB, MCS 4, batch 512, 8 iterations, 1 dB; 3 windows of 20 steps.
- turbo_decode_mbit_per_s (bench.py:123-146): DlschCodec(MCS 10, 50 PRB,
  8 iterations) decoding batch 512 of LLRs (1 - 2e) 4 + N(0, 1). TBS 7,992
  segments into 2 blocks of K = 4,032 (not K = 6,144, as bench.py's
  docstring says), so one decode is one launch of the decode kernel on
  1,024 rows of N = 4,080 (17 windows of W = 240), between one of the
  de-rate-matching kernel and one of the TB check. Two numbers:
  fixed_8iter (dynamic_stop off: every row reports 8 iterations, but a
  row whose CRC has passed skips the rest of its work, its outputs being
  fixed, so the kernel does about the work of the other cell) and
  earlystop_operating (each row leaves at its CRC latch); 3 windows of 5
  decodes each. Beside them, the decode's launches, and the iterations
  its rows ran, read from the device after the timed windows.
- ofdm_equalize_msamples_per_s (bench.py:149-201): at 100 PRB, batch 32,
  one pass is a draw of noise samples, OFDM demodulation, the joint
  estimate, data-RE extraction, MRC equalization and the plain 16QAM
  demap (no kernel of the repo: cuFFT, cuBLAS and torch); a timed call is
  32 passes, 3 windows of 2 calls.

Each window is timed on the host clock between torch.cuda.synchronize()
calls, after one warm-up step (the launch counts are read, never reset);
the stage timers of utils/profiler, which wait for the device once a
round, are off while a cell runs (bench.py times the jitted programs,
which have none). After every cell has run, one torch.profiler window of
2 steps a cell, after 2 unrecorded ones, gives its device ms a step. One JSON line a cell (value = best window,
the median window, every window's seconds, device ms a step, launches by
kernel and by shape over the timed windows, the card's name and power
limit), then a last line with bench.py's keys (metric, value, unit,
vs_baseline = flagship subframes/s over the reference's real-time 1,000)
and the other three cells under "extras". It writes no file.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from contextlib import contextmanager

import numpy as np
import torch

from .config import FrameParms
from .convert import from_packed
from .device import card_name, cli_device, launch_shapes, resolve_device
from .ops.llr import demap_llr
from .phy import ofdm
from .phy.channel_est import estimate_channel_joint, make_wiener_joint
from .phy.equalize import mrc_equalize
from .phy.pdsch import DlschCodec, DlschConfig
from .phy.resource_grid import extract_data_res, make_grid_map
from .sim.dlsim import DlsimAwgn, DlsimConfig, DlsimFading, DlsimFadingConfig
from .utils import profiler
from .utils.tracing import profile_calls

METRIC = "pdsch_subframes_per_s_per_chip(mcs26_100prb_EVA_estCE_8iter)"
REAL_TIME_SUBFRAMES_PER_S = 1000.0     # 1 subframe / 1 ms (BASELINE.md)
PROFILED_STEPS = 2


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextmanager
def stage_timers_off():
    profiler.enable(False)
    try:
        yield
    finally:
        profiler.enable(True)


def time_windows(step, dev, n_rep: int, windows: int) -> tuple:
    """(host seconds of each of `windows` windows of n_rep calls of step,
    each between device syncs, after one warm-up call; the windows'
    kernel launches by (kernel, shape))."""
    step()
    _sync(dev)
    before = launch_shapes()
    out = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(n_rep):
            step()
        _sync(dev)
        out.append(time.perf_counter() - t0)
    after = launch_shapes()
    return out, {k: v - before.get(k, 0) for k, v in after.items()
                 if v > before.get(k, 0)}


def _launches(shapes: dict, per: int = 1) -> dict:
    """The launches by kernel and by "kernel [shape]" of shapes, each
    over `per` calls."""
    by_kernel = {}
    for (name, _), n in shapes.items():
        by_kernel[name] = by_kernel.get(name, 0) + n / per
    return {"launches": by_kernel,
            "launch_shapes": {f"{name} {list(key)}": n / per
                              for (name, key), n in shapes.items()}}


def _rates(work: float, secs: list) -> dict:
    """work units a window over each window's seconds: the best (value)
    and the median."""
    return {"value": work / min(secs),
            "median": work / statistics.median(secs), "windows_s": secs}


def device_ms(step, dev, n: int = PROFILED_STEPS):
    """Device ms a call of step, summed over every device-side event of n
    calls in one torch.profiler window; None on the CPU (no device)."""
    if dev.type != "cuda":
        return None
    events, _ = profile_calls(step, n)
    return sum(us for _, us in events.values()) / n / 1e3


def flagship(device=None, batch: int = 128, n_rep: int = 10,
             windows: int = 3, n_rb: int = 100, seed: int = 0):
    """Subframes/s of the 20 MHz flagship round 0. Returns (row, {label:
    step}) with the step for device_ms."""
    dev = resolve_device(device)
    sim = DlsimFading(DlsimFadingConfig(
        mcs=26, n_rb=n_rb, channel="EVA", n_rx=1, n_harq_rounds=1,
        batch=batch, est_mode="joint", n_turbo_iter=8), device=dev)
    snr = 24.0
    n0 = np.float32(10.0 ** (-snr / 10.0))
    W, ev = sim.wiener(snr), sim.err_var(snr)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def step():
        return sim.step(gen, n0, W, ev).rounds[0].ok

    with stage_timers_off():
        ok0 = int(step().sum())
        if ok0 == 0:
            raise AssertionError("20 MHz chain not decoding at bench SNR")
        secs, shapes = time_windows(step, dev, n_rep, windows)
    row = {"cell": "pdsch_20mhz_mcs26_fading_estce_subframes_per_s",
           "unit": "subframes/s", **_rates(n_rep * batch, secs),
           "first_step_tbs_ok": ok0, "batch": batch, "n_rep": n_rep,
           "windows": windows, **_launches(shapes)}
    return row, {"step": step}


def awgn(device=None, batch: int = 512, n_rep: int = 20, windows: int = 3,
         seed: int = 0):
    """Subframes/s of DlsimAwgn 25 PRB MCS 4 at 1 dB."""
    dev = resolve_device(device)
    sim = DlsimAwgn(DlsimConfig(mcs=4, n_rb=25, batch=batch, n_turbo_iter=8),
                    device=dev)
    n0 = np.float32(10.0 ** (-1.0 / 10.0))
    gen = torch.Generator(device=dev).manual_seed(seed)
    last = []

    def step():
        ok = sim.step(gen, n0).ok
        last[:] = [ok]
        return ok

    with stage_timers_off():
        secs, shapes = time_windows(step, dev, n_rep, windows)
    ok_last = int(last[0].sum())
    if ok_last == 0:
        raise AssertionError("DlsimAwgn decodes no TB at 1 dB")
    row = {"cell": "pdsch_5mhz_mcs4_awgn_subframes_per_s",
           "unit": "subframes/s", **_rates(n_rep * batch, secs),
           "last_step_tbs_ok": ok_last, "batch": batch, "n_rep": n_rep,
           "windows": windows, **_launches(shapes)}
    return row, {"step": step}


def turbo_inputs(codec: DlschCodec, batch: int, dev, seed: int = 7):
    """(TB bits [batch, TBS], LLRs (1 - 2e) 4 + N(0, 1) [batch, G]) drawn
    on dev from one seeded generator."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    tb = torch.randint(0, 2, (batch, codec.cfg.tbs), generator=gen,
                       device=dev, dtype=torch.int32)
    e = codec.encode(tb)
    llr = (1.0 - 2.0 * e.to(torch.float32)) * 4.0 \
        + torch.randn(e.shape, generator=gen, device=dev)
    return tb, llr


def turbo(device=None, batch: int = 512, n_rep: int = 5, windows: int = 3,
          mcs: int = 10, n_rb: int = 50):
    """Turbo decode Mbit/s of DlschCodec.decode, with dynamic_stop off
    (fixed_8iter: 8 iterations reported a row, the work skipped after a
    row's CRC passes) and on (earlystop_operating)."""
    dev = resolve_device(device)
    codec = DlschCodec(DlschConfig(mcs=mcs, n_rb=n_rb, n_turbo_iter=8))
    tb, llr = turbo_inputs(codec, batch, dev)
    bits = batch * codec.cfg.tbs
    row = {"cell": "turbo_decode_mbit_per_s", "unit": "Mbit/s",
           "value": {}, "median": {}, "windows_s": {}, "launches": {},
           "launch_shapes": {}, "tbs_ok": {}, "iterations": {},
           "batch": batch, "n_rep": n_rep,
           "windows": windows, "tbs": codec.cfg.tbs,
           "block_sizes": codec.block_Ks}
    steps = {}
    for name, dyn in (("fixed_8iter", False), ("earlystop_operating", True)):
        def step(dyn=dyn):
            return codec.decode(llr, dynamic_stop=dyn)[:2]

        secs, shapes = time_windows(step, dev, n_rep, windows)
        launched = _launches(shapes, n_rep * windows)
        ran = []
        tb_hat, ok = codec.decode(llr, dynamic_stop=dyn, iters=ran)[:2]
        ran = torch.cat([n for _, n in ran]).double()
        row["iterations"][name] = {"mean": ran.mean().item(),
                                   "max": int(ran.max().item())}
        if not torch.equal(tb_hat[ok], tb[ok]):
            raise AssertionError(f"turbo cell {name}: a TB passed its CRC "
                                 "with wrong bits")
        rates = _rates(n_rep * bits / 1e6, secs)
        for k in ("value", "median", "windows_s"):
            row[k][name] = rates[k]
        row["tbs_ok"][name] = int(ok.sum())
        row["launches"][name] = launched["launches"]
        row["launch_shapes"][name] = launched["launch_shapes"]
        steps[name] = step
    row["launches_are"] = "a decode call"
    return row, steps


class FrontEnd:
    """The 20 MHz inner-receiver front end of bench.py's last cell: OFDM
    demodulation, the joint estimate (n0 = 0.1), data-RE extraction, MRC
    equalization over one antenna and the plain 16QAM max-log demap."""

    def __init__(self, n_rb: int, dev, n0: float = 0.1):
        self.fp = FrameParms(n_rb=n_rb)
        self.gm = make_grid_map(n_rb, 1)
        self.n0 = n0
        self.W = from_packed(make_wiener_joint(self.gm, n0), dev)
        self.ds = torch.as_tensor(np.asarray(self.gm.data_sym), device=dev)
        self.dc = torch.as_tensor(np.asarray(self.gm.data_sc), device=dev)

    def llrs(self, t):
        """time samples [B, samples_per_tti] complex64 -> LLRs
        [B, n_data, 4]."""
        rgrid = ofdm.ofdm_demodulate(t, self.fp)
        H = estimate_channel_joint(rgrid, self.gm, self.W)
        y = extract_data_res(rgrid, self.gm)
        h = H[:, self.ds, self.dc]
        x, n0e = mrc_equalize(y[..., None], h[..., None], self.n0)
        return demap_llr(x, n0e, 4)


def front_end(device=None, batch: int = 32, n_rep: int = 2,
              windows: int = 3, reps: int = 32, n_rb: int = 100,
              seed: int = 3):
    """Msamples/s of the front end: a timed call is `reps` passes, each on
    fresh noise samples drawn on the device."""
    dev = resolve_device(device)
    fe = FrontEnd(n_rb, dev)
    S = fe.fp.samples_per_tti
    gen = torch.Generator(device=dev).manual_seed(seed)

    def step():
        acc = torch.zeros((), device=dev)
        for _ in range(reps):
            nr = torch.randn(batch, S, 2, generator=gen, device=dev)
            acc = acc + fe.llrs(torch.complex(nr[..., 0], nr[..., 1])
                                ).abs().sum()
        return acc

    secs, shapes = time_windows(step, dev, n_rep, windows)
    total = float(step())
    if not np.isfinite(total):
        raise AssertionError(f"front end: LLR sum {total}")
    row = {"cell": "ofdm_equalize_msamples_per_s", "unit": "Msamples/s",
           **_rates(n_rep * reps * batch * S / 1e6, secs), "batch": batch,
           "n_rep": n_rep, "windows": windows, "passes_a_call": reps,
           **_launches(shapes)}
    return row, {"step": step}


CELLS = (flagship, awgn, turbo, front_end)


def run(device=None, sizes: dict | None = None) -> list:
    """Every cell at bench.py's sizes (or `sizes[cell name]`, keyword
    arguments of the cell's function), then each cell's device ms a step;
    returns the rows, each with the card's name."""
    dev = resolve_device(device)
    sizes = sizes or {}
    done = [cell(dev, **sizes.get(cell.__name__, {})) for cell in CELLS]
    name = card_name(dev)
    rows = []
    for row, steps in done:
        ms = {label: device_ms(step, dev) for label, step in steps.items()}
        row["device_ms_per_step"] = ms["step"] if "step" in ms else ms
        row["card"] = name
        rows.append(row)
    return rows


def last_line(rows: list) -> dict:
    """bench.py's line: the flagship's subframes/s, vs_baseline against
    real time, the other cells' values under extras."""
    sf20 = rows[0]["value"]
    return {"metric": METRIC, "value": round(sf20, 1), "unit": "subframes/s",
            "vs_baseline": round(sf20 / REAL_TIME_SUBFRAMES_PER_S, 3),
            "extras": {row["cell"]: row["value"] for row in rows[1:]}}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="the port's bench: bench.py's "
                                "four cells on one card")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; never falls back)")
    a = p.parse_args(argv)
    dev = cli_device("bench", a.device)
    rows = run(dev)
    for row in rows:
        print(json.dumps(row), flush=True)
    line = last_line(rows)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
