"""framegen: LTE downlink frame waveform generator (counterpart of
openair4g_tpu/sim/framegen.py).

    python3 -m openair4g_tpu_torch.sim.framegen -B 100 -o frame.npy
    python3 -m openair4g_tpu_torch.sim.framegen -B 6 --device cpu

Reference parity: openair1/SIMULATION/LTE_PHY/framegen.c: a
standards-compliant DL frame waveform (PSS/SSS/PBCH/pilots + optional
PDSCH filler) for driving signal generators and offline receivers.

The ten subframe grids are built on the host (subframe 0 through
sched/enb_tx.EnbTx.sync_subframe_host); their OFDM modulation is one
batched IFFT on `device` (None: the card). The waveform is written as .npy
and, on request, in the reference's Octave write_output format.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..config import FrameParms
from ..device import cli_device
from ..phy import ofdm
from ..phy.resource_grid import make_grid_map
from ..phy.sync import center62_bins, pss_sequence, sss_sequence
from ..sched.enb_tx import CellConfig, EnbTx
from ..utils.octave_io import write_output


def generate_frame(cell: CellConfig, sfn: int = 0, fill_pdsch: bool = False,
                   seed: int = 0, device=None) -> np.ndarray:
    """One 10 ms frame [samples] (complex64): subframe 0 carries
    PSS/SSS/PBCH, subframe 5 carries PSS/SSS; all subframes carry pilots;
    optionally random-QPSK PDSCH filler (numpy's default_rng(seed)) on
    every data RE."""
    enb = EnbTx(cell, device)
    fp = enb.fp
    rng = np.random.default_rng(seed)
    nid1, nid2 = cell.n_id_cell // 3, cell.n_id_cell % 3
    bins62 = center62_bins(fp)
    qpsk = np.array([1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j],
                    np.complex64) / np.sqrt(2)
    grids = np.zeros((10, fp.symbols_per_subframe, fp.n_fft), np.complex64)
    grids[0] = enb.sync_subframe_host(sfn=sfn)
    for sf in range(1, 10):
        gm = make_grid_map(cell.n_rb, cell.n_pdcch, cell.n_id_cell,
                           subframe=sf)
        grids[sf, gm.pilot_sym, gm.pilot_bin] = gm.pilot_val
        if sf == 5:
            grids[sf, 5, bins62] = sss_sequence(nid1, nid2, True)
            grids[sf, 6, bins62] = pss_sequence(nid2)
        if fill_pdsch:
            q = rng.integers(0, 4, gm.n_data_re)
            grids[sf, gm.data_sym, gm.data_bin] = qpsk[q]
    t = ofdm.ofdm_modulate(torch.as_tensor(grids, device=enb.device), fp)
    return t.reshape(-1).cpu().numpy()


def main(argv=None):
    p = argparse.ArgumentParser(description="DL frame waveform generator")
    p.add_argument("-B", "--n-rb", type=int, default=25)
    p.add_argument("-N", "--n-id-cell", type=int, default=0)
    p.add_argument("--sfn", type=int, default=0)
    p.add_argument("--pdsch", action="store_true")
    p.add_argument("-o", "--out", default="frame.npy")
    p.add_argument("--octave", default=None,
                   help="also dump as Octave .m (write_output format)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; never falls back)")
    a = p.parse_args(argv)
    dev = cli_device("framegen", a.device)
    # the allocation does not reach the frame (no PDCCH is sent); n_prb =
    # n_rb lets every bandwidth build its EnbTx
    cell = CellConfig(n_rb=a.n_rb, n_id_cell=a.n_id_cell, n_prb=a.n_rb)
    wave = generate_frame(cell, sfn=a.sfn, fill_pdsch=a.pdsch, device=dev)
    np.save(a.out, wave)
    print(f"wrote {len(wave)} samples ({len(wave) / 15360 / 2:.1f} ms at "
          f"{FrameParms(n_rb=a.n_rb).sample_rate_hz / 1e6:.2f} Msps) "
          f"-> {a.out}")
    if a.octave:
        write_output(a.octave, "txs", wave)
    return wave


if __name__ == "__main__":
    main()
