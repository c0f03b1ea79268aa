"""Carrier scan: find cells across a grid of coarse frequency offsets
(counterpart of openair4g_tpu/sim/scansim.py). Each frequency hypothesis
de-rotates the capture and runs the batched cell search; the strongest
PSS correlation across hypotheses wins, and the PSS halves estimate the
residual fine CFO at the winner.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import FrameParms
from ..device import resolve_device
from ..phy.sync import CellSearch, estimate_cfo


@dataclass(frozen=True)
class ScanConfig:
    n_rb: int = 25
    # coarse frequency hypotheses, in subcarrier spacings
    freq_hyps: tuple = (-2.0, -1.0, 0.0, 1.0, 2.0)


class CarrierScan:
    def __init__(self, cfg: ScanConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.fp = FrameParms(n_rb=cfg.n_rb)
        self.search = CellSearch(self.fp)

    def scan(self, cap):
        """cap [B, L] complex captures -> dict of [B] tensors on the
        simulator's device: nid1, nid2, pss_pos, half of the best
        hypothesis, hyp (its index), coarse_cfo and fine_cfo (subcarrier
        spacings)."""
        fp, dev = self.fp, self.device
        cap = torch.as_tensor(cap, device=dev).to(torch.complex64)
        t = torch.arange(cap.shape[-1], device=dev)
        res_by_h = [self.search.search(
            cap * torch.exp(-2j * np.pi * f / fp.n_fft * t))
            for f in self.cfg.freq_hyps]
        best = torch.argmax(torch.stack([r["peak"] for r in res_by_h]),
                            dim=0)                        # [B]
        out = {k: torch.stack([r[k] for r in res_by_h]).gather(
            0, best[None])[0] for k in ("nid1", "nid2", "pss_pos", "half")}
        out["hyp"] = best
        out["coarse_cfo"] = torch.as_tensor(
            np.asarray(self.cfg.freq_hyps, np.float32), device=dev)[best]
        derot = cap * torch.exp(-2j * np.pi / fp.n_fft
                                * out["coarse_cfo"][:, None] * t[None, :])
        out["fine_cfo"] = estimate_cfo(derot, out["pss_pos"], out["nid2"],
                                       fp.n_fft)
        return out
