"""PDCCH-granted PUSCH loop (counterpart of openair4g_tpu/sim/ulgrantsim.py):
DCI format 0 UL grant -> UE blind decode -> granted PUSCH transmission ->
eNB decode -> HARQ rv cycling.

Reference parity: the closed scheduling loop of the softmodem. eNB TX
sends the format-0 grant on the PDCCH (generate_dci_top,
openair1/PHY/LTE_TRANSPORT/dci.c), the UE finds it by blind search
(dci_decoding_procedure0 :2547) and derives its PUSCH parameters
(generate_ue_ulsch_params_from_dci, dci_tools.c), transmits in subframe
n+4 (phy_procedures_UE_TX, phy_procedures_lte_ue.c:931-996), and the eNB
decodes and runs HARQ (phy_procedures_eNB_RX :3196, process_HARQ_feedback
:2658). A missed or corrupted grant means the UE stays silent that TTI
(DTX), counted like dlsim's DCI-error column (dlsim.c:3011-3023).

The grant is static per configuration, so every RE map is built once; the
UE's acceptance of the grant (blind-decode success, payload match, format
flag) is a per-trial mask on its waveform. The ACK/NACK routing between
rounds is ideal (the noisy PHICH is FullChainSim's). `trial` takes every
draw injected (the DL noise, TB bits, per round the UL noise); `step`
draws them on the simulator's device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..convert import wiener_stack_from_reference
from ..device import device_plan, resolve_device
from ..ops.llr import demap_llr
from ..phy import ofdm
from ..phy.channel_est import estimate_channel, make_wiener_stack
from ..phy.dci_formats import (dci_format0_size, pack_dci_format0,
                               unpack_dci_format0)
from ..phy.pdcch import dci_blind_decode, search_space_candidates
from ..sched.enb_rx import EnbRx
from ..sched.enb_tx import CellConfig, EnbTx, _long
from ..sched.ue_rx import _signs
from ..sched.ue_tx import UeTx, UeUlConfig
from .dlsim import _noise

RV_SEQ = (0, 2, 3, 1)     # 36.321 rv cycling for UL HARQ retransmissions


@dataclass(frozen=True)
class UlGrantConfig:
    """The reference's UlGrantConfig fields and defaults, plus
    decoder_window (None: 96 on the CPU, 240 on a card)."""
    n_rb: int = 25
    mcs_ul: int = 10
    rb_offset: int = 2
    n_prb: int = 20
    rnti: int = 0x1234
    n_id_cell: int = 0
    n_pdcch: int = 3
    dci_L: int = 4
    dl_subframe: int = 0      # grant TTI; PUSCH goes out in n+4
    n_harq_rounds: int = 4
    n_turbo_iter: int = 6
    batch: int = 64
    decoder_window: int | None = None


class UlGrantResult(NamedTuple):
    grant_ok: torch.Tensor    # [B] the UE accepted the grant
    ok: torch.Tensor          # [R, B] the eNB decoded the TB in round r
    dci_errs: torch.Tensor    # trials whose grant was missed
    errs: torch.Tensor        # [R] trials that reached round r and failed it
    reach: torch.Tensor       # [R] trials that reached round r


class UlGrantSim:
    """eNB grant -> UE PUSCH -> eNB decode, batched over trials, on
    `device` (None: the card)."""

    def __init__(self, cfg: UlGrantConfig, device=None):
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        # --- eNB DL control subframe carrying the format-0 grant --------
        self.cell = CellConfig(
            n_rb=cfg.n_rb, n_id_cell=cfg.n_id_cell, n_pdcch=cfg.n_pdcch,
            rnti=cfg.rnti, rb_start=cfg.rb_offset, n_prb=cfg.n_prb,
            mcs=cfg.mcs_ul, dci_L=cfg.dci_L, subframe=cfg.dl_subframe)
        self.enb_tx = EnbTx(self.cell, dev)
        self.grant_payload = pack_dci_format0(
            cfg.n_rb, rb_start=cfg.rb_offset, n_prb=cfg.n_prb,
            mcs=cfg.mcs_ul, ndi=1)
        self.enb_tx.set_dci_payload(self.grant_payload)
        self.fp = self.enb_tx.fp
        # the DL subframe carries the control region only: the same
        # waveform in every trial
        self._t_dl = self.enb_tx.data_waveform(torch.zeros(
            1, self.enb_tx.am.n_data_re, dtype=torch.complex64, device=dev))

        # --- UE side: control receiver + granted PUSCH transmitter ------
        self.gm = self.enb_tx.gm
        self.crm = self.enb_tx.crm
        self.candidates = search_space_candidates(self.crm.n_cce)
        self.dci_len = dci_format0_size(cfg.n_rb)
        if len(self.grant_payload) != self.dci_len:
            raise ValueError("format 0 payload of the wrong size")
        grant = unpack_dci_format0(self.grant_payload, cfg.n_rb)
        if not grant["is_format0"]:
            raise ValueError("the grant does not parse as format 0")
        # the UE configures its TX from the PARSED grant fields
        self.ue_tx = UeTx(UeUlConfig(
            n_rb=cfg.n_rb, mcs=grant["mcs"], n_rb_alloc=grant["n_prb"],
            rb_offset=grant["rb_start"], rnti=cfg.rnti,
            n_id_cell=cfg.n_id_cell, subframe=(cfg.dl_subframe + 4) % 10,
            n_turbo_iter=cfg.n_turbo_iter,
            decoder_window=cfg.decoder_window), dev)
        self.enb_rx = EnbRx(self.ue_tx)
        self.codec = self.ue_tx.codec
        self._expected = torch.as_tensor(self.grant_payload, device=dev)

    def wiener(self, snr_dl: float, snr_ul: float) -> tuple:
        """(the DL Wiener stack, the UL DMRS smoother) on the device."""
        n0_dl = float(np.float32(10.0 ** (-snr_dl / 10.0)))
        n0_ul = float(np.float32(10.0 ** (-snr_ul / 10.0)))
        return (wiener_stack_from_reference(
            make_wiener_stack(self.gm, n0_dl / 4.0), self.device),
            self.enb_rx.wiener(n0_ul))

    # ------------------------------------------------------------- step --
    def ue_decode_grant(self, rgrid, n0: float, wiener):
        """Blind DCI search on the DL control region -> grant_ok [B]. The
        plain equalize + demap with n0 / (|h|^2 + 1e-9), as the
        reference's."""
        dev = rgrid.device
        B = rgrid.shape[0]
        H = estimate_channel(rgrid, self.gm, wiener, time_avg=True)
        crm = self.crm
        sym = _long(crm.pdcch_sym, dev)
        y = rgrid[:, sym, _long(crm.pdcch_bin, dev)]
        h = H[:, sym, _long(crm.pdcch_sc, dev)]
        h2 = h.abs() ** 2
        yeq = y * torch.conj(h) / (h2 + n0)
        llr = demap_llr(yeq, n0 / (h2 + 1e-9), 2).reshape(B, -1)
        sgn = device_plan(self.enb_tx.pdcch_scr, dev, _signs)
        found, payload, _ = dci_blind_decode(
            llr * sgn, self.dci_len, self.cfg.rnti, self.candidates)
        match = torch.all(payload == self._expected, dim=-1)
        # flag bit 0 = "this is format 0": a 1A-flagged payload is not an
        # UL grant and must be ignored by the UE
        return found & match & (payload[:, 0] == 0)

    def trial(self, dl_noise, tb_bits, ul_noise, n0_dl, n0_ul,
              wiener) -> UlGrantResult:
        """[B] trials on injected draws: dl_noise [B, samples, 2] normals of
        the grant's subframe, tb_bits [B, TBS], ul_noise[r] [B, samples, 2]
        normals of round r's PUSCH; wiener the pair `wiener` gives."""
        cfg, dev = self.cfg, self.device
        n0_dl = float(np.float32(n0_dl))
        n0_ul = float(np.float32(n0_ul))
        w_dl, w_ul = wiener
        B = tb_bits.shape[0]
        tb_bits = tb_bits.to(dev)

        # ---- TTI n: DL control subframe over AWGN -----------------------
        rgrid = ofdm.ofdm_demodulate(
            self._t_dl + _noise(dl_noise, n0_dl, dev), self.fp)
        grant_ok = self.ue_decode_grant(rgrid, n0_dl, w_dl)

        # ---- TTI n+4..: granted PUSCH with HARQ rv cycling --------------
        mask = grant_ok.to(torch.complex64)[:, None]
        oks, w_soft = [], None
        for rnd in range(cfg.n_harq_rounds):
            rv = RV_SEQ[rnd % 4]
            t_ul = self.ue_tx.pusch_subframe(tb_bits, rv=rv) * mask
            llr, _ = self.enb_rx.pusch_llrs(
                t_ul + _noise(ul_noise[rnd], n0_ul, dev), n0_ul, w_ul)
            tb_hat, ok, w_soft = self.codec.decode(llr, w_soft=w_soft, rv=rv)
            oks.append(ok & grant_ok & torch.all(tb_hat == tb_bits, dim=-1))
        ok = torch.stack(oks)
        ok_any = torch.cummax(ok.to(torch.int32), dim=0).values.bool()
        fail = (~ok_any).sum(dim=1)
        reach = torch.cat([fail.new_full((1,), B), fail[:-1]])
        return UlGrantResult(grant_ok, ok, (~grant_ok).sum(), fail, reach)

    def draw(self, generator: torch.Generator):
        """One step's draws for `trial`, on the simulator's device."""
        dev, B = self.device, self.cfg.batch
        S = self.fp.samples_per_tti
        dl = torch.randn(B, S, 2, generator=generator, device=dev)
        tb = torch.randint(0, 2, (B, self.codec.cfg.tbs), generator=generator,
                           device=dev, dtype=torch.int32)
        ul = [torch.randn(B, S, 2, generator=generator, device=dev)
              for _ in range(self.cfg.n_harq_rounds)]
        return dl, tb, ul

    def step(self, generator: torch.Generator, n0_dl, n0_ul,
             wiener) -> UlGrantResult:
        return self.trial(*self.draw(generator), n0_dl, n0_ul, wiener)

    # ------------------------------------------------------------ sweep --
    def run_snr(self, snr_dl: float, snr_ul: float, n_frames: int,
                seed: int = 0):
        """(DCI errors, per-round errs [R], trials [R]) over
        ceil(n_frames / batch) steps."""
        n0_dl = np.float32(10.0 ** (-snr_dl / 10.0))
        n0_ul = np.float32(10.0 ** (-snr_ul / 10.0))
        W = self.wiener(snr_dl, snr_ul)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        R = self.cfg.n_harq_rounds
        dci_errs = 0
        errs = np.zeros(R, np.int64)
        reach = np.zeros(R, np.int64)
        for _ in range(-(-n_frames // self.cfg.batch)):
            res = self.step(gen, n0_dl, n0_ul, W)
            dci_errs += int(res.dci_errs)
            errs += res.errs.cpu().numpy()
            reach += res.reach.cpu().numpy()
        return dci_errs, errs, reach

    def sweep(self, snr_dl: float, snrs_ul, n_frames: int, seed: int = 0,
              verbose: bool = True):
        rows = []
        for s in snrs_ul:
            d, errs, reach = self.run_snr(snr_dl, float(s), n_frames, seed)
            bler = errs / np.maximum(reach, 1)
            rows.append(dict(snr_ul=float(s), dci_errs=d, errs=errs.copy(),
                             reached=reach.copy(), bler=bler.copy()))
            if verbose:
                txt = " ".join(f"r{r}:{bler[r]:.3f}({errs[r]}/{reach[r]})"
                               for r in range(len(bler)))
                print(f"UL SNR {s:+6.2f} dB: dci_err {d}  {txt}", flush=True)
            if errs[-1] == 0:
                break
        return rows
